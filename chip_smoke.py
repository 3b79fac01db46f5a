#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cfd2_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card's name and power limit; build every CUDA kernel from
   ``cfd2_tpu_torch/csrc`` (one ``nvcc`` per source, all started together)
   and the native mesh library (``make -C native``), without which the
   unstructured meshes of phases 6-7 cannot be generated in minutes;
2. hold each kernel against its plain PyTorch version on the card (max-abs
   error <= 1e-5 on O(1) random data): the two RB-GS kernels on small grids
   and on every level grid of the 589x1765 multigrid hierarchy, timed at
   589x1765; the three banded kernels on square and rectangular index maps
   (K = 1, 3, 9, 17, every product form of the solver, a capped K = 9 map),
   compared and timed at M = 403,584, K = 3 beside their byte bounds, the
   dot also beside the library's sparse CSR product;
3. drive the main path: the 996,558-cell channel-obstacle mesh
   (min_cell=0.0017, 589x1765 grid), ``CoupledSolver`` with the structured
   multigrid (precond_type=1, fgmres_max_restarts=5), started from
   ``bench_developed_1m.npz``: 3 untimed healing steps, then 3 timed steps;
4. the half-sweep path (CFD2_PALLAS=1) on a ~30k-cell mesh for 2 steps;
5. one step of a ~5k-cell mesh on the card (kernels) and on the CPU (plain
   versions): equal outer iterations, u within 1e-4 * max|u|;
6. the unstructured main path: the 403,491-cell Delaunay channel-obstacle
   mesh (min_cell=0.003), aggregation AMG (precond_type=1), 3 steps from
   rest; before stepping, each banded kernel is held against its plain
   version on the solver's own maps (the mesh's and every coarse level's);
   all three banded kernels must be launched;
7. the slot-capped path: the 115,505-cell Voronoi mesh (min_cell=0.004,
   ``bd_k == 8``), its maps held the same way, 2 steps from rest;
8. one step of a ~5k-cell Delaunay mesh on the card and on the CPU: equal
   outer iterations, u within 1e-4 * max|u|.

Then the kernels' JSON line and the result line are printed.

``--phases 1,2`` runs only the listed phases (for bring-up); the result line
is printed only when every phase ran.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
MAIN_GRID = (589, 1765)
MAIN_CELLS = 996_558
DELAUNAY_MIN_CELL, DELAUNAY_CELLS = 0.003, 403_491
# Aggregates per coarse level of the Delaunay mesh's two-pass hierarchy.
DELAUNAY_LEVELS = (59_490, 5_227, 550, 112, 62)
VORONOI_MIN_CELL, VORONOI_CELLS = 0.004, 115_505
BANDED_SRC = "cfd2_tpu_torch/csrc/banded.cu"
BANDED_PALLAS = "cfd2_tpu/ops/banded_gather.py"
ALL_PHASES = {1, 2, 3, 4, 5, 6, 7, 8}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def level_grids(ny, nx, min_coarse=100):
    """The smoothed grids of the structured hierarchy (2x2 coarsening down
    to <= min_coarse cells, which get the dense solve)."""
    grids = []
    while ny * nx > min_coarse:
        grids.append((ny, nx))
        ny, nx = (ny + 1) // 2, (nx + 1) // 2
    return grids, (ny, nx)


def cuda_time_ms(fn, reps=50):
    """Mean device time of ``fn`` per call in ms, from CUDA events around
    each call.  Before every call a 1 GiB buffer is zeroed: that flushes the
    50 MB L2 cache (the solver finds its level-0 planes cold: FGMRES streams
    the basis between applications) and keeps the device busy for some
    hundred microseconds, so that the host has enqueued the start event, the
    call and the end event before the device reaches them.  Without that
    lead the interval between the events is the host's time to enqueue the
    call (30-75 us for these wrappers), not the kernel's."""
    import torch
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def host_us(fn, reps=300):
    """Host time to enqueue ``fn`` once, in microseconds (no synchronisation
    inside the loop; the kernels are small enough not to fill the queue)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def bound_ms(n_bytes, n_flops):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_flops / F32_FLOPS_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


# ----------------------------------------------------------------------


def phase_build():
    from cfd2_tpu_torch.ops import _build
    t0 = time.time()
    outs = _build.build_all(extra_flags=("-Xptxas", "-v"))
    for name, out in outs.items():
        log(f"# nvcc csrc/{name}.cu:\n{out.strip()}")
    for name in _build.SIGNATURES:
        _build.load(name)
    log(f"phase 1: built {sorted(_build.SIGNATURES)} in "
        f"{time.time() - t0:.1f} s")

    # The native mesh library: Poisson-disk sampling and the greedy
    # aggregation scan.  Their pure-Python fallbacks would not finish the
    # 400k-cell mesh in minutes, so a failed build fails here, at once.
    from cfd2_tpu_torch.mesh import native
    t0 = time.time()
    # Always rebuilt: the library is compiled for the machine it is built on.
    how = native.build(rebuild=True)   # raises with the compiler's output
    check(native.available(), "native/libmeshkern.so built but did not load")
    log(f"phase 1: native mesh library {how} in {time.time() - t0:.1f} s "
        "(sampler: native meshkern_poisson_disk; aggregation: native "
        "meshkern_amg_aggregate)")


def _grid_system(ny, nx, seed, device):
    import torch
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return (t(rng.uniform(1, 2, (ny, nx))),
            t(rng.standard_normal((4, ny, nx)) * 0.1),
            t(rng.standard_normal((ny, nx))),
            t(rng.standard_normal((ny, nx))))


# The product forms of banded_dot that the solver uses:
# name -> (operands, planes, prods).
DOT_FORMS = {
    "spmv": (3, 6, (((0, 0), (1, 2)), ((0, 1), (2, 2)),
                    ((3, 0), (4, 1), (5, 2)))),
    "mom2": (2, 1, (((0, 0),), ((0, 1),))),
    "schur_rhs": (2, 2, (((0, 0), (1, 1)),)),
    "grad": (1, 2, (((0, 0),), ((1, 0),))),
    "scalar": (1, 1, (((0, 0),),)),
}


def _band_map(M, n_src, K, seed, device, spread=640):
    """An (M, K) int32 index map with each row's sources sorted and within
    ``spread`` of the row's own position (the shape of a band-ordered
    mesh's neighbor map, or of an aggregate's member list)."""
    import torch
    rng = np.random.default_rng(seed)
    centre = (np.arange(M) * (n_src / M)).astype(np.int64)[:, None]
    idx = centre + rng.integers(-spread, spread + 1, (M, K))
    idx = np.sort(np.clip(idx, 0, n_src - 1), axis=1)
    return torch.as_tensor(idx.astype(np.int32), device=device)


def _rand(shape, seed, device, scale=1.0):
    import torch
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        (rng.standard_normal(shape) * scale).astype(np.float32),
        device=device)


def _maxerr(got, ref):
    return max(float((g - r).abs().max()) for g, r in zip(got, ref))


def _check_banded_errs(err_g, err_d, err_s):
    check(err_g == 0.0, f"banded_gather is not exact: {err_g:.3e}")
    check(err_d <= TOL, f"banded_dot disagrees with its plain version: "
          f"{err_d:.3e}")
    check(err_s <= TOL, f"banded_jacobi_sweeps disagrees with its plain "
          f"version: {err_s:.3e}")


def _dot_csr(offs, idx, prods, n_x, n_src):
    """The products of one banded_dot call as a sparse CSR matrix of
    (len(prods) * M, n_x * n_src): applied to the stacked operands it gives
    the stacked outputs."""
    import torch
    M, K = idx.shape
    row = torch.arange(M, device=idx.device)[:, None].expand(M, K)
    rows, cols, vals = [], [], []
    for j, pairs in enumerate(prods):
        for (oi, ci) in pairs:
            rows.append((row + j * M).reshape(-1))
            cols.append((idx.long() + ci * n_src).reshape(-1))
            vals.append(offs[oi].reshape(-1))
    A = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (len(prods) * M, n_x * n_src)).coalesce()
    return A.to_sparse_csr()


def phase_banded_kernels(results):
    """The three banded kernels against their plain versions on the card,
    then their times at the Delaunay main path's shape."""
    import torch
    from cfd2_tpu_torch.ops import banded_kernels as bk

    before = dict(bk.LAUNCHES)
    dev = "cuda"
    # (M, n_src, K): square maps, the K = 1 prolongation map, restriction
    # member lists (rectangular, wide), a polygonal-mesh K = 9 map.
    maps = [(5000, 5000, 1), (5000, 5000, 3), (4096, 4096, 9),
            (5000, 700, 1), (700, 5000, 17), (131, 131, 11)]
    err_g = err_d = err_s = 0.0
    n_cases = 0
    for mi, (M, n_src, K) in enumerate(maps):
        idx = _band_map(M, n_src, K, mi, dev, spread=min(640, n_src))
        for C in (None, 2, 6):
            x = _rand((n_src,) if C is None else (n_src, C), 10 + mi, dev)
            err_g = max(err_g, _maxerr([bk.banded_gather(x, idx)],
                                       [bk.banded_gather_ref(x, idx)]))
            n_cases += 1
        for fi, (n_x, n_off, prods) in enumerate(DOT_FORMS.values()):
            xs = [_rand((n_src,), 20 + c, dev) for c in range(n_x)]
            offs = [_rand((M, K), 30 + p, dev, 0.3) for p in range(n_off)]
            err_d = max(err_d, _maxerr(bk.banded_dot(xs, offs, idx, prods),
                                       bk.banded_dot_ref(xs, offs, idx,
                                                         prods)))
            n_cases += 1
        if M == n_src:
            rs = [_rand((M,), 40 + c, dev) for c in range(2)]
            dinv = 1.0 / (1.0 + _rand((M,), 50, dev).abs())
            off = _rand((M, K), 51, dev, 0.5 / K)
            for sweeps in (1, 3, 8):
                for cap in ((None, 8) if K > 8 else (None,)):
                    got = bk.banded_jacobi_sweeps(rs, dinv, off, idx, sweeps,
                                                  k_cap=cap)
                    ref = bk.banded_jacobi_sweeps_ref(rs, dinv, off, idx,
                                                      sweeps, k_cap=cap)
                    err_s = max(err_s, _maxerr(got, ref))
                    n_cases += 1
    torch.cuda.synchronize()
    log(f"phase 2: banded kernels, {n_cases} cases on {len(maps)} maps; "
        f"max-abs error gather {err_g:.3e}, dot {err_d:.3e}, sweeps "
        f"{err_s:.3e} (tolerance {TOL:g})")
    _check_banded_errs(err_g, err_d, err_s)

    # Times at the Delaunay main path's shape: N_dev = 403,584, K = 3.
    n = M = ((DELAUNAY_CELLS + 127) // 128) * 128
    K = 3
    idx = _band_map(M, n, K, 7, dev)
    idx_long = idx.long()
    B = 4
    # gather, C = 6: the packed (u, p, d_p, grad_p) gather of prepare.
    x6 = _rand((n, 6), 60, dev)
    err_g = max(err_g, _maxerr([bk.banded_gather(x6, idx)],
                               [bk.banded_gather_ref(x6, idx)]))
    g_ms = cuda_time_ms(lambda: bk.banded_gather(x6, idx))
    g_plain = cuda_time_ms(lambda: bk.banded_gather_ref(x6, idx))
    g_lib = cuda_time_ms(lambda: x6[idx_long])
    g_bound, g_by = bound_ms(B * (M * K + M * K * 6 + n * 6), 0)
    # dot, the coupled matvec: 6 planes, 3 operands, 3 outputs.
    n_x, n_off, prods = DOT_FORMS["spmv"]
    xs = [_rand((n,), 61 + c, dev) for c in range(n_x)]
    offs = [_rand((M, K), 64 + p, dev, 0.3) for p in range(n_off)]
    d_ref = bk.banded_dot_ref(xs, offs, idx, prods)
    err_d = max(err_d, _maxerr(bk.banded_dot(xs, offs, idx, prods), d_ref))
    d_ms = cuda_time_ms(lambda: bk.banded_dot(xs, offs, idx, prods))
    d_plain = cuda_time_ms(lambda: bk.banded_dot_ref(xs, offs, idx, prods))
    # The library's call for the same function: the products as one sparse
    # CSR matrix (3M x 3n for the matvec, M x n for the scalar form) applied
    # to the stacked operands.  Built once, outside the timed call; used
    # nowhere in the solver.
    A3, A1 = _dot_csr(offs, idx, prods, n_x, n), \
        _dot_csr(offs[:1], idx, DOT_FORMS["scalar"][2], 1, n)
    x3 = torch.cat(xs)
    err_lib = _maxerr([torch.mv(A3, x3)], [torch.cat(d_ref)])
    check(err_lib <= TOL, f"the sparse-matrix product disagrees with "
          f"banded_dot's plain version: {err_lib:.3e}")
    d_lib = cuda_time_ms(lambda: torch.mv(A3, x3))
    d1_lib = cuda_time_ms(lambda: torch.mv(A1, xs[0]))
    n_mul = sum(len(p) for p in prods)
    d_bound, d_by = bound_ms(
        B * (M * K + n_off * M * K + n_x * n + len(prods) * M),
        2 * n_mul * M * K)
    # the scalar form (every AMG level's operator) for comparison
    d1_ms = cuda_time_ms(lambda: bk.banded_dot(
        xs[:1], offs[:1], idx, DOT_FORMS["scalar"][2]))
    d1_bound, _ = bound_ms(B * (M * K + M * K + n + M), 2 * M * K)
    # sweeps: C = 2, 8 sweeps (the momentum predict).
    C, sweeps = 2, 8
    rs = [_rand((n,), 70 + c, dev) for c in range(C)]
    dinv = 1.0 / (1.0 + _rand((n,), 72, dev).abs())
    off = _rand((n, K), 73, dev, 0.1)
    err_s = max(err_s, _maxerr(
        bk.banded_jacobi_sweeps(rs, dinv, off, idx, sweeps),
        bk.banded_jacobi_sweeps_ref(rs, dinv, off, idx, sweeps)))
    s_ms = cuda_time_ms(lambda: bk.banded_jacobi_sweeps(rs, dinv, off, idx,
                                                        sweeps))
    s_plain = cuda_time_ms(lambda: bk.banded_jacobi_sweeps_ref(
        rs, dinv, off, idx, sweeps))
    # Nothing stays resident between sweeps: the seed pass moves (2C+1) n
    # values, each of the sweeps-1 sweep passes idx, off and (2C+1) n.
    s_bound, s_by = bound_ms(
        B * ((2 * C + 1) * n
             + (sweeps - 1) * (2 * n * K + (2 * C + 1) * n)),
        (sweeps - 1) * (2 * C * n * K + 2 * C * n) + C * n)
    # Host cost of one wrapper call (checks, output allocation, ctypes) at
    # a size where the kernels take a few microseconds.
    sm = _band_map(4096, 4096, K, 8, dev)
    sx = [_rand((4096,), 80 + c, dev) for c in range(3)]
    so = [_rand((4096, K), 83 + p, dev) for p in range(6)]
    h_g = host_us(lambda: bk.banded_gather(sx[0], sm))
    h_d1 = host_us(lambda: bk.banded_dot(sx[:1], so[:1], sm,
                                         DOT_FORMS["scalar"][2]))
    h_d = host_us(lambda: bk.banded_dot(sx, so, sm, prods))
    h_s = host_us(lambda: bk.banded_jacobi_sweeps(sx[:2], sx[2], so[0], sm,
                                                  8))
    h_add = host_us(lambda: sx[0] + sx[1])
    log(f"phase 2: host time per call: banded_gather {h_g:.1f} us, "
        f"banded_dot scalar {h_d1:.1f} us / matvec {h_d:.1f} us, "
        f"banded_jacobi_sweeps {h_s:.1f} us; one eager torch add "
        f"{h_add:.1f} us")
    bk.LAUNCHES.update(before)
    log(f"phase 2: at M={M}, K={K}: max-abs error gather {err_g:.3e}, dot "
        f"{err_d:.3e}, sweeps {err_s:.3e}; sparse-matrix product against "
        f"the plain dot {err_lib:.3e}")
    _check_banded_errs(err_g, err_d, err_s)
    rows = (("banded_gather", f"{BANDED_PALLAS}:378", err_g, g_ms, g_plain,
             g_bound, g_by, g_lib),
            ("banded_dot", f"{BANDED_PALLAS}:378", err_d, d_ms, d_plain,
             d_bound, d_by, d_lib),
            ("banded_jacobi_sweeps", f"{BANDED_PALLAS}:534", err_s, s_ms,
             s_plain, s_bound, s_by, None))
    for name, rep, err, ms, plain, bnd, by, lib in rows:
        results[name] = dict(
            name=name, route="cuda", source=BANDED_SRC, replaces=rep,
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bnd, bound_by=by, library_ms=lib)
    log(f"phase 2: banded_gather at M={M}, K={K}, C=6: {g_ms:.4f} ms, bound "
        f"{g_bound:.4f} ms ({g_by}), plain {g_plain:.4f} ms, indexing call "
        f"{g_lib:.4f} ms")
    log(f"phase 2: banded_dot (matvec: 6 planes, 3 operands, 3 outputs): "
        f"{d_ms:.4f} ms, bound {d_bound:.4f} ms ({d_by}), plain "
        f"{d_plain:.4f} ms, sparse CSR product {d_lib:.4f} ms; scalar form "
        f"{d1_ms:.4f} ms, bound {d1_bound:.4f} ms, sparse CSR product "
        f"{d1_lib:.4f} ms")
    log(f"phase 2: banded_jacobi_sweeps (C=2, 8 sweeps): {s_ms:.4f} ms, "
        f"bound {s_bound:.4f} ms ({s_by}), plain {s_plain:.4f} ms")


def phase_kernels(results):
    """Each kernel against its plain version on the card; times at the
    main paths' finest shapes."""
    import torch
    from cfd2_tpu_torch.ops import stencil_kernels as sk

    grids, _ = level_grids(*MAIN_GRID)
    cases = [(37, 53), (16, 24), (300, 128)] + grids
    err_leg = err_half = 0.0
    before = dict(sk.LAUNCHES)
    for ci, (ny, nx) in enumerate(cases):
        diag2, off2, x, b = _grid_system(ny, nx, ci, "cuda")
        for sweeps in (1, 2):
            for residual in (True, False):
                got = sk.rbgs_leg(x, diag2, off2, b, sweeps, residual)
                ref = sk.rbgs_leg_ref(x, diag2, off2, b, sweeps, residual)
                got = got if residual else (got,)
                ref = ref if residual else (ref,)
                for g, r in zip(got, ref):
                    err_leg = max(err_leg, float((g - r).abs().max()))
        off_flat = off2.reshape(4, -1).T.contiguous()
        for parity in (0, 1):
            args = (x.reshape(-1), diag2.reshape(-1), off_flat,
                    b.reshape(-1), parity, (ny, nx))
            got = sk.rbgs_half_sweep(*args)
            ref = sk.rbgs_half_sweep_ref(*args)
            err_half = max(err_half, float((got - ref).abs().max()))
    torch.cuda.synchronize()
    log(f"phase 2: {len(cases)} grids; max-abs error leg {err_leg:.3e}, "
        f"half-sweep {err_half:.3e} (tolerance {TOL:g})")
    check(err_leg <= TOL, f"rbgs_leg disagrees with its plain version: "
          f"{err_leg:.3e}")
    check(err_half <= TOL, f"rbgs_half_sweep disagrees with its plain "
          f"version: {err_half:.3e}")

    ny, nx = MAIN_GRID
    n = ny * nx
    diag2, off2, x, b = _grid_system(ny, nx, 99, "cuda")
    leg_ms = cuda_time_ms(lambda: sk.rbgs_leg(x, diag2, off2, b, 1, True))
    leg_plain = cuda_time_ms(
        lambda: sk.rbgs_leg_ref(x, diag2, off2, b, 1, True))
    # Down leg at sweeps=1: reads x, diag, 4 off planes, b; writes x, r.
    # Flops per cell: 2 half-sweeps x 9 on half the cells + 1 reciprocal +
    # 10 for the residual.
    leg_bound, leg_by = bound_ms(9 * 4 * n, 20 * n)
    off_flat = off2.reshape(4, -1).T.contiguous()
    hargs = (x.reshape(-1), diag2.reshape(-1), off_flat, b.reshape(-1), 0,
             (ny, nx))
    half_ms = cuda_time_ms(lambda: sk.rbgs_half_sweep(*hargs))
    half_plain = cuda_time_ms(lambda: sk.rbgs_half_sweep_ref(*hargs))
    # Reads x, diag, off (n, 4), b; writes x.  Half the cells do 10 flops.
    half_bound, half_by = bound_ms(8 * 4 * n, 5 * n)
    # Launches made for these comparisons are not the main path's.
    sk.LAUNCHES.update(before)
    results["rbgs_leg"] = dict(
        name="rbgs_leg", route="cuda", source="cfd2_tpu_torch/csrc/rbgs.cu",
        replaces="cfd2_tpu/ops/pallas_stencil.py:264", launches=0,
        max_abs_err=err_leg, ms=leg_ms, plain_ms=leg_plain,
        bound_ms=leg_bound, bound_by=leg_by, library_ms=None)
    results["rbgs_half_sweep"] = dict(
        name="rbgs_half_sweep", route="cuda",
        source="cfd2_tpu_torch/csrc/rbgs.cu",
        replaces="cfd2_tpu/ops/pallas_stencil.py:97", launches=0,
        max_abs_err=err_half, ms=half_ms, plain_ms=half_plain,
        bound_ms=half_bound, bound_by=half_by, library_ms=None)
    log(f"phase 2: rbgs_leg at {ny}x{nx} (sweeps=1, residual): "
        f"{leg_ms:.4f} ms, bound {leg_bound:.4f} ms ({leg_by}), plain "
        f"{leg_plain:.4f} ms")
    log(f"phase 2: rbgs_half_sweep at {ny}x{nx}: {half_ms:.4f} ms, bound "
        f"{half_bound:.4f} ms ({half_by}), plain {half_plain:.4f} ms")
    phase_banded_kernels(results)


def _channel(min_cell):
    from cfd2_tpu_torch import ChannelWithObstacle, generate_cut_cell_mesh
    geo = ChannelWithObstacle(length=3.0, height=1.0,
                              obstacle_center=(1.0, 0.5),
                              obstacle_radius=0.2)
    return generate_cut_cell_mesh(geo, min_cell, min_cell, 1.2, (3.0, 1.0))


def _solver(mesh, min_cell, device, **config):
    """CoupledSolver set up as bench.py sets it up, started from rest."""
    from dataclasses import replace
    from cfd2_tpu_torch import CoupledSolver
    s = CoupledSolver(mesh, device=device)
    s.set_dt(min(0.002, 0.4 * min_cell))
    s.set_viscosity(0.01)
    s.set_density(1.0)
    s.set_precond_type(1)
    s.config = replace(s.config, fgmres_max_restarts=5, **config)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < min_cell * 2, 0] = 1.0
    s.set_u(u0)
    return s


def _finite(s):
    import torch
    return bool(torch.isfinite(s.state.u).all()) and \
        bool(torch.isfinite(s.state.p).all())


def phase_main(results):
    import torch
    from cfd2_tpu_torch.convert import load_developed_state
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    from cfd2_tpu_torch.runtime import host_reads

    t0 = time.time()
    mesh = _channel(0.0017)
    log(f"phase 3: mesh {mesh.num_cells} cells in {time.time() - t0:.1f} s")
    check(mesh.num_cells == MAIN_CELLS, f"mesh has {mesh.num_cells} cells")
    t0 = time.time()
    s = _solver(mesh, 0.0017, None)
    check(tuple(s.mesh.grid_shape) == MAIN_GRID,
          f"grid {s.mesh.grid_shape} != {MAIN_GRID}")
    amg = s._get_amg()
    grids, coarsest = level_grids(*MAIN_GRID)
    check(len(amg.levels) == len(grids)
          and tuple(amg.levels[-1].grid) == coarsest,
          "hierarchy does not match the expected level grids")
    meta = load_developed_state(s, ROOT / "bench_developed_1m.npz")
    torch.cuda.synchronize()
    log(f"phase 3: solver set-up {time.time() - t0:.1f} s; "
        f"{len(grids)} smoothed levels, coarsest {coarsest}; "
        f"viscosity {meta['viscosity']}")

    n = mesh.num_cells
    sk.reset_launches()
    lin_total = 0
    for i in range(6):
        host_reads.reset()
        before = dict(sk.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        st = s.state
        outer = int(st.outer_iters)
        lins = int(st.linear_iters_total)
        lin_total += lins
        step_launch = {k: v - before[k] for k, v in sk.LAUNCHES.items()}
        kind = "heal" if i < 3 else "timed"
        log(f"phase 3: {kind} step {i}: wall {wall:.4f} s, outer_iters "
            f"{outer}, linear_iters_total {lins}, cell-updates/s "
            f"{n / wall:.1f}, host reads {host_reads.COUNT['reads']}, "
            f"launches {step_launch}")
        check(_finite(s), f"non-finite fields after step {i}")
    leg = sk.LAUNCHES["rbgs_leg"]
    results["rbgs_leg"]["launches"] = leg
    check(leg > 0, "rbgs_leg was never launched on the main path")
    per_apply = 2 * len(grids)
    check(leg == per_apply * lin_total,
          f"rbgs_leg launches {leg} != {per_apply} per preconditioner "
          f"application x {lin_total} applications")
    log(f"phase 3: rbgs_leg launches {leg} = {per_apply} per V-cycle x "
        f"{lin_total} FGMRES iterations; rbgs_half_sweep "
        f"{sk.LAUNCHES['rbgs_half_sweep']}")


def phase_half_sweep(results):
    from cfd2_tpu_torch.ops import stencil_kernels as sk

    mesh = _channel(0.01)
    s = _solver(mesh, 0.01, None)
    old = os.environ.get("CFD2_PALLAS")
    os.environ["CFD2_PALLAS"] = "1"
    try:
        sk.reset_launches()
        for _ in range(2):
            s.step()
        counts = dict(sk.LAUNCHES)
    finally:
        if old is None:
            os.environ.pop("CFD2_PALLAS")
        else:
            os.environ["CFD2_PALLAS"] = old
    results["rbgs_half_sweep"]["launches"] = counts["rbgs_half_sweep"]
    log(f"phase 4: {mesh.num_cells} cells, 2 steps with CFD2_PALLAS=1: "
        f"outer_iters {int(s.state.outer_iters)}, launches {counts}")
    check(counts["rbgs_half_sweep"] > 0,
          "rbgs_half_sweep was never launched on the CFD2_PALLAS=1 path")
    check(counts["rbgs_leg"] == 0, "rbgs_leg ran on the CFD2_PALLAS=1 path")
    check(_finite(s), "non-finite fields on the half-sweep path")


def phase_cpu_match():
    mesh = _channel(0.025)
    runs = {}
    for dev in ("cuda", "cpu"):
        s = _solver(mesh, 0.025, dev)
        s.step()
        runs[dev] = (int(s.state.outer_iters), s.get_u())
    (o_gpu, u_gpu), (o_cpu, u_cpu) = runs["cuda"], runs["cpu"]
    scale = float(np.abs(u_cpu).max())
    err = float(np.abs(u_gpu - u_cpu).max())
    log(f"phase 5: {mesh.num_cells} cells, outer_iters card {o_gpu} / cpu "
        f"{o_cpu}, max|u_card - u_cpu| {err:.3e} (limit "
        f"{1e-4 * scale:.3e})")
    check(o_gpu == o_cpu, "outer iteration counts differ")
    check(np.isfinite(u_gpu).all() and err <= 1e-4 * scale,
          "card and CPU velocities disagree")


def _obstacle_geo():
    from cfd2_tpu_torch import ChannelWithObstacle
    return ChannelWithObstacle(length=3.0, height=1.0,
                               obstacle_center=(1.0, 0.5),
                               obstacle_radius=0.2)


def _unstructured_solver(mesh, min_cell, device):
    """CoupledSolver set up as bench_sweep.py sets up its from-rest
    unstructured cases: dt = min(0.002, 0.4 h), aggregation AMG, the inlet
    column at u = 1."""
    from cfd2_tpu_torch import CoupledSolver
    s = CoupledSolver(mesh, device=device)
    s.set_dt(min(0.002, 0.4 * min_cell))
    s.set_precond_type(1)
    u0 = np.zeros((mesh.num_cells, 2))
    u0[mesh.cell_cx < min_cell * 2, 0] = 1.0
    s.set_u(u0)
    return s


def _hold_on_solver_maps(phase, s, results):
    """Each banded wrapper against its plain version on the index maps this
    solver steps with, at their own shapes, with random data: the mesh's
    ``ck_neighbor`` (every gather width, every product form, the sweeps with
    the mesh's slot cap), and per coarse level its ELL map, the Galerkin
    grouping map, the restriction member lists and the K = 1 prolongation
    map.  Folds the errors into ``results``; the launches made here are
    taken off the counts again."""
    import torch
    from cfd2_tpu_torch.ops import banded_kernels as bk

    before = dict(bk.LAUNCHES)
    dm, hier = s.mesh, s._get_amg()
    dev = dm.ck_neighbor.device
    n, K = dm.ck_neighbor.shape
    err = {"banded_gather": 0.0, "banded_dot": 0.0,
           "banded_jacobi_sweeps": 0.0}
    shapes = []

    def hold(name, got, ref):
        err[name] = max(err[name], _maxerr(got, ref))

    def gather(x, idx):
        hold("banded_gather", [bk.banded_gather(x, idx)],
             [bk.banded_gather_ref(x, idx)])
        shapes.append(f"gather {tuple(idx.shape)}<-{tuple(x.shape)}")

    def dot(xs, offs, idx, prods):
        hold("banded_dot", bk.banded_dot(xs, offs, idx, prods),
             bk.banded_dot_ref(xs, offs, idx, prods))

    for C in (None, 2, 6):
        x = _rand((n,) if C is None else (n, C), 110, dev)
        hold("banded_gather", [dm.gather(x)],
             [bk.banded_gather_ref(x, dm.ck_neighbor)])
    shapes.append(f"gather ({n}, {K}) C=1,2,6")
    for n_x, n_off, prods in DOT_FORMS.values():
        xs = [_rand((n,), 120 + c, dev) for c in range(n_x)]
        offs = [_rand((n, K), 130 + p, dev, 0.3) for p in range(n_off)]
        hold("banded_dot", dm.banded_dot(xs, offs, prods),
             bk.banded_dot_ref(xs, offs, dm.ck_neighbor, prods))
    shapes.append(f"dot ({n}, {K}) x {len(DOT_FORMS)} forms")
    rs = [_rand((n,), 140 + c, dev) for c in range(2)]
    dinv = 1.0 / (1.0 + _rand((n,), 142, dev).abs())
    off = _rand((n, K), 143, dev, 0.5 / K)
    for sweeps in (1, 3, 8):
        hold("banded_jacobi_sweeps",
             dm.banded_jacobi_sweeps(rs, dinv, off, sweeps),
             bk.banded_jacobi_sweeps_ref(rs, dinv, off, dm.ck_neighbor,
                                         sweeps, k_cap=dm.bd_k))
    shapes.append(f"sweeps ({n}, {K}) k_cap={dm.bd_k}")

    n_fine, k_fine = n, K
    one = DOT_FORMS["scalar"][2]
    for li, lvl in enumerate(hier.levels):
        x_c = _rand((lvl.n,), 150 + li, dev)
        r_f = _rand((n_fine,), 160 + li, dev)
        dot((x_c,), (_rand((lvl.n, lvl.k), 170 + li, dev, 0.3),),
            lvl.ell_neighbor, one)
        dot((r_f,), (lvl.members_mask,), lvl.members, one)
        shapes.append(f"dot {tuple(lvl.ell_neighbor.shape)}, restriction "
                      f"{tuple(lvl.members.shape)}<-({n_fine},)")
        gather(x_c, lvl.agg)
        gather(_rand((n_fine * (k_fine + 1),), 180 + li, dev),
               lvl.rap_order)
        n_fine, k_fine = lvl.n, lvl.k
    torch.cuda.synchronize()
    bk.LAUNCHES.update(before)
    log(f"phase {phase}: kernels against plain versions on the solver's "
        f"maps: max-abs error gather {err['banded_gather']:.3e}, dot "
        f"{err['banded_dot']:.3e}, sweeps "
        f"{err['banded_jacobi_sweeps']:.3e} (tolerance {TOL:g}); "
        + "; ".join(shapes))
    _check_banded_errs(err["banded_gather"], err["banded_dot"],
                       err["banded_jacobi_sweeps"])
    for name, e in err.items():
        if name in results:
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], e)


def _drive_unstructured(phase, s, n_cells, n_steps):
    """Step ``s`` with the launch counts zeroed just before; returns the
    counts read just after and the FGMRES iterations taken."""
    import torch
    from cfd2_tpu_torch.ops import banded_kernels as bk
    from cfd2_tpu_torch.ops import stencil_kernels as sk
    from cfd2_tpu_torch.runtime import host_reads

    bk.reset_launches()
    sk.reset_launches()
    lin_total = 0
    for i in range(n_steps):
        host_reads.reset()
        before = dict(bk.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        outer = int(s.state.outer_iters)
        lins = int(s.state.linear_iters_total)
        lin_total += lins
        step_launch = {k: v - before[k] for k, v in bk.LAUNCHES.items()}
        log(f"phase {phase}: step {i}: wall {wall:.4f} s, outer_iters "
            f"{outer}, linear_iters_total {lins}, cell-updates/s "
            f"{n_cells / wall:.1f}, host reads {host_reads.COUNT['reads']}, "
            f"launches {step_launch}")
        check(_finite(s), f"non-finite fields after step {i}")
    counts = dict(bk.LAUNCHES)
    for name, cnt in counts.items():
        check(cnt > 0, f"{name} was never launched on this path")
    check(counts["banded_jacobi_sweeps"] == 2 * lin_total,
          f"banded_jacobi_sweeps calls {counts['banded_jacobi_sweeps']} != "
          f"2 per preconditioner application x {lin_total} FGMRES "
          "iterations")
    check(sum(sk.LAUNCHES.values()) == 0,
          "a structured-path kernel ran on an unstructured mesh")
    log(f"phase {phase}: {lin_total} FGMRES iterations; per iteration "
        f"{counts['banded_dot'] / lin_total:.2f} banded_dot, "
        f"{counts['banded_gather'] / lin_total:.2f} banded_gather, "
        f"{counts['banded_jacobi_sweeps'] / lin_total:.2f} "
        "banded_jacobi_sweeps calls")
    return counts


def phase_delaunay(results):
    import torch
    from cfd2_tpu_torch import generate_delaunay_mesh

    t0 = time.time()
    mesh = generate_delaunay_mesh(_obstacle_geo(), DELAUNAY_MIN_CELL,
                                  DELAUNAY_MIN_CELL, 1.2, (3.0, 1.0))
    log(f"phase 6: Delaunay mesh {mesh.num_cells} cells in "
        f"{time.time() - t0:.1f} s")
    check(mesh.num_cells == DELAUNAY_CELLS,
          f"mesh has {mesh.num_cells} cells, expected {DELAUNAY_CELLS}")
    t0 = time.time()
    s = _unstructured_solver(mesh, DELAUNAY_MIN_CELL, None)
    dm = s.mesh
    check(dm.banded and not dm.structured and dm.bd_k is None,
          f"layout: banded {dm.banded}, bd_k {dm.bd_k}")
    check(dm.banded_sweeps_fit(2), "the one-call sweeps rule must hold here")
    amg = s._get_amg()
    sizes = tuple(lvl.n for lvl in amg.levels)
    torch.cuda.synchronize()
    log(f"phase 6: N_dev {dm.num_cells}, K {dm.max_faces}; encode + "
        f"hierarchy {time.time() - t0:.1f} s; coarse levels {sizes}")
    check(sizes == DELAUNAY_LEVELS,
          f"hierarchy levels {sizes} != {DELAUNAY_LEVELS}")
    _hold_on_solver_maps(6, s, results)
    counts = _drive_unstructured(6, s, mesh.num_cells, 3)
    for name, cnt in counts.items():
        if name in results:
            results[name]["launches"] = cnt


def phase_voronoi(results):
    import torch
    from cfd2_tpu_torch import generate_voronoi_mesh

    t0 = time.time()
    mesh = generate_voronoi_mesh(_obstacle_geo(), VORONOI_MIN_CELL,
                                 VORONOI_MIN_CELL, 1.2, (3.0, 1.0))
    log(f"phase 7: Voronoi mesh {mesh.num_cells} cells in "
        f"{time.time() - t0:.1f} s")
    check(mesh.num_cells == VORONOI_CELLS,
          f"mesh has {mesh.num_cells} cells, expected {VORONOI_CELLS}")
    s = _unstructured_solver(mesh, VORONOI_MIN_CELL, None)
    dm = s.mesh
    torch.cuda.synchronize()
    log(f"phase 7: N_dev {dm.num_cells}, K {dm.max_faces}, bd_k {dm.bd_k}, "
        f"coarse levels {tuple(lvl.n for lvl in s._get_amg().levels)}")
    check(dm.banded and dm.bd_k == 8, f"expected the slot cap 8, got "
          f"banded {dm.banded}, bd_k {dm.bd_k}")
    _hold_on_solver_maps(7, s, results)
    _drive_unstructured(7, s, mesh.num_cells, 2)


def phase_delaunay_cpu_match():
    from cfd2_tpu_torch import generate_delaunay_mesh
    mesh = generate_delaunay_mesh(_obstacle_geo(), 0.025, 0.025, 1.2,
                                  (3.0, 1.0))
    runs = {}
    for dev in ("cuda", "cpu"):
        s = _unstructured_solver(mesh, 0.025, dev)
        s.step()
        runs[dev] = (int(s.state.outer_iters),
                     int(s.state.linear_iters_total), s.get_u())
    (o_gpu, l_gpu, u_gpu), (o_cpu, l_cpu, u_cpu) = runs["cuda"], runs["cpu"]
    scale = float(np.abs(u_cpu).max())
    err = float(np.abs(u_gpu - u_cpu).max())
    log(f"phase 8: {mesh.num_cells} Delaunay cells, outer_iters card {o_gpu} "
        f"/ cpu {o_cpu}, linear iterations {l_gpu} / {l_cpu}, "
        f"max|u_card - u_cpu| {err:.3e} (limit {1e-4 * scale:.3e})")
    check(o_gpu == o_cpu, "outer iteration counts differ")
    check(np.isfinite(u_gpu).all() and err <= 1e-4 * scale,
          "card and CPU velocities disagree")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 basis dots

    log(card_line())
    results = {}
    t_all = time.time()
    steps = [(1, phase_build), (2, lambda: phase_kernels(results)),
             (3, lambda: phase_main(results)),
             (4, lambda: phase_half_sweep(results)),
             (5, phase_cpu_match),
             (6, lambda: phase_delaunay(results)),
             (7, lambda: phase_voronoi(results)),
             (8, phase_delaunay_cpu_match)]
    for num, fn in steps:
        if num in phases:
            t0 = time.time()
            fn()
            log(f"# phase {num} done in {time.time() - t0:.1f} s")
    log(f"# all phases in {time.time() - t_all:.1f} s")
    if results:
        print(json.dumps({"kernels": list(results.values())}), flush=True)
    if phases != ALL_PHASES:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

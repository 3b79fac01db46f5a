"""Neighbour access of the unstructured path: the hand-written CUDA kernels
(``csrc/banded.cu``), their wrappers, and the plain PyTorch version of each.

Counterparts of ``cfd2_tpu/ops/banded_gather.py``:

* :func:`banded_gather` <- ``banded_gather_nk`` / ``banded_gather2_nk``:
  ``out[i, k, ...] = x[idx[i, k], ...]``;
* :func:`banded_dot` <- ``banded_dot``: ``out_j[i] = sum over (oi, ci) in
  prods[j] of sum_k offs[oi][i, k] * xs[ci][idx[i, k]]`` without the (M, K)
  gathered values ever reaching device memory;
* :func:`banded_jacobi_sweeps` <- ``banded_jacobi_sweeps``: ``sweeps`` Jacobi
  iterations ``z = dinv * (r - A_off z)`` from the seed ``dinv * r`` for
  several right-hand sides that share the operator.

All three take the (M, K) int32 index map itself (square: the mesh's
``ck_neighbor`` or a coarse level's ``ell_neighbor``; rectangular: the
restriction member lists, or the (n_fine, 1) aggregate map for prolongation).
The JAX package's lane/sel/base planes, window walks and pre-blocked
coefficient layout are the TPU's way to gather along lanes and have no
counterpart here.

Each wrapper runs its plain version (``*_ref``) for tensors on the CPU, and
launches its kernel for CUDA tensors; anything else raises.  There is no
fallback from a CUDA tensor to the plain version.  ``LAUNCHES`` counts the
kernel calls per wrapper; :func:`reset_launches` zeroes it.  One call of
:func:`banded_jacobi_sweeps` counts once although it enqueues ``sweeps``
kernels on the stream (see the source note in ``csrc/banded.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Kernel calls per wrapper since the last reset_launches().
LAUNCHES = {"banded_gather": 0, "banded_dot": 0, "banded_jacobi_sweeps": 0}

# Limits of csrc/banded.cu.
MAX_X, MAX_OFF, MAX_OUT, MAX_PAIRS, MAX_RHS = 3, 6, 3, 8, 4


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------
# Plain versions.


def banded_gather_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`banded_gather`."""
    return x[idx.long()]


def banded_dot_ref(xs, offs, idx, prods):
    """Plain version of :func:`banded_dot`: per output, the products are
    summed per slot first and over the slots last, as the kernel does."""
    idx = idx.long()
    gs = [x[idx] for x in xs]
    out = []
    for pairs in prods:
        acc = None
        for (oi, ci) in pairs:
            t = offs[oi] * gs[ci]
            acc = t if acc is None else acc + t
        out.append(acc.sum(dim=1))
    return tuple(out)


def banded_jacobi_sweeps_ref(rs, dinv, off, idx, sweeps: int, k_cap=None):
    """Plain version of :func:`banded_jacobi_sweeps`: the loop of
    ``ellsys._momentum_solve`` over the first ``k_cap`` slots."""
    if k_cap is not None:
        off, idx = off[:, :k_cap], idx[:, :k_cap]
    idx = idx.long()
    zs = [dinv * r for r in rs]
    for _ in range(sweeps - 1):
        zs = [dinv * (r - (off * z[idx]).sum(dim=1)) for r, z in zip(rs, zs)]
    return tuple(zs)


# ----------------------------------------------------------------------
# Wrappers.


def _check(name, t, shape, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_idx(idx, device):
    if idx.dim() != 2:
        raise ValueError(f"idx has shape {tuple(idx.shape)}, expected (M, K)")
    _check("idx", idx, None, device, torch.int32)


def _raise_on(lib, err: int, fn: str) -> None:
    if err != 0:
        msg = lib.banded_error_string(err).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} ({msg})")


def _cuda_or_cpu(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no banded-gather implementation for device {t.device}")


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def banded_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbour values per slot: ``x`` (n_src,) or (n_src, C) float32,
    ``idx`` (M, K) int32 with values in [0, n_src) -> (M, K) or (M, K, C).
    The C components of one neighbour share the index load."""
    if not _cuda_or_cpu(x):
        return banded_gather_ref(x, idx)
    dev = x.device
    if x.dim() not in (1, 2):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected (n_src,) "
                         "or (n_src, C)")
    _check("x", x, None, dev)
    _check_idx(idx, dev)
    M, K = idx.shape
    C = 1 if x.dim() == 1 else x.shape[1]
    out = torch.empty((M, K) + tuple(x.shape[1:]), dtype=torch.float32,
                      device=dev)
    lib = _build.load("banded")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.banded_gather(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                M, K, C, stream)
    _raise_on(lib, err, "banded_gather")
    LAUNCHES["banded_gather"] += 1
    return out


def banded_dot(xs, offs, idx: torch.Tensor, prods):
    """Fused gather-dot: ``out_j[i] = sum over (oi, ci) in prods[j] of
    sum_k offs[oi][i, k] * xs[ci][idx[i, k]]``.

    ``xs``: up to 3 (n_src,) float32 operands; ``offs``: up to 6 (M, K)
    float32 coefficient planes; ``idx``: (M, K) int32; ``prods``: per output
    (up to 3) a tuple of (plane, operand) pairs.  Returns a tuple of (M,)
    tensors."""
    xs, offs = tuple(xs), tuple(offs)
    prods = tuple(tuple(p) for p in prods)
    if not _cuda_or_cpu(xs[0]):
        return banded_dot_ref(xs, offs, idx, prods)
    dev = xs[0].device
    _check_idx(idx, dev)
    M, K = idx.shape
    n_pairs = sum(len(p) for p in prods)
    if not (1 <= len(xs) <= MAX_X and 1 <= len(offs) <= MAX_OFF
            and 1 <= len(prods) <= MAX_OUT and n_pairs <= MAX_PAIRS):
        raise ValueError(
            f"banded_dot takes at most {MAX_X} operands, {MAX_OFF} planes, "
            f"{MAX_OUT} outputs and {MAX_PAIRS} products; got {len(xs)}, "
            f"{len(offs)}, {len(prods)}, {n_pairs}")
    n_src = xs[0].shape[0]
    for c, x in enumerate(xs):
        _check(f"xs[{c}]", x, (n_src,), dev)
    for p, o in enumerate(offs):
        _check(f"offs[{p}]", o, (M, K), dev)
    pair_off, pair_x, start = [], [], [0]
    for pairs in prods:
        for (oi, ci) in pairs:
            if not (0 <= oi < len(offs) and 0 <= ci < len(xs)):
                raise ValueError(f"product ({oi}, {ci}) names no plane or "
                                 "operand")
            pair_off.append(oi)
            pair_x.append(ci)
        start.append(len(pair_off))
    outs = [torch.empty((M,), dtype=torch.float32, device=dev) for _ in prods]
    lib = _build.load("banded")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.banded_dot(_ptrs(xs), len(xs), _ptrs(offs), len(offs),
                             _ptrs(outs), len(outs), _ints(pair_off),
                             _ints(pair_x), _ints(start), idx.data_ptr(),
                             M, K, stream)
    _raise_on(lib, err, "banded_dot")
    LAUNCHES["banded_dot"] += 1
    return tuple(outs)


def banded_jacobi_sweeps(rs, dinv, off, idx, sweeps: int, k_cap=None):
    """``sweeps`` Jacobi iterations ``z = dinv * (r - A_off z)`` from the
    seed ``z0 = dinv * r`` (so ``sweeps - 1`` applications of ``A_off``) for
    each right-hand side in ``rs``, in one call.

    ``rs``: up to 4 (n,) float32; ``dinv``: (n,); ``off``: (n, K) float32
    off-diagonal coefficients over ``idx`` (n, K) int32.  ``k_cap``: walk
    only the slots ``k < k_cap`` (the slot-capped smoother of the JAX
    package, which drops the rare occupied slots beyond the cap); None walks
    all K.  Returns a tuple of (n,) tensors."""
    rs = tuple(rs)
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    if not _cuda_or_cpu(rs[0]):
        return banded_jacobi_sweeps_ref(rs, dinv, off, idx, sweeps, k_cap)
    dev = rs[0].device
    _check_idx(idx, dev)
    n, K = idx.shape
    C = len(rs)
    if not 1 <= C <= MAX_RHS:
        raise ValueError(f"banded_jacobi_sweeps takes 1..{MAX_RHS} "
                         f"right-hand sides, got {C}")
    cap = K if k_cap is None else int(k_cap)
    if not 0 <= cap <= K:
        raise ValueError(f"k_cap {k_cap} is outside [0, {K}]")
    for c, r in enumerate(rs):
        _check(f"rs[{c}]", r, (n,), dev)
    _check("dinv", dinv, (n,), dev)
    _check("off", off, (n, K), dev)
    za = torch.empty((C, n), dtype=torch.float32, device=dev)
    zb = torch.empty((C, n), dtype=torch.float32, device=dev) \
        if sweeps > 1 else za
    lib = _build.load("banded")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.banded_jacobi_sweeps(_ptrs(rs), C, dinv.data_ptr(),
                                       off.data_ptr(), idx.data_ptr(),
                                       za.data_ptr(), zb.data_ptr(), n, K,
                                       cap, int(sweeps), stream)
    _raise_on(lib, err, "banded_jacobi_sweeps")
    LAUNCHES["banded_jacobi_sweeps"] += 1
    z = za if sweeps % 2 == 1 else zb
    return tuple(z[c] for c in range(C))

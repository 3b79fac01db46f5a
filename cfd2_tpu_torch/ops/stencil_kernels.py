"""The structured path's hand-written CUDA kernels, their wrappers, and the
plain PyTorch version of each: the red-black Gauss-Seidel smoothers of the
structured multigrid (``csrc/rbgs.cu``) and the coupled system's stencils
(``csrc/stencil.cu``).

Counterparts of ``cfd2_tpu/ops/pallas_stencil.py``:

* :func:`rbgs_leg` <- ``fused_rbgs2``: ``2*sweeps`` coloured half-sweeps of
  the 5-point stencil on an (ny, nx) grid, optionally followed by the
  residual ``b - A x``, in one launch (one V-cycle leg on one level).  Two
  fused forms take the V-cycle's grid transfers into the same launch: the
  down leg that returns the restricted residual (``restrict_to``) and the
  up leg that first adds the prolongated coarse correction
  (``add_prolong``);
* :func:`rbgs_half_sweep` <- ``rbgs_half_sweep``: one coloured half-sweep
  of an (ny, nx) grid with the (4, ny, nx) coefficient planes the levels keep
  (the TPU kernel's flat (n,) layout with ``off`` (n, 4) has no use on the
  card: it cost the V-cycle a transpose per smooth);
* :func:`rbgs_residual` (no Pallas kernel: the JAX package leaves it to
  XLA around its half-sweeps): ``restrict2(b - A x)``, the half-sweep
  path's down-leg residual and restriction in one launch.

The stencils of ``ops/stencil_system.py``, which the JAX package leaves to
XLA's fusions (no Pallas kernel), each one launch where the eager version
issues one per shift and per elementwise op:

* :func:`coupled_spmv` <- ``spmv_planar``: y = A x of the coupled (u, v, p)
  operator on (3, ny, nx) planes;
* :func:`momentum_jacobi` <- the Jacobi momentum predict of
  ``_momentum_solve`` on a (2, ny, nx) block (u, v);
* :func:`schur_rhs` <- ``_schur_rhs``: r_p - D z;
* :func:`pressure_gradient` <- ``_gradient``: G z_p.

Each is bit-equal to its plain version: the kernels round every product
and sum on its own, in the plain code's order.  On a row-sharded system
they take the neighbouring ranks' rows as explicit halo operands (``below``,
``above``: (..., 1, nx)); without them they clamp to the block's own edge
rows, as the unsharded shifts do.

Each wrapper runs its plain version (``*_ref``) for tensors on the CPU, and
launches its kernel for CUDA tensors; anything else raises.  There is no
fallback from a CUDA tensor to the plain version.  ``LAUNCHES`` counts the
kernel launches per wrapper; :func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from ._launch import float_ok, launch
from .banded_kernels import fma

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {"rbgs_leg": 0, "rbgs_half_sweep": 0, "rbgs_residual": 0,
            "coupled_spmv": 0,
            "momentum_jacobi": 0, "schur_rhs": 0, "pressure_gradient": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def smoother_level(device: torch.device) -> int:
    """Which smoother the structured V-cycle uses, from ``CFD2_PALLAS`` as
    in the JAX package's ``pallas_level()``: 2 = the fused leg kernel,
    1 = per-half-sweep kernels, 0 = the plain stencils.

    On CUDA an unset variable means 2, and 0 raises: the plain stencils
    never run on the card's main path.  On the CPU every level runs the
    plain versions (the wrappers pick them for CPU tensors); unset means 2
    there too."""
    raw = os.environ.get("CFD2_PALLAS", "") or "2"
    try:
        level = int(raw)
    except ValueError:
        raise ValueError(f"CFD2_PALLAS={raw!r} is not one of 0, 1, 2") from None
    if level not in (0, 1, 2):
        raise ValueError(f"CFD2_PALLAS={raw!r} is not one of 0, 1, 2")
    if level == 0 and device.type == "cuda":
        raise ValueError("CFD2_PALLAS=0 selects the plain stencils, which "
                         "do not run on CUDA; use 2 (leg kernel) or 1 "
                         "(half-sweep kernel)")
    return level


# ----------------------------------------------------------------------
# Plain versions.


def edge_shifts(x: torch.Tensor, below=None, above=None):
    """E, W, N, S neighbour planes of ``x`` (..., ny, nx), clamped to the
    edge at the grid's edges.  ``below`` / ``above`` (..., 1, nx): the rows
    beyond the block's first and last row (a row-sharded block's halo);
    None takes the block's own edge row."""
    below = x[..., :1, :] if below is None else below
    above = x[..., -1:, :] if above is None else above
    e = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    w = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    n = torch.cat([x[..., 1:, :], above], dim=-2)
    s = torch.cat([below, x[..., :-1, :]], dim=-2)
    return e, w, n, s


def dot4(off: torch.Tensor, sh) -> torch.Tensor:
    """sum_s off[s] * sh[s] over the 4 directional slots, in slot order."""
    return off[0] * sh[0] + off[1] * sh[1] + off[2] * sh[2] + off[3] * sh[3]


def smoother_sigma(off2: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """oE*xE + oW*xW + oN*xN + oS*xS of the smoother's 5-point stencil as
    fma(oS, xS, fma(oN, xN, fma(oE, xE, oW*xW))): the form XLA contracts
    the JAX package's ``_GridOps._sigma2`` into on the main path's grids,
    which the RB-GS kernels compute with explicit fused multiply-adds
    (``stencil_sigma`` in csrc/rbgs.cu).  The coupled system's stencils
    round every product apart (:func:`dot4`, pinned in csrc/stencil.cu)."""
    e, w, n, s = edge_shifts(xg)
    return fma(off2[3], s, fma(off2[2], n, fma(off2[0], e, off2[1] * w)))


def smoother_residual(diag2, off2, xg, bg) -> torch.Tensor:
    """b - (diag*x + sigma) with the multiply-add fused, as the leg
    kernel's residual and XLA's ``b - spmv2(x)`` of the JAX package round
    it."""
    return bg - fma(diag2, xg, smoother_sigma(off2, xg))


def _dinv(diag: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(diag) > 1e-30, 1.0 / diag, 0.0)


def _color2(ny: int, nx: int, device) -> torch.Tensor:
    j = torch.arange(ny, device=device)[:, None]
    i = torch.arange(nx, device=device)[None, :]
    return (j + i) % 2


def rbgs_leg_ref(xg, diag2, off2, bg, sweeps: int = 1,
                 residual: bool = False):
    """Plain version of :func:`rbgs_leg`: ``_GridOps.smooth_rbgs2``
    (cfd2_tpu/ops/amg.py:719-727) followed, with ``residual``, by
    ``b - spmv2(x)`` (amg.py:716), in the kernel's arithmetic (which is
    XLA's: :func:`smoother_sigma`)."""
    color = _color2(*xg.shape, xg.device)
    dinv = _dinv(diag2)
    for _ in range(sweeps):
        for c in (0, 1):
            xn = dinv * (bg - smoother_sigma(off2, xg))
            xg = torch.where(color == c, xn, xg)
    if residual:
        return xg, smoother_residual(diag2, off2, xg, bg)
    return xg


def restrict2(rg: torch.Tensor, coarse_grid) -> torch.Tensor:
    """2x2 block sums of an (ny, nx) grid, zero-padded to an even grid:
    ``_GridOps.restrict2`` (cfd2_tpu/ops/amg.py), added in the order XLA's
    ``reduce_window`` adds them, ((r00 + r10) + r01) + r11 (row, column
    within the block), which the leg kernel's restriction keeps too."""
    nyc, nxc = coarse_grid
    ny, nx = rg.shape
    rg = F.pad(rg, (0, 2 * nxc - nx, 0, 2 * nyc - ny))
    return (((rg[0::2, 0::2] + rg[1::2, 0::2]) + rg[0::2, 1::2])
            + rg[1::2, 1::2])


def prolong2(xcg: torch.Tensor, fine_grid) -> torch.Tensor:
    """Piecewise-constant 2x upsample cropped to ``fine_grid``:
    ``_GridOps.prolong2`` (cfd2_tpu/ops/amg.py)."""
    ny, nx = fine_grid
    full = xcg.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    return full[:ny, :nx]


def coarse_grid_of(grid) -> tuple[int, int]:
    ny, nx = grid
    return (ny + 1) // 2, (nx + 1) // 2


def rbgs_half_sweep_ref(xg, diag2, off2, bg, parity: int):
    """Plain version of :func:`rbgs_half_sweep`: one colour of
    ``_GridOps.smooth_rbgs`` (cfd2_tpu/ops/amg.py:639-646) — cells with
    ``(row + col + parity) % 2 == 0`` are relaxed, the rest copied."""
    xn = _dinv(diag2) * (bg - smoother_sigma(off2, xg))
    upd = (_color2(*xg.shape, xg.device) + parity) % 2 == 0
    return torch.where(upd, xn, xg)


def rbgs_residual_ref(xg, diag2, off2, bg, restrict_to):
    """Plain version of :func:`rbgs_residual`: :func:`smoother_residual`
    then :func:`restrict2`."""
    return restrict2(smoother_residual(diag2, off2, xg, bg), restrict_to)


# ----------------------------------------------------------------------
# Wrappers.


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _raise_on(error_string, err: int, fn: str) -> None:
    """Raise for a nonzero cudaError_t ``err`` of ``fn``'s launch, with the
    text that the library's ``error_string`` gives it."""
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} ({msg})")


def _cuda_or_cpu(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); raises for any other device."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no RB-GS implementation for device {t.device}")


# Modes of the C function (csrc/rbgs.cu).
_SMOOTH, _RESIDUAL, _RESTRICT, _PROLONG = 0, 1, 2, 3


def rbgs_leg(xg, diag2, off2, bg, sweeps: int = 1, residual: bool = False,
             restrict_to=None, add_prolong=None):
    """``2*sweeps`` red-black Gauss-Seidel half-sweeps (parity 0 then 1) of
    the 5-point stencil: one V-cycle leg in one launch.  ``xg``/``diag2``/
    ``bg`` (ny, nx) float32, ``off2`` (4, ny, nx) float32 slots [E, W, N, S].

    * plain: returns x; with ``residual`` returns ``(x, b - A x)``;
    * ``restrict_to=(nyc, nxc)`` (the down leg; the coarse grid, which must
      be ``((ny+1)//2, (nx+1)//2)``): returns ``(x, restrict2(b - A x))``
      without the residual ever reaching device memory;
    * ``add_prolong=x_coarse`` (the up leg): smooths
      ``x + prolong2(x_coarse)`` and returns x.

    The two fused forms take ``sweeps == 1`` and exclude each other and
    ``residual``."""
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    shape = xg.shape
    ny, nx = shape
    coarse = None
    if restrict_to is not None or add_prolong is not None:
        if sweeps != 1 or residual or (restrict_to is not None
                                       and add_prolong is not None):
            raise ValueError("restrict_to and add_prolong take sweeps == 1 "
                             "and exclude each other and residual")
        coarse = ((ny + 1) // 2, (nx + 1) // 2)
        given = restrict_to if add_prolong is None else add_prolong.shape
        if tuple(given) != coarse:
            raise ValueError(f"the coarse grid of {(ny, nx)} is {coarse}, "
                             f"got {tuple(given)}")
    if not _cuda_or_cpu(xg):
        if add_prolong is not None:
            xg = xg + prolong2(add_prolong, (ny, nx))
        if restrict_to is not None:
            x, r = rbgs_leg_ref(xg, diag2, off2, bg, sweeps, True)
            return x, restrict2(r, coarse)
        return rbgs_leg_ref(xg, diag2, off2, bg, sweeps, residual)
    dev = xg.device
    if not (float_ok(xg, shape, dev) and float_ok(diag2, shape, dev)
            and float_ok(off2, (4, ny, nx), dev) and float_ok(bg, shape, dev)
            and (add_prolong is None or float_ok(add_prolong, coarse, dev))):
        _check("x", xg, (ny, nx), dev)
        _check("diag", diag2, (ny, nx), dev)
        _check("off", off2, (4, ny, nx), dev)
        _check("b", bg, (ny, nx), dev)
        if add_prolong is not None:
            _check("add_prolong", add_prolong, coarse, dev)
    lib = _build.load("rbgs")
    xc_ptr = r_ptr = r_out = None
    mode = _SMOOTH
    x_out = torch.empty_like(xg)   # the cheapest allocation for the host
    if residual:
        mode = _RESIDUAL
        r_out = torch.empty_like(xg)
        r_ptr = r_out.data_ptr()
    elif restrict_to is not None:
        mode = _RESTRICT
        r_out = xg.new_empty(coarse)
        r_ptr = r_out.data_ptr()
    elif add_prolong is not None:
        mode = _PROLONG
        xc_ptr = add_prolong.data_ptr()
    err = launch(lib.rbgs_leg, dev, xg.data_ptr(), diag2.data_ptr(),
                 off2.data_ptr(), bg.data_ptr(), xc_ptr, x_out.data_ptr(),
                 r_ptr, ny, nx, sweeps, mode)
    if err:
        _raise_on(lib.rbgs_error_string, err, "rbgs_leg")
    LAUNCHES["rbgs_leg"] += 1
    return x_out if r_out is None else (x_out, r_out)


def rbgs_half_sweep(xg, diag2, off2, bg, parity: int,
                    in_place: bool = False):
    """One coloured half-sweep: relax the cells with
    ``(row + col + parity) % 2 == 0`` and copy the others.  ``xg``/``diag2``/
    ``bg`` (ny, nx) float32, ``off2`` (4, ny, nx) float32 slots [E, W, N, S].
    Returns the new x: a new tensor, or with ``in_place`` ``xg`` itself,
    updated (only for a tensor that no one else reads: the caller's own
    output of an earlier half-sweep)."""
    if not _cuda_or_cpu(xg):
        x = rbgs_half_sweep_ref(xg, diag2, off2, bg, parity)
        return xg.copy_(x) if in_place else x
    shape = xg.shape
    ny, nx = shape
    dev = xg.device
    if not (float_ok(xg, shape, dev) and float_ok(diag2, shape, dev)
            and float_ok(off2, (4, ny, nx), dev) and float_ok(bg, shape, dev)):
        _check("x", xg, (ny, nx), dev)
        _check("diag", diag2, (ny, nx), dev)
        _check("off", off2, (4, ny, nx), dev)
        _check("b", bg, (ny, nx), dev)
    lib = _build.load("rbgs")
    x_out = xg if in_place else torch.empty_like(xg)
    err = launch(lib.rbgs_half_sweep, dev, xg.data_ptr(), diag2.data_ptr(),
                 off2.data_ptr(), bg.data_ptr(), x_out.data_ptr(), ny, nx,
                 int(parity) & 1)
    if err:
        _raise_on(lib.rbgs_error_string, err, "rbgs_half_sweep")
    LAUNCHES["rbgs_half_sweep"] += 1
    return x_out


def rbgs_residual(xg, diag2, off2, bg, restrict_to):
    """The 2x2 block sums of the residual ``b - A x`` on the coarse grid
    ``restrict_to`` (``restrict2``'s: ``((ny+1)//2, (nx+1)//2)`` pads an odd
    grid with zeros, a smaller one crops it), in one launch: the down leg's
    residual and restriction after :func:`rbgs_half_sweep`'s smoothing.
    ``xg``/``diag2``/``bg`` (ny, nx) float32, ``off2`` (4, ny, nx) float32
    slots [E, W, N, S]."""
    if not _cuda_or_cpu(xg):
        return rbgs_residual_ref(xg, diag2, off2, bg, restrict_to)
    shape = xg.shape
    ny, nx = shape
    nyc, nxc = (int(v) for v in restrict_to)
    if not (0 < nyc <= (ny + 1) // 2 and 0 < nxc <= (nx + 1) // 2):
        raise ValueError(f"restrict_to {tuple(restrict_to)} is not a coarse "
                         f"grid of {(ny, nx)}")
    dev = xg.device
    if not (float_ok(xg, shape, dev) and float_ok(diag2, shape, dev)
            and float_ok(off2, (4, ny, nx), dev) and float_ok(bg, shape, dev)):
        _check("x", xg, (ny, nx), dev)
        _check("diag", diag2, (ny, nx), dev)
        _check("off", off2, (4, ny, nx), dev)
        _check("b", bg, (ny, nx), dev)
    lib = _build.load("rbgs")
    r_out = xg.new_empty((nyc, nxc))
    err = launch(lib.rbgs_residual, dev, xg.data_ptr(), diag2.data_ptr(),
                 off2.data_ptr(), bg.data_ptr(), r_out.data_ptr(), ny, nx,
                 nyc, nxc)
    if err:
        _raise_on(lib.rbgs_error_string, err, "rbgs_residual")
    LAUNCHES["rbgs_residual"] += 1
    return r_out


def smooth_rbgs_half_sweeps(diag2, off2, xg, bg, sweeps: int = 1):
    """``sweeps`` red-black sweeps as pairs of :func:`rbgs_half_sweep`
    (counterpart of ``smooth_rbgs_pallas``): the first half-sweep writes a
    new tensor, the later ones update it in place."""
    for k in range(2 * sweeps):
        xg = rbgs_half_sweep(xg, diag2, off2, bg, k % 2, in_place=k > 0)
    return xg


# ----------------------------------------------------------------------
# The coupled system's stencils (csrc/stencil.cu): plain versions.


def plane_shifts(sh, i: int):
    """Plane ``i``'s four shifts out of the shifts of a stack of planes."""
    return tuple(t[i] for t in sh)


def coupled_spmv_ref(x, offs, diags, below=None, above=None):
    """Plain version of :func:`coupled_spmv` (the port's ``spmv_planar``,
    cfd2_tpu/ops/stencil_system.py:196)."""
    off_mom, off_up, off_vp, off_pu, off_pv, off_pp = offs
    d_u, d_up, d_vp, d_pu, d_pv, d_pp = diags
    xu, xv, xp = x[0], x[1], x[2]
    sh = edge_shifts(x, below, above)
    su, sv, sp = (plane_shifts(sh, i) for i in range(3))
    yu = d_u * xu + d_up * xp + dot4(off_mom, su) + dot4(off_up, sp)
    yv = d_u * xv + d_vp * xp + dot4(off_mom, sv) + dot4(off_vp, sp)
    yp = d_pu * xu + d_pv * xv + d_pp * xp \
        + dot4(off_pu, su) + dot4(off_pv, sv) + dot4(off_pp, sp)
    return torch.stack([yu, yv, yp])


def momentum_jacobi_ref(r, dinv, off, sweeps: int, halo=None):
    """Plain version of :func:`momentum_jacobi` (the Jacobi branch of the
    port's ``_momentum_solve``, cfd2_tpu/ops/stencil_system.py:213, on both
    components at once: every op is elementwise, so the bits are the
    per-component ones)."""
    z = dinv * r
    for _ in range(sweeps - 1):
        below, above = (None, None) if halo is None else halo(z)
        z = dinv * (r - dot4(off, edge_shifts(z, below, above)))
    return z


def schur_rhs_ref(rp, z, d_pu, d_pv, off_pu, off_pv, below=None,
                  above=None):
    """Plain version of :func:`schur_rhs` (the port's ``_schur_rhs``;
    cfd2_tpu/ops/stencil_system.py:337-338)."""
    sh = edge_shifts(z, below, above)
    su, sv = plane_shifts(sh, 0), plane_shifts(sh, 1)
    return rp - d_pu * z[0] - d_pv * z[1] - dot4(off_pu, su) - dot4(off_pv, sv)


def pressure_gradient_ref(zp, d_up, d_vp, off_up, off_vp, below=None,
                          above=None):
    """Plain version of :func:`pressure_gradient` (the port's ``_gradient``;
    cfd2_tpu/ops/stencil_system.py:345-347)."""
    sp = edge_shifts(zp, below, above)
    return torch.stack([d_up * zp + dot4(off_up, sp),
                        d_vp * zp + dot4(off_vp, sp)])


# ----------------------------------------------------------------------
# The coupled system's stencils: wrappers.


def _check_all(dev, named):
    """Check the ``(name, tensor, shape)`` operands of one launch: float32,
    contiguous, on ``dev``, of that shape.  One pass of ``float_ok``;
    ``_check`` names the fault only when it fails."""
    if all(float_ok(t, shape, dev) for _, t, shape in named):
        return
    for name, t, shape in named:
        _check(name, t, shape, dev)


def _halo_pair(below, above):
    if (below is None) != (above is None):
        raise ValueError("below and above are given together or not at all")
    return below is not None


def _ptr(t):
    return None if t is None else t.data_ptr()


def coupled_spmv(x, offs, diags, below=None, above=None):
    """y = A x of the coupled (u, v, p) system in stencil form.  ``x``
    (3, ny, nx) float32 component planes; ``offs`` the six (4, ny, nx)
    off-diagonal blocks (off_mom, off_up, off_vp, off_pu, off_pv, off_pp),
    slots [E, W, N, S]; ``diags`` the six (ny, nx) diagonals (diag_u,
    diag_up, diag_vp, diag_pu, diag_pv, diag_pp); ``below`` / ``above``
    (3, 1, nx): the halo rows of a row-sharded block, or None.  Returns y
    (3, ny, nx)."""
    if not _cuda_or_cpu(x):
        return coupled_spmv_ref(x, offs, diags, below, above)
    if len(offs) != 6 or len(diags) != 6:
        raise ValueError("coupled_spmv takes 6 off-diagonal blocks and 6 "
                         "diagonals")
    ny, nx = x.shape[-2:]
    dev = x.device
    named = [("x", x, (3, ny, nx))] \
        + [(f"offs[{i}]", o, (4, ny, nx)) for i, o in enumerate(offs)] \
        + [(f"diags[{i}]", d, (ny, nx)) for i, d in enumerate(diags)]
    if _halo_pair(below, above):
        named += [("below", below, (3, 1, nx)), ("above", above, (3, 1, nx))]
    _check_all(dev, named)
    lib = _stencil_lib()
    y = torch.empty_like(x)
    err = launch(lib.coupled_spmv, dev, x.data_ptr(),
                 *(o.data_ptr() for o in offs),
                 *(d.data_ptr() for d in diags), _ptr(below), _ptr(above),
                 y.data_ptr(), ny, nx)
    if err:
        _raise_on(lib.stencil_error_string, err, "coupled_spmv")
    LAUNCHES["coupled_spmv"] += 1
    return y


# The most sweeps one launch runs: the solver's 8, and 12 from 1.5M cells
# (SolverConfig.mom_sweeps); and the threads of its blocks, one column of
# a band each.  csrc/stencil.cu's constants of the same names; _stencil_lib
# refuses a library that holds others.
TILE_MAX_SWEEPS = 12
MOM_THREADS = 128
_constants_checked = False
# (device index, ny, nx, sweeps) -> the streamed predict's plan there.
_MOM_PLANS: dict = {}


def _stencil_lib():
    """The built csrc/stencil.cu, its constants checked against
    ``TILE_MAX_SWEEPS`` and ``MOM_THREADS`` on first use."""
    global _constants_checked
    lib = _build.load("stencil")
    if not _constants_checked:
        limit, threads = lib.stencil_tile_max_sweeps(), lib.stencil_mom_threads()
        if (limit, threads) != (TILE_MAX_SWEEPS, MOM_THREADS):
            raise RuntimeError(
                f"csrc/stencil.cu runs up to {limit} sweeps in one launch "
                f"on blocks of {threads} threads; stencil_kernels says "
                f"{TILE_MAX_SWEEPS} and {MOM_THREADS}")
        _constants_checked = True
    return lib


def momentum_launches(sweeps: int, sharded: bool) -> int:
    """Kernel launches of one :func:`momentum_jacobi` call: one on an
    unsharded grid up to ``TILE_MAX_SWEEPS`` sweeps (the seed alone, or
    the streamed bands running every sweep); else one for the seed and one
    per sweep (``sweeps``), as on a row-sharded grid, where every sweep
    waits for the neighbours' rows of the previous iterate."""
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    return 1 if not sharded and sweeps <= TILE_MAX_SWEEPS else sweeps


class MomentumPlan(NamedTuple):
    """One launch of the streamed predict: ``bands`` column bands of
    ``band_cols`` output columns (``MOM_THREADS`` less a halo of
    ``sweeps - 1`` columns on either side) by ``row_blocks`` blocks of
    ``tile_rows`` output rows; ``cells_per_output``: the cells a sweep
    updates per output cell, halos included (the recomputed share)."""
    bands: int
    band_cols: int
    row_blocks: int
    tile_rows: int
    cells_per_output: float


def momentum_plan(ny: int, nx: int, sweeps: int, n_sm: int,
                  blocks_per_sm: int = 1) -> MomentumPlan:
    """The streamed predict's grid on a card of ``n_sm`` SMs that holds
    ``blocks_per_sm`` of its blocks at once: the bands cover the columns,
    and the rows are cut into as many blocks as fill those slots, so that
    the whole launch is one wave.  Fewer, taller blocks would recompute
    fewer halo rows but leave slots idle; the more blocks an SM holds, the
    more of each one's waits (its chain of levels, its barrier) the others
    fill."""
    if not 2 <= sweeps <= TILE_MAX_SWEEPS:
        raise ValueError(f"the streamed predict runs 2..{TILE_MAX_SWEEPS} "
                         f"sweeps, not {sweeps}")
    if n_sm < 1 or blocks_per_sm < 1:
        raise ValueError(f"{n_sm} SMs holding {blocks_per_sm} blocks each")
    h = sweeps - 1
    cols = MOM_THREADS - 2 * h
    bands = -(-nx // cols)
    want = max(1, min(ny, n_sm * blocks_per_sm // bands))
    tile_rows = -(-ny // want)
    row_blocks = -(-ny // tile_rows)
    streamed = sum(min(ny, (i + 1) * tile_rows + h) - max(0, i * tile_rows - h)
                   for i in range(row_blocks))
    return MomentumPlan(bands, cols, row_blocks, tile_rows,
                        bands * MOM_THREADS * streamed / (ny * nx))


def device_momentum_plan(dev: torch.device, ny: int, nx: int,
                         sweeps: int) -> MomentumPlan:
    """:func:`momentum_plan` on the card ``dev``: its SM count, and the
    blocks per SM that its occupancy calculator gives the kernel at
    ``sweeps``; kept per card and shape."""
    key = (dev.index, ny, nx, sweeps)
    plan = _MOM_PLANS.get(key)
    if plan is None:
        lib = _stencil_lib()
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = lib.stencil_mom_blocks_per_sm(sweeps,
                                                ctypes.addressof(per_sm))
        if err:
            _raise_on(lib.stencil_error_string, err, "momentum_jacobi")
        if per_sm.value < 1:
            raise RuntimeError(f"the streamed predict at {sweeps} sweeps does "
                               f"not fit an SM of "
                               f"{torch.cuda.get_device_name(dev)}")
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _MOM_PLANS[key] = momentum_plan(ny, nx, sweeps, n_sm,
                                               per_sm.value)
    return plan


def momentum_jacobi(r, dinv, off, sweeps: int, halo=None):
    """``sweeps`` Jacobi sweeps of the momentum block from the seed
    z = D^-1 r: z <- D^-1 (r - sum_s off[s] * shift_s(z)), both components.
    ``r`` (2, ny, nx) float32 (r_u, r_v); ``dinv`` (ny, nx) (diag_u_inv2);
    ``off`` (4, ny, nx) (off_mom).  ``halo``: on a row-sharded block, a
    function of an iterate (2, ny, nx) that returns its (below, above) halo
    rows (2, 1, nx) (one exchange); None clamps to the block's edges.
    Returns z (2, ny, nx); launches :func:`momentum_launches` kernels."""
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    if not _cuda_or_cpu(r):
        return momentum_jacobi_ref(r, dinv, off, sweeps, halo)
    ny, nx = r.shape[-2:]
    dev = r.device
    _check_all(dev, [("r", r, (2, ny, nx)), ("dinv", dinv, (ny, nx)),
                     ("off", off, (4, ny, nx))])
    lib = _stencil_lib()
    if momentum_launches(sweeps, halo is not None) == 1:
        out = torch.empty_like(r)
        rows = (1 if sweeps == 1 else
                device_momentum_plan(dev, ny, nx, sweeps).tile_rows)
        err = launch(lib.momentum_jacobi, dev, r.data_ptr(), dinv.data_ptr(),
                     off.data_ptr(), out.data_ptr(), ny, nx, sweeps, rows)
        if err:
            _raise_on(lib.stencil_error_string, err, "momentum_jacobi")
        LAUNCHES["momentum_jacobi"] += 1
        return out
    z = None
    for _ in range(sweeps):
        dst = torch.empty_like(r)
        below = above = None
        if z is not None and halo is not None:
            below, above = halo(z)
            _check_all(dev, [("below", below, (2, 1, nx)),
                             ("above", above, (2, 1, nx))])
        err = launch(lib.momentum_sweep, dev, r.data_ptr(), dinv.data_ptr(),
                     off.data_ptr(), _ptr(z), _ptr(below), _ptr(above),
                     dst.data_ptr(), ny, nx)
        if err:
            _raise_on(lib.stencil_error_string, err, "momentum_jacobi")
        LAUNCHES["momentum_jacobi"] += 1
        z = dst
    return z


def schur_rhs(rp, z, d_pu, d_pv, off_pu, off_pv, below=None, above=None):
    """The Schur right-hand side r_p - D_u z_u - D_v z_v.  ``rp`` (ny, nx),
    ``z`` (2, ny, nx) (z_u, z_v), ``d_pu``/``d_pv`` (ny, nx), ``off_pu``/
    ``off_pv`` (4, ny, nx), all float32; ``below``/``above`` (2, 1, nx): the
    halo rows of z on a row-sharded block, or None.  Returns (ny, nx)."""
    if not _cuda_or_cpu(z):
        return schur_rhs_ref(rp, z, d_pu, d_pv, off_pu, off_pv, below, above)
    ny, nx = z.shape[-2:]
    dev = z.device
    named = [("z", z, (2, ny, nx)), ("rp", rp, (ny, nx)),
             ("d_pu", d_pu, (ny, nx)), ("d_pv", d_pv, (ny, nx)),
             ("off_pu", off_pu, (4, ny, nx)), ("off_pv", off_pv, (4, ny, nx))]
    if _halo_pair(below, above):
        named += [("below", below, (2, 1, nx)), ("above", above, (2, 1, nx))]
    _check_all(dev, named)
    lib = _stencil_lib()
    out = rp.new_empty((ny, nx))
    err = launch(lib.schur_rhs, dev, rp.data_ptr(), z.data_ptr(),
                 d_pu.data_ptr(), d_pv.data_ptr(), off_pu.data_ptr(),
                 off_pv.data_ptr(), _ptr(below), _ptr(above), out.data_ptr(),
                 ny, nx)
    if err:
        _raise_on(lib.stencil_error_string, err, "schur_rhs")
    LAUNCHES["schur_rhs"] += 1
    return out


def pressure_gradient(zp, d_up, d_vp, off_up, off_vp, below=None,
                      above=None):
    """G z_p, the (u, v) rows' pressure coupling: (diag_up z_p + <off_up,
    shifts(z_p)>, the same for v).  ``zp``/``d_up``/``d_vp`` (ny, nx),
    ``off_up``/``off_vp`` (4, ny, nx), all float32; ``below``/``above``
    (1, nx): the halo rows of z_p on a row-sharded block, or None.  Returns
    (2, ny, nx)."""
    if not _cuda_or_cpu(zp):
        return pressure_gradient_ref(zp, d_up, d_vp, off_up, off_vp, below,
                                     above)
    ny, nx = zp.shape[-2:]
    dev = zp.device
    named = [("zp", zp, (ny, nx)), ("d_up", d_up, (ny, nx)),
             ("d_vp", d_vp, (ny, nx)), ("off_up", off_up, (4, ny, nx)),
             ("off_vp", off_vp, (4, ny, nx))]
    if _halo_pair(below, above):
        named += [("below", below, (1, nx)), ("above", above, (1, nx))]
    _check_all(dev, named)
    lib = _stencil_lib()
    out = zp.new_empty((2, ny, nx))
    err = launch(lib.pressure_gradient, dev, zp.data_ptr(), d_up.data_ptr(),
                 d_vp.data_ptr(), off_up.data_ptr(), off_vp.data_ptr(),
                 _ptr(below), _ptr(above), out.data_ptr(), ny, nx)
    if err:
        _raise_on(lib.stencil_error_string, err, "pressure_gradient")
    LAUNCHES["pressure_gradient"] += 1
    return out

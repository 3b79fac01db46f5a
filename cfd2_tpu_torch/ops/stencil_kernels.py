"""Red-black Gauss-Seidel smoothers of the structured multigrid: the
hand-written CUDA kernels (``csrc/rbgs.cu``), their wrappers, and the plain
PyTorch version of each.

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
  card: it cost the V-cycle a transpose per smooth).

Each wrapper runs its plain version (``*_ref``) for tensors on the CPU, and
launches its kernel for CUDA tensors; anything else raises.  There is no
fallback from a CUDA tensor to the plain version.  ``LAUNCHES`` counts the
kernel launches per wrapper; :func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from . import _build
from ._launch import float_ok, launch

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {"rbgs_leg": 0, "rbgs_half_sweep": 0}


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


def _shifts2(xg: torch.Tensor):
    """Edge-clamped E, W, N, S neighbour grids of an (ny, nx) array."""
    e = torch.cat([xg[:, 1:], xg[:, -1:]], dim=1)
    w = torch.cat([xg[:, :1], xg[:, :-1]], dim=1)
    n = torch.cat([xg[1:], xg[-1:]], dim=0)
    s = torch.cat([xg[:1], xg[:-1]], dim=0)
    return e, w, n, s


def _sigma2(off2: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    e, w, n, s = _shifts2(xg)
    return off2[0] * e + off2[1] * w + off2[2] * n + off2[3] * s


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
    ``b - spmv2(x)`` (amg.py:716)."""
    color = _color2(*xg.shape, xg.device)
    dinv = _dinv(diag2)
    for _ in range(sweeps):
        for c in (0, 1):
            xn = dinv * (bg - _sigma2(off2, xg))
            xg = torch.where(color == c, xn, xg)
    if residual:
        return xg, bg - (diag2 * xg + _sigma2(off2, xg))
    return xg


def restrict2(rg: torch.Tensor, coarse_grid) -> torch.Tensor:
    """2x2 block sums of an (ny, nx) grid, zero-padded to an even grid:
    ``_GridOps.restrict2`` (cfd2_tpu/ops/amg.py)."""
    nyc, nxc = coarse_grid
    ny, nx = rg.shape
    rg = F.pad(rg, (0, 2 * nxc - nx, 0, 2 * nyc - ny))
    return rg.reshape(nyc, 2, nxc, 2).sum(dim=(1, 3))


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
    xn = _dinv(diag2) * (bg - _sigma2(off2, xg))
    upd = (_color2(*xg.shape, xg.device) + parity) % 2 == 0
    return torch.where(upd, xn, xg)


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


def _raise_on(lib, err: int, fn: str) -> None:
    if err != 0:
        msg = lib.rbgs_error_string(err).decode()
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
        _raise_on(lib, err, "rbgs_leg")
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
        _raise_on(lib, err, "rbgs_half_sweep")
    LAUNCHES["rbgs_half_sweep"] += 1
    return x_out


def smooth_rbgs_half_sweeps(diag2, off2, xg, bg, sweeps: int = 1):
    """``sweeps`` red-black sweeps as pairs of :func:`rbgs_half_sweep`
    (counterpart of ``smooth_rbgs_pallas``): the first half-sweep writes a
    new tensor, the later ones update it in place."""
    for k in range(2 * sweeps):
        xg = rbgs_half_sweep(xg, diag2, off2, bg, k % 2, in_place=k > 0)
    return xg

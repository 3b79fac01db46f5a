"""Red-black Gauss-Seidel smoothers of the structured multigrid: the
hand-written CUDA kernels (``csrc/rbgs.cu``), their wrappers, and the plain
PyTorch version of each.

Counterparts of ``cfd2_tpu/ops/pallas_stencil.py``:

* :func:`rbgs_leg` <- ``fused_rbgs2``: ``2*sweeps`` coloured half-sweeps of
  the 5-point stencil on an (ny, nx) grid, optionally followed by the
  residual ``b - A x``, in one launch (one V-cycle leg on one level);
* :func:`rbgs_half_sweep` <- ``rbgs_half_sweep``: one coloured half-sweep on
  the flat (n,) layout with ``off`` (n, 4).

Each wrapper runs its plain version (``*_ref``) for tensors on the CPU, and
launches its kernel for CUDA tensors; anything else raises.  There is no
fallback from a CUDA tensor to the plain version.  ``LAUNCHES`` counts the
kernel launches per wrapper; :func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import os

import torch

from . import _build

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


def rbgs_half_sweep_ref(x, diag, off, b, parity: int, grid_shape):
    """Plain version of :func:`rbgs_half_sweep`: one colour of
    ``_GridOps.smooth_rbgs`` (cfd2_tpu/ops/amg.py:639-646) — cells with
    ``(row + col + parity) % 2 == 0`` are relaxed, the rest copied."""
    ny, nx = grid_shape
    xg = x.reshape(ny, nx)
    off2 = off[:, :4].T.reshape(4, ny, nx)
    xn = _dinv(diag.reshape(ny, nx)) * (b.reshape(ny, nx) - _sigma2(off2, xg))
    upd = (_color2(ny, nx, x.device) + parity) % 2 == 0
    return torch.where(upd, xn, xg).reshape(-1)


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
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no RB-GS implementation for device {t.device}")


def rbgs_leg(xg, diag2, off2, bg, sweeps: int = 1, residual: bool = False):
    """``2*sweeps`` red-black Gauss-Seidel half-sweeps (parity 0 then 1) of
    the 5-point stencil, and with ``residual`` also ``b - A x`` of the
    smoothed x: one V-cycle leg.  ``xg``/``diag2``/``bg`` (ny, nx) float32,
    ``off2`` (4, ny, nx) float32 slots [E, W, N, S].  Returns x, or (x, r).
    """
    if not _cuda_or_cpu(xg):
        return rbgs_leg_ref(xg, diag2, off2, bg, sweeps, residual)
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    ny, nx = xg.shape
    dev = xg.device
    _check("x", xg, (ny, nx), dev)
    _check("diag", diag2, (ny, nx), dev)
    _check("off", off2, (4, ny, nx), dev)
    _check("b", bg, (ny, nx), dev)
    lib = _build.load("rbgs")
    x_out = torch.empty_like(xg)
    r_out = torch.empty_like(xg) if residual else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rbgs_leg(xg.data_ptr(), diag2.data_ptr(), off2.data_ptr(),
                           bg.data_ptr(), x_out.data_ptr(),
                           r_out.data_ptr() if residual else None,
                           ny, nx, sweeps, stream)
    _raise_on(lib, err, "rbgs_leg")
    LAUNCHES["rbgs_leg"] += 1
    return (x_out, r_out) if residual else x_out


def rbgs_half_sweep(x, diag, off, b, parity: int, grid_shape):
    """One coloured half-sweep: relax the cells with
    ``(row + col + parity) % 2 == 0`` and copy the others.  ``x``/``diag``/
    ``b`` (n,) float32 with n = ny*nx, ``off`` (n, 4) float32 slots
    [E, W, N, S].  Returns the new flat x (a new tensor)."""
    if not _cuda_or_cpu(x):
        return rbgs_half_sweep_ref(x, diag, off, b, parity, grid_shape)
    ny, nx = grid_shape
    n = ny * nx
    dev = x.device
    _check("x", x, (n,), dev)
    _check("diag", diag, (n,), dev)
    _check("off", off, (n, 4), dev)
    _check("b", b, (n,), dev)
    if off.data_ptr() % 16:
        raise ValueError("off must be 16-byte aligned (read as float4)")
    lib = _build.load("rbgs")
    x_out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rbgs_half_sweep(x.data_ptr(), diag.data_ptr(),
                                  off.data_ptr(), b.data_ptr(),
                                  x_out.data_ptr(), ny, nx, int(parity) & 1,
                                  stream)
    _raise_on(lib, err, "rbgs_half_sweep")
    LAUNCHES["rbgs_half_sweep"] += 1
    return x_out


def smooth_rbgs_half_sweeps(grid_shape, diag, off, x, b, sweeps: int = 1):
    """``sweeps`` red-black sweeps as pairs of :func:`rbgs_half_sweep` on the
    flat layout (counterpart of ``smooth_rbgs_pallas``)."""
    off4 = off[:, :4].contiguous()
    for _ in range(sweeps):
        for parity in (0, 1):
            x = rbgs_half_sweep(x, diag, off4, b, parity, grid_shape)
    return x

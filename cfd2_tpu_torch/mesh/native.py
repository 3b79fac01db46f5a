"""ctypes bindings for the native C++ mesh kernels (native/meshkern.cpp).

Builds the shared library on first use (``make -C native``: g++ -O3
-fopenmp; where the compiler has no OpenMP runtime, once more without
``-fopenmp``, which only leaves the smoothing loop serial) and falls back to
the pure-NumPy implementations when the toolchain or library is unavailable.
The fallbacks are host meshing code for small meshes: at several hundred
thousand cells the pure-Python Poisson-disk sampler takes hours, so callers
of that size use :func:`build` first, which raises instead of falling back.
This mirrors the reference's native split: its host meshing hot loops are
Rust + rayon + SIMD, ours are C++ + OpenMP behind a thin Python layer.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmeshkern.so")
_lib = None
_tried = False

GEOM_KINDS = {
    "ChannelWithObstacle": 0,
    "BackwardsStep": 1,
    "RectangularChannel": 2,
    "CircleObstacle": 3,
}


def _geom_kind_params(geo):
    """Map a Geometry instance to (kind, params) for the C SDF evaluators."""
    name = type(geo).__name__
    kind = GEOM_KINDS.get(name)
    if kind is None:
        return None
    if kind == 0:
        p = [geo.length, geo.height, geo.obstacle_center[0],
             geo.obstacle_center[1], geo.obstacle_radius]
    elif kind == 1:
        p = [geo.length, geo.height_inlet, geo.height_outlet, geo.step_x]
    elif kind == 2:
        p = [geo.length, geo.height]
    else:
        p = [geo.center[0], geo.center[1], geo.radius]
    return kind, np.asarray(p, dtype=np.float64)


def _serial_flags() -> str:
    """The Makefile's own CXXFLAGS without ``-fopenmp``."""
    with open(os.path.join(_NATIVE_DIR, "Makefile")) as f:
        flags = re.search(r"^CXXFLAGS\s*\?=\s*(.*)$", f.read(), re.M).group(1)
    return " ".join(w for w in flags.split() if w != "-fopenmp")


def build(rebuild: bool = False) -> str:
    """Build ``native/libmeshkern.so`` unless it exists.  ``rebuild`` removes
    an existing library first: it is compiled with ``-march=native``, so one
    that was built on another machine may not run on this one.  Returns a
    word for how it was built ("present", "openmp" or "serial"); raises
    RuntimeError with the compiler's output when every variant fails."""
    if rebuild and os.path.exists(_LIB_PATH):
        os.remove(_LIB_PATH)
    if os.path.exists(_LIB_PATH):
        return "present"
    logs = []
    # The Makefile's own flags, then the same without OpenMP.
    variants = (("openmp", ()),
                ("serial", (f"CXXFLAGS={_serial_flags()}",)))
    for name, extra in variants:
        try:
            out = subprocess.run(["make", "-C", _NATIVE_DIR, *extra],
                                 capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            logs.append(f"[{name}] {e}")
            continue
        if out.returncode == 0 and os.path.exists(_LIB_PATH):
            return name
        logs.append(f"[{name}] exit {out.returncode}\n{out.stdout}"
                    f"{out.stderr}")
    raise RuntimeError("could not build native/libmeshkern.so:\n"
                       + "\n".join(logs))


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        build()
    except RuntimeError:
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    lib.meshkern_poisson_disk.restype = ctypes.c_int64
    lib.meshkern_poisson_disk.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
    ]
    lib.meshkern_amg_aggregate.restype = ctypes.c_int64
    lib.meshkern_amg_aggregate.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.meshkern_smooth.restype = None
    lib.meshkern_smooth.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_double,
    ]
    _lib = lib
    return lib


def available(geo=None) -> bool:
    if geo is not None and _geom_kind_params(geo) is None:
        return False
    return _load() is not None


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def amg_aggregate(ell_ngh: np.ndarray, mask: np.ndarray):
    """Native greedy aggregation; returns (agg, num) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n, k = ell_ngh.shape
    ngh = np.ascontiguousarray(ell_ngh, dtype=np.int32)
    m8 = np.ascontiguousarray(mask, dtype=np.uint8)
    agg = np.empty(n, dtype=np.int64)
    num = lib.meshkern_amg_aggregate(
        ngh.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        m8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, k, agg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return agg, int(num)


def poisson_disk(geo, boundary: np.ndarray, min_cell: float, max_cell: float,
                 growth_rate: float, domain_size, seed: int = 0):
    """Native Bridson sampling; returns (M, 2) points (boundary first) or
    None when native path is unavailable for this geometry."""
    lib = _load()
    kp = _geom_kind_params(geo)
    if lib is None or kp is None:
        return None
    kind, params = kp
    boundary = np.ascontiguousarray(boundary, dtype=np.float64)
    area = float(domain_size[0]) * float(domain_size[1])
    max_out = int(4.0 * area / (min_cell * min_cell)) + len(boundary) + 1024
    out = np.empty((max_out, 2), dtype=np.float64)
    n = lib.meshkern_poisson_disk(
        kind, _dptr(params), _dptr(boundary), len(boundary),
        min_cell, max_cell, growth_rate,
        float(domain_size[0]), float(domain_size[1]),
        seed, _dptr(out), max_out)
    return out[:n].copy()


def smooth(geo, vx: np.ndarray, vy: np.ndarray, adj_off: np.ndarray,
           adj: np.ndarray, fixed: np.ndarray, on_box: np.ndarray,
           iterations: int, alpha: float = 0.5):
    """Native smoothing iterations in place; returns True on success."""
    lib = _load()
    kp = _geom_kind_params(geo)
    if lib is None or kp is None:
        return False
    kind, params = kp
    adj_off = np.ascontiguousarray(adj_off, dtype=np.int64)
    adj = np.ascontiguousarray(adj, dtype=np.int64)
    fixed_u8 = np.ascontiguousarray(fixed, dtype=np.uint8)
    box_u8 = np.ascontiguousarray(on_box, dtype=np.uint8)
    lib.meshkern_smooth(
        kind, _dptr(params), _dptr(vx), _dptr(vy), len(vx),
        adj_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        fixed_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        box_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        iterations, alpha)
    return True

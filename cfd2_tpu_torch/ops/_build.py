"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use by ``nvcc`` into a shared library with a
plain C interface (``-gencode arch=compute_90a,code=sm_90a``), written to
``cfd2_tpu_torch/_build/`` under a name that carries a hash of the source, and
loaded with ``ctypes``.  Importing this module needs neither ``nvcc`` nor a
GPU; a build that fails raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every exported function, by source: (argtypes, restype).
SIGNATURES = {
    "rbgs": {
        # x, diag, off, b, x_coarse, x_out, r_out, ny, nx, sweeps, mode, stream
        "rbgs_leg": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        # x, diag, off, b, x_out, ny, nx, parity, stream
        "rbgs_half_sweep": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
        # x, diag, off, b, r_out, ny, nx, nyc, nxc, stream
        "rbgs_residual": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "rbgs_error_string": ([_I], ctypes.c_char_p),
    },
    "stencil": {
        # x, off_mom, off_up, off_vp, off_pu, off_pv, off_pp, d_u, d_up, d_vp,
        # d_pu, d_pv, d_pp, below, above, y, ny, nx, stream
        "coupled_spmv": ([_P] * 16 + [_I, _I, _P], _I),
        # r, dinv, off, out, ny, nx, sweeps, tile_rows, stream
        "momentum_jacobi": ([_P] * 4 + [_I, _I, _I, _I, _P], _I),
        # r, dinv, off, z, below, above, out, ny, nx, stream
        "momentum_sweep": ([_P] * 7 + [_I, _I, _P], _I),
        # rp, z, d_pu, d_pv, off_pu, off_pv, below, above, out, ny, nx, stream
        "schur_rhs": ([_P] * 9 + [_I, _I, _P], _I),
        # zp, d_up, d_vp, off_up, off_vp, below, above, out, ny, nx, stream
        "pressure_gradient": ([_P] * 8 + [_I, _I, _P], _I),
        "stencil_tile_max_sweeps": ([], _I),
        "stencil_mom_threads": ([], _I),
        # sweeps, out
        "stencil_mom_blocks_per_sm": ([_I, _P], _I),
        "stencil_error_string": ([_I], ctypes.c_char_p),
    },
    "banded": {
        # x, idx, out, M, K, C, stream
        "banded_gather": ([_P, _P, _P, _I, _I, _I, _P], _I),
        # base, x, idx, alpha, out, M, stream
        "banded_prolong_add": ([_P, _P, _P, ctypes.c_float, _P, _I, _P], _I),
        # The named product forms: their operands, their planes, out, idx, M,
        # K, stream.
        "banded_dot_scalar": ([_P] * 4 + [_I, _I, _P], _I),
        "banded_dot_mom2": ([_P] * 5 + [_I, _I, _P], _I),
        "banded_dot_schur_rhs": ([_P] * 6 + [_I, _I, _P], _I),
        "banded_dot_grad": ([_P] * 5 + [_I, _I, _P], _I),
        "banded_dot_spmv": ([_P] * 11 + [_I, _I, _P], _I),
        # xs, n_x, offs, n_off, out, n_out, pair_off, pair_x, pair_start,
        # idx, M, K, stream
        "banded_dot": ([_P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _P],
                       _I),
        # C, out[4]
        "banded_sweeps_limits": ([_I, _P], _I),
        # rs, C, dinv, off, idx, za, zb, n, K, k_cap, sweeps, form, blocks,
        # rows, smem, stream
        "banded_jacobi_sweeps": ([_P, _I, _P, _P, _P, _P, _P] + [_I] * 8
                                 + [_P], _I),
        "banded_error_string": ([_I], ctypes.c_char_p),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, extra_flags=()):
    """Start ``nvcc`` for one source; returns (process, tmp, target), or
    None when the library for this source is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, job) -> str:
    proc, tmp, target = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)
    return out


def build_all(extra_flags=()) -> dict[str, str]:
    """Compile every source in ``csrc/`` at once (one ``nvcc`` each, all
    started together).  Returns the compiler's output per source built."""
    with _lock:
        jobs = {name: _start(name, extra_flags) for name in SIGNATURES}
        return {name: _finish(name, job)
                for name, job in jobs.items() if job is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
        return lib

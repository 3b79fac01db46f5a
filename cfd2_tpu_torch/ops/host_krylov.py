"""Host-side GMRES (a debug and verification path).

Port of ``cfd2_tpu.ops.host_krylov`` (the reference's CPU-state GMRES,
src/solver/gpu/linear_solver/gmres.rs:15-178): SciPy's GMRES over a
LinearOperator whose matvec may run on the device, an independent check of
the on-device FGMRES.
"""

from __future__ import annotations

import numpy as np


def host_gmres(matvec, b: np.ndarray, x0: np.ndarray | None = None,
               restart: int = 50, max_restarts: int = 20,
               tol: float = 1e-5):
    """Solve A x = b with SciPy's GMRES; ``matvec`` maps a float32 (n,)
    numpy array to an (n,) array (numpy, or a tensor on any device).
    Returns (x, info)."""
    import scipy.sparse.linalg as spla

    def mv(v):
        y = matvec(v.astype(np.float32))
        if hasattr(y, "detach"):
            y = y.detach().cpu().numpy()
        return np.asarray(y, dtype=np.float64).reshape(-1)

    b = np.asarray(b, dtype=np.float64).reshape(-1)
    n = b.shape[0]
    op = spla.LinearOperator((n, n), matvec=mv)
    x, info = spla.gmres(op, b,
                         x0=None if x0 is None else np.asarray(x0).reshape(-1),
                         restart=restart, maxiter=max_restarts, rtol=tol)
    return x, info

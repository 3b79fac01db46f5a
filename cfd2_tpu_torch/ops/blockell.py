"""Block-ELL system container and its products.

Port of ``cfd2_tpu.ops.blockell``.  The coupled (u, v, p) system is kept as
dense per-cell 3x3 blocks keyed by the mesh's padded (N, K) slot structure:
(N, 3, 3) diagonal and (N, K, 3, 3) off-diagonal blocks (the reference's
interleaved 3Nx3N block CSR, init/linear_solver/mod.rs:180-216).  This is the
solve path of block-Jacobi preconditioning and of the meshes with no fused
banded products (generic meshes without a banded index map, structured
meshes too small for the structured multigrid).

The products are two einsums over the values ``mesh.gather`` returns: grid
shifts on structured meshes, the ``banded_gather`` kernel through
``ck_neighbor`` everywhere else.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class BlockSystem:
    """Assembled coupled system + scalar pressure (Schur) system.

    Off-diagonal blocks are identically zero at padding and boundary slots,
    so no masks are needed in products.
    """
    A_diag: torch.Tensor      # (N, 3, 3)
    A_off: torch.Tensor       # (N, K, 3, 3)
    rhs: torch.Tensor         # (N, 3)
    P_diag: torch.Tensor      # (N,)   scalar pressure matrix diagonal
    P_off: torch.Tensor       # (N, K)
    diag_u_inv: torch.Tensor  # (N,)
    diag_v_inv: torch.Tensor  # (N,)
    diag_p_inv: torch.Tensor  # (N,)  inverse of scalar pressure diagonal


def block_spmv(sys: BlockSystem, mesh, x: torch.Tensor) -> torch.Tensor:
    """y = A x with x of shape (N, 3)."""
    xg = mesh.gather(x)                          # (N, K, 3)
    y = torch.einsum("nab,nb->na", sys.A_diag, x)
    return y + torch.einsum("nkab,nkb->na", sys.A_off, xg)


def scalar_spmv(P_diag: torch.Tensor, P_off: torch.Tensor, mesh,
                x: torch.Tensor) -> torch.Tensor:
    """y = P x with x of shape (N,): the scalar pressure (Schur) operator."""
    xg = mesh.gather(x)                          # (N, K)
    return P_diag * x + torch.sum(P_off * xg, dim=1)

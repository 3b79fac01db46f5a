"""Linear algebra: the hand-written RB-GS and banded kernels, the
multigrids, the stencil, ELL and block-ELL coupled operators, the Schur
preconditioners and FGMRES."""

from .blockell import BlockSystem, block_spmv, scalar_spmv
from .fgmres import FgmresResult, fgmres_solve
from .schur import schur_preconditioner

__all__ = [
    "BlockSystem", "block_spmv", "scalar_spmv",
    "fgmres_solve", "FgmresResult", "schur_preconditioner",
]

"""Linear algebra on the structured grid: hand-written RB-GS kernels, the
geometric multigrid, the stencil-form coupled operator and FGMRES."""

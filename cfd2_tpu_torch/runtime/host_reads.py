"""Counted device-to-host reads.

The eager loops of the port (FGMRES, the outer correctors) test convergence
on the host, and each such test waits for the device.  Every value they need
goes through :func:`read`, so a run can report how many times per step it
synchronised (``COUNT["reads"]``).
"""

from __future__ import annotations

import numpy as np
import torch

COUNT = {"reads": 0}


def reset() -> None:
    COUNT["reads"] = 0


def read(t: torch.Tensor) -> np.ndarray:
    """Copy ``t`` to the host (one synchronisation) as a numpy array."""
    COUNT["reads"] += 1
    return t.detach().cpu().numpy()


def host_array(x) -> np.ndarray:
    """``x`` as a host array: a tensor is copied off its device, uncounted
    (a metric, a field for a frame, not a convergence test)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

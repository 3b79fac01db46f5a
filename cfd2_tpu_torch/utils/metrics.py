"""Structured per-step metrics logging.

Port of ``cfd2_tpu.utils.metrics``.  The solver's multi-step loops return
per-step metrics as dicts of 1-D tensors; :class:`MetricsLog` accumulates
them across runs, renders summaries, and exports JSONL for external tooling.
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

from ..runtime.host_reads import host_array


class MetricsLog:
    """Accumulates per-step metric dicts (scalars or arrays of steps)."""

    def __init__(self):
        self._series = defaultdict(list)

    def append(self, metrics: dict) -> None:
        """Add one run's metrics (each value: scalar, (steps,) array or
        tensor; tensors go to the host here, one copy per value)."""
        for key, val in metrics.items():
            arr = np.atleast_1d(host_array(val))
            self._series[key].extend(arr.tolist())

    def __getitem__(self, key: str) -> np.ndarray:
        return np.asarray(self._series[key])

    def __len__(self) -> int:
        if not self._series:
            return 0
        return max(len(v) for v in self._series.values())

    @property
    def keys(self):
        return list(self._series.keys())

    def summary(self) -> str:
        lines = [f"=== Run metrics ({len(self)} steps) ==="]
        for key, vals in self._series.items():
            a = np.asarray(vals, dtype=np.float64)
            lines.append(f"  {key:<20} last={a[-1]:.4g}  mean={a.mean():.4g} "
                         f" min={a.min():.4g}  max={a.max():.4g}")
        return "\n".join(lines)

    def to_jsonl(self, path: str) -> None:
        n = len(self)
        with open(path, "w") as f:
            for i in range(n):
                row = {k: (v[i] if i < len(v) else None)
                       for k, v in self._series.items()}
                f.write(json.dumps(row) + "\n")

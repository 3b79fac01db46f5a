"""Profiling and performance observability.

Port of ``cfd2_tpu.runtime.profiling``, the same shape as the reference's
``ProfilingStats`` (src/solver/gpu/profiling.rs:13-641): enable/disable
switch, seven categories, per-location statistics keyed
"category:location", transfer-size tracking, session wall-clock +
per-iteration accounting, a formatted report with top hotspots, and
auto-generated optimization suggestions.  The device-side detail the
reference sampled by hand-inserted timers is covered here by a
``torch.profiler`` trace (:meth:`trace`), which records every CUDA kernel
(the hand-written ones by name) beside the host's operators.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from enum import Enum


class ProfileCategory(Enum):
    """Reference profiling.rs:13-28."""
    DEVICE_READ = "DeviceRead"
    DEVICE_WRITE = "DeviceWrite"
    DEVICE_SYNC = "DeviceSync"
    DEVICE_DISPATCH = "DeviceDispatch"
    HOST_COMPUTE = "HostCompute"
    RESOURCE_CREATION = "ResourceCreation"
    COMPILATION = "Compilation"
    OTHER = "Other"


@dataclass
class LocationStats:
    count: int = 0
    total_seconds: float = 0.0
    total_bytes: int = 0
    max_seconds: float = 0.0

    def record(self, seconds: float, nbytes: int = 0):
        self.count += 1
        self.total_seconds += seconds
        self.total_bytes += nbytes
        self.max_seconds = max(self.max_seconds, seconds)


@dataclass
class ProfilingStats:
    enabled: bool = False
    locations: dict = field(default_factory=lambda: defaultdict(LocationStats))
    session_start: float | None = None
    session_seconds: float = 0.0
    iterations: int = 0

    # --- control (profiling.rs enable/disable atomics) ---
    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def reset(self):
        self.locations.clear()
        self.session_seconds = 0.0
        self.iterations = 0
        self.session_start = None

    # --- recording ---
    def record_location(self, location: str, category: ProfileCategory,
                        seconds: float, nbytes: int = 0):
        if not self.enabled:
            return
        self.locations[f"{category.value}:{location}"].record(seconds, nbytes)

    def increment_iteration(self):
        if self.enabled:
            self.iterations += 1

    @contextlib.contextmanager
    def scope(self, location: str, category: ProfileCategory, nbytes: int = 0):
        """RAII-style timer (reference ProfileTimer / profile_scope!)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record_location(location, category,
                                 time.perf_counter() - t0, nbytes)

    # --- sessions (profiling.rs session API) ---
    def start_session(self):
        if self.enabled:
            self.session_start = time.perf_counter()

    def end_session(self):
        if self.enabled and self.session_start is not None:
            self.session_seconds += time.perf_counter() - self.session_start
            self.session_start = None

    @contextlib.contextmanager
    def session(self):
        self.start_session()
        try:
            yield
        finally:
            self.end_session()

    # --- device-side tracing ---
    @contextlib.contextmanager
    def trace(self, logdir: str | None = None, device=None):
        """Capture a ``torch.profiler`` trace of the block and write it to
        ``logdir/trace.json`` (Chrome trace format: chrome://tracing or
        Perfetto) — the equivalent of the reference's per-dispatch GPU
        timestamps.  ``device``: the device whose work is traced; None
        means CUDA (and raises without a GPU), whose kernels are then
        recorded beside the host's operators.  ``logdir`` defaults to
        ``cfd2_tpu_torch_trace`` under the temporary directory.  Yields the
        profiler."""
        import torch
        from .device_mesh import resolve_device
        device = resolve_device(device)
        if logdir is None:
            logdir = os.path.join(tempfile.gettempdir(),
                                  "cfd2_tpu_torch_trace")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

    # --- reporting (profiling.rs:367-583) ---
    def category_totals(self) -> dict[str, float]:
        totals: dict[str, float] = defaultdict(float)
        for key, stats in self.locations.items():
            cat = key.split(":", 1)[0]
            totals[cat] += stats.total_seconds
        return dict(totals)

    def report(self, top: int = 15) -> str:
        lines = ["=== Profiling Report ==="]
        total = sum(s.total_seconds for s in self.locations.values())
        if self.session_seconds:
            lines.append(f"Session wall-clock: {self.session_seconds:.3f}s"
                         + (f" ({self.session_seconds / max(self.iterations, 1):.4f}s/iter,"
                            f" {self.iterations} iters)" if self.iterations else ""))
        lines.append(f"Recorded time: {total:.3f}s across "
                     f"{len(self.locations)} locations")
        lines.append("")
        lines.append("-- By category --")
        for cat, secs in sorted(self.category_totals().items(),
                                key=lambda kv: -kv[1]):
            pct = 100.0 * secs / total if total else 0.0
            lines.append(f"  {cat:<18} {secs:8.3f}s  {pct:5.1f}%")
        lines.append("")
        lines.append(f"-- Top {top} locations --")
        ranked = sorted(self.locations.items(),
                        key=lambda kv: -kv[1].total_seconds)[:top]
        for key, s in ranked:
            mb = s.total_bytes / 1e6
            lines.append(
                f"  {key:<46} {s.total_seconds:8.3f}s  x{s.count:<6}"
                + (f"  {mb:8.1f}MB" if s.total_bytes else ""))
        sugg = self.suggestions()
        if sugg:
            lines.append("")
            lines.append("-- Suggestions --")
            lines.extend(f"  * {s}" for s in sugg)
        return "\n".join(lines)

    def suggestions(self) -> list[str]:
        """Auto-generated optimization hints (profiling.rs:517-583)."""
        out = []
        totals = self.category_totals()
        total = sum(totals.values()) or 1.0
        reads = totals.get(ProfileCategory.DEVICE_READ.value, 0.0)
        sync = totals.get(ProfileCategory.DEVICE_SYNC.value, 0.0)
        comp = totals.get(ProfileCategory.COMPILATION.value, 0.0)
        if reads / total > 0.3:
            out.append("device->host reads dominate: keep fields on device "
                       "(run() scans steps without readback)")
        if sync / total > 0.3:
            out.append("sync-heavy: batch steps with multi_step() instead of "
                       "stepping one at a time")
        if comp / total > 0.5:
            out.append("compilation dominates: avoid changing static config "
                       "(scheme/precond/mesh) between runs")
        for key, s in self.locations.items():
            if key.startswith(ProfileCategory.DEVICE_READ.value) and \
                    s.count > 100 and s.total_bytes / max(s.count, 1) < 1024:
                out.append(f"many small reads at {key.split(':', 1)[1]}: "
                           "carry values through the scan instead")
        return out

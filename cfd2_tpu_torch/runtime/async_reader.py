"""Non-blocking device-to-host reads.

Port of ``cfd2_tpu.runtime.async_reader`` (the reference's double-buffered
``AsyncScalarReader``, async_buffer.rs:11-248): start a read, go on
enqueuing work, poll for the value later.  A CUDA tensor is copied into
pinned host memory on the current stream with ``non_blocking=True`` and a
CUDA event marks its end; a CPU tensor is copied at once.  The pair of
``CoupledSolver.max_velocity_device``.
"""

from __future__ import annotations

import torch


class AsyncFieldReader:
    """start_read / poll / get_last_value over device tensors; at most
    ``depth`` reads in flight (the oldest is waited for beyond that)."""

    def __init__(self, depth: int = 2):
        self._pending: list = []
        self._last = None
        self._depth = depth

    def start_read(self, t: torch.Tensor) -> None:
        """Begin a copy of ``t`` to the host."""
        t = t.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = t.clone(), None
        self._pending.append((host, done))
        while len(self._pending) > self._depth:
            self._last = self._land(*self._pending.pop(0))

    @staticmethod
    def _land(host, done):
        if done is not None:
            done.synchronize()
        return host.numpy()

    def poll(self) -> bool:
        """Harvest the finished reads; True if a new value landed."""
        got = False
        while self._pending and (self._pending[0][1] is None
                                 or self._pending[0][1].query()):
            self._last = self._land(*self._pending.pop(0))
            got = True
        return got

    def get_last_value(self):
        """The most recent landed value as a numpy array (None until the
        first read lands)."""
        return self._last

    def flush(self):
        """Wait for every pending read; returns the last value."""
        for host, done in self._pending:
            self._last = self._land(host, done)
        self._pending = []
        return self._last

    def reset(self):
        self._pending = []
        self._last = None

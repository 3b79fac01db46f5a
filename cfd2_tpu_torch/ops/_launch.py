"""What every kernel wrapper does around its ctypes call, kept cheap: the step
is bound by the host, so a wrapper's microseconds count as much as its
kernel's.  Finds the raw CUDA stream PyTorch is issuing to, and makes the
tensors' device current only when it is not already (entering
``torch.cuda.device`` costs several microseconds per call)."""

from __future__ import annotations

import torch

# The stream handle without building a torch.cuda.Stream object per call;
# absent from builds without CUDA, where no kernel is ever launched.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_n_devices = None


def current_stream(dev: torch.device) -> int:
    if _raw_stream is not None:
        return _raw_stream(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def launch(fn, dev: torch.device, *args) -> int:
    """``fn(*args, stream)`` on the current stream of ``dev``; returns the
    function's cudaError_t."""
    global _n_devices
    if _n_devices is None:
        _n_devices = torch.cuda.device_count()
    if _n_devices > 1 and torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return fn(*args, current_stream(dev))
    return fn(*args, current_stream(dev))


def float_ok(t: torch.Tensor, shape, dev: torch.device) -> bool:
    """One pass over what a kernel needs of a float32 tensor; the wrappers
    name the fault (``_check``) only after this has failed."""
    return (t.dtype is torch.float32 and t.shape == shape and t.device == dev
            and t.is_contiguous())

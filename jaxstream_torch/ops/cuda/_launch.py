"""What every kernel wrapper of the port shares: the C entry points of
the built libraries, the argument checks, the device test and the
stream.

A wrapper launches its CUDA kernel on CUDA tensors and runs its plain
PyTorch version on CPU tensors; :meth:`KernelBase._on_cuda` makes that
choice from the tensor it is given, and raises for any other device.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

__all__ = ["KernelBase"]

_P = ctypes.c_void_p


def _ptr(t):
    """A tensor's device pointer, or NULL for an operand a launch does not
    read (a stage-1 kernel's y0)."""
    return None if t is None else t.data_ptr()


def _entry(lib_name: str, fn_name: str, argtypes):
    """A built kernel library's C entry point (built at first use)."""
    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_tensors(want, device):
    """Validate ``{name: (tensor, shape)}`` before pointers are passed:
    float32, contiguous, the expected shape, on ``device``."""
    for name, (t, shape) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}; this kernel was "
                             f"built for {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class KernelBase:
    """The device test and the stream of a kernel wrapper."""

    @staticmethod
    def _on_cuda(t):
        """True for a CUDA tensor (launch the kernel), False for a CPU
        tensor (run the plain version); raises for any other device."""
        if t.device.type == "cpu":
            return False
        if t.device.type != "cuda":
            raise ValueError(f"unsupported device {t.device}")
        return True

    def _stream(self):
        return torch.cuda.current_stream(self.device).cuda_stream

"""Fused LRN forward as a hand-written CUDA kernel (``csrc/lrn.cu``).

The twin of ``deepvision_tpu/ops/lrn_pallas.py``: the same function over
the same ``(B·H·W, C)`` view of an NHWC activation, one read and one
write of it. The kernel is built with ``nvcc`` at first use
(``ops/_build.py``) and launched through ctypes on PyTorch's current
stream. Forward only: the backward comes with the training path.
"""

from __future__ import annotations

import ctypes

import torch

from deepvision_tpu_torch.ops._build import load_library

__all__ = ["local_response_norm_cuda", "KERNEL_NAMES"]

KERNEL_NAMES = {torch.float32: "lrn_forward_f32",
                torch.bfloat16: "lrn_forward_bf16"}


def _bind(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def local_response_norm_cuda(x: torch.Tensor, size: int = 5,
                             alpha: float = 1e-4, beta: float = 0.75,
                             k: float = 2.0) -> torch.Tensor:
    """LRN over the trailing channel axis of a contiguous NHWC (or any
    contiguous ``(..., C)``) CUDA tensor of float32 or bfloat16; returns
    a new tensor of the same shape and dtype.

    ``local_response_norm_cuda.launches`` counts kernel launches, and
    ``launches_by_kernel`` splits them by entry point."""
    if x.device.type != "cuda":
        raise ValueError(
            f"local_response_norm_cuda takes a CUDA tensor, got {x.device}")
    name = KERNEL_NAMES.get(x.dtype)
    if name is None:
        raise TypeError(
            f"local_response_norm_cuda takes float32 or bfloat16, got "
            f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(
            "local_response_norm_cuda needs a contiguous NHWC tensor "
            f"(channels last in memory); got strides {x.stride()} for "
            f"shape {tuple(x.shape)}")
    if x.requires_grad:
        raise NotImplementedError(
            "local_response_norm_cuda is forward-only; its backward comes "
            "with the training path")
    if size < 1:
        raise ValueError(f"window size must be >= 1, got {size}")
    lib = load_library("lrn")
    c = x.shape[-1]
    if c > lib.lrn_max_channels():
        raise ValueError(
            f"local_response_norm_cuda holds at most "
            f"{lib.lrn_max_channels()} channels per row, got {c}")
    y = torch.empty_like(x)
    rows = x.numel() // c if c else 0
    if rows == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _bind(lib, name)(
            x.data_ptr(), y.data_ptr(), rows, c, size, alpha / size, beta,
            k, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"(rows={rows}, C={c}, size={size})")
    local_response_norm_cuda.launches += 1
    local_response_norm_cuda.launches_by_kernel[name] += 1
    return y


local_response_norm_cuda.launches = 0
local_response_norm_cuda.launches_by_kernel = dict.fromkeys(
    KERNEL_NAMES.values(), 0)

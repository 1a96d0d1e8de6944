"""Fused LRN forward and backward as hand-written CUDA kernels.

The twins of ``deepvision_tpu/ops/lrn_pallas.py``: the same functions
over the same ``(B·H·W, C)`` view of NHWC tensors. The forward
(``csrc/lrn.cu``) reads the activation once and writes it once; the
backward (``csrc/lrn_bwd.cu``, the twin of the ``custom_vjp`` backward
``_bwd``) reads x and the incoming gradient once and writes dx once. Each
is built with ``nvcc`` at first use (``ops/_build.py``) and launched
through ctypes on PyTorch's current stream. Both take the tile rows of
:func:`_launch_plan`, which the CPU tests pin at every shape of the
model zoo; their launchers derive the rest (the vector width, the
shared memory, the persistent grid) on the card.

These are raw launchers: one forward-only, one backward-only. The
autograd ``Function`` that pairs them is ``ops/lrn.py``'s.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from deepvision_tpu_torch.ops import note_captured
from deepvision_tpu_torch.ops._build import load_library

__all__ = ["local_response_norm_cuda", "local_response_norm_backward_cuda",
           "KERNEL_NAMES", "BACKWARD_KERNEL_NAMES"]

KERNEL_NAMES = {torch.float32: "lrn_forward_f32",
                torch.bfloat16: "lrn_forward_bf16"}
BACKWARD_KERNEL_NAMES = {torch.float32: "lrn_backward_f32",
                         torch.bfloat16: "lrn_backward_bf16"}

# target bytes of one warp's staged tile: 96 16-byte vectors, three whole
# runs of 32 lanes
TILE_BYTES = 1536


class LaunchPlan(NamedTuple):
    tile_rows: int      # rows a tile; tile bytes a multiple of 16
    tiles: int


def _launch_plan(rows: int, c: int, itemsize: int) -> LaunchPlan:
    """How ``csrc/lrn.cu`` and ``csrc/lrn_bwd.cu`` tile a ``(rows, c)``
    activation of ``itemsize``-byte elements (the backward stages an x
    tile and a g tile of this plan).

    A tile is ``tile_rows`` whole rows, one contiguous span that one bulk
    copy stages into a warp's ring: about ``TILE_BYTES``, and a multiple
    of 16 bytes, so that every tile starts 16-byte aligned for any
    ``c``."""
    if rows <= 0 or c <= 0:
        raise ValueError(f"no LRN launch for rows={rows}, C={c}")
    row_bytes = c * itemsize
    step = 16 // math.gcd(row_bytes, 16)  # rows whose bytes make 16
    tile_rows = max(step, TILE_BYTES // row_bytes // step * step)
    return LaunchPlan(tile_rows=tile_rows, tiles=-(-rows // tile_rows))


def _bind(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        if name in BACKWARD_KERNEL_NAMES.values():
            fn.argtypes = [p, p, p, ctypes.c_longlong, i, i, f, f, f, i, p]
        else:
            fn.argtypes = [p, p, ctypes.c_longlong, i, i, f, f, f, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, who: str, names: dict) -> str:
    """The kernel's entry point for ``x``; raises on what it does not
    take."""
    if x.device.type != "cuda":
        raise ValueError(f"{who} takes a CUDA tensor, got {x.device}")
    name = names.get(x.dtype)
    if name is None:
        raise TypeError(f"{who} takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(
            f"{who} needs a contiguous NHWC tensor (channels last in "
            f"memory); got strides {x.stride()} for shape {tuple(x.shape)}")
    return name


def _check_aligned(t: torch.Tensor, who: str) -> None:
    """The kernels stage tiles by bulk copies and store 16-byte vectors:
    a base pointer off a 16-byte boundary is refused, never copied."""
    if t.data_ptr() % 16:
        raise ValueError(
            f"{who} needs a 16-byte aligned tensor (the kernel stages it by "
            f"bulk copies); got address {t.data_ptr():#x}")


def local_response_norm_cuda(x: torch.Tensor, size: int = 5,
                             alpha: float = 1e-4, beta: float = 0.75,
                             k: float = 2.0) -> torch.Tensor:
    """LRN over the trailing channel axis of a contiguous NHWC (or any
    contiguous ``(..., C)``) CUDA tensor of float32 or bfloat16; returns
    a new tensor of the same shape and dtype.

    ``local_response_norm_cuda.launches`` counts kernel launches, and
    ``launches_by_kernel`` splits them by entry point."""
    name = _check(x, "local_response_norm_cuda", KERNEL_NAMES)
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            "local_response_norm_cuda is the raw forward launcher and "
            "records no gradient; call ops.lrn.local_response_norm, whose "
            "autograd Function pairs it with the backward kernel")
    if size < 1:
        raise ValueError(f"window size must be >= 1, got {size}")
    _check_aligned(x, "local_response_norm_cuda")
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
    plan = _launch_plan(rows, c, x.element_size())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _bind(lib, name)(
            x.data_ptr(), y.data_ptr(), rows, c, size, alpha / size, beta,
            k, plan.tile_rows, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"(rows={rows}, C={c}, size={size}, {plan})")
    if torch.cuda.is_current_stream_capturing():
        note_captured(name)  # recorded into a graph, launched by replays
    else:
        local_response_norm_cuda.launches += 1
        local_response_norm_cuda.launches_by_kernel[name] += 1
    return y


local_response_norm_cuda.launches = 0
local_response_norm_cuda.launches_by_kernel = dict.fromkeys(
    KERNEL_NAMES.values(), 0)


def local_response_norm_backward_cuda(x: torch.Tensor, g: torch.Tensor,
                                      size: int = 5, alpha: float = 1e-4,
                                      beta: float = 0.75,
                                      k: float = 2.0) -> torch.Tensor:
    """The gradient of the LRN with respect to ``x``, given the incoming
    gradient ``g``: contiguous NHWC (or any contiguous ``(..., C)``) CUDA
    tensors of one shape and one dtype, float32 or bfloat16; returns dx in
    that dtype.

    ``local_response_norm_backward_cuda.launches`` counts kernel
    launches, and ``launches_by_kernel`` splits them by entry point."""
    who = "local_response_norm_backward_cuda"
    name = _check(x, who, BACKWARD_KERNEL_NAMES)
    _check(g, who, BACKWARD_KERNEL_NAMES)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(
            f"{who} needs x and g of one shape, dtype and device; got "
            f"{tuple(x.shape)} {x.dtype} {x.device} and {tuple(g.shape)} "
            f"{g.dtype} {g.device}")
    if size < 1:
        raise ValueError(f"window size must be >= 1, got {size}")
    _check_aligned(x, who)
    _check_aligned(g, who)
    lib = load_library("lrn_bwd")
    c = x.shape[-1]
    if c > lib.lrn_backward_max_channels():
        raise ValueError(
            f"{who} holds at most {lib.lrn_backward_max_channels()} "
            f"channels per row, got {c}")
    dx = torch.empty_like(x)
    _check_aligned(dx, who)
    rows = x.numel() // c if c else 0
    if rows == 0:
        return dx
    plan = _launch_plan(rows, c, x.element_size())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _bind(lib, name)(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), rows, c, size,
            alpha / size, beta, k, plan.tile_rows, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} (rows={rows}, C={c}, "
            f"size={size}, {plan})")
    if torch.cuda.is_current_stream_capturing():
        note_captured(name)  # recorded into a graph, launched by replays
    else:
        local_response_norm_backward_cuda.launches += 1
        local_response_norm_backward_cuda.launches_by_kernel[name] += 1
    return dx


local_response_norm_backward_cuda.launches = 0
local_response_norm_backward_cuda.launches_by_kernel = dict.fromkeys(
    BACKWARD_KERNEL_NAMES.values(), 0)

"""The greedy NMS sweep as a hand-written CUDA kernel (``csrc/nms.cu``).

The native piece of ``ops/nms.py``: the JAX ``nms_indices`` walks its K
candidates in a ``lax.fori_loop`` (stock XLA, not a TPU kernel), which
eager PyTorch would run as K dependent steps of a few launches each. The
kernel takes one block an image, computes the K x K kill bits in shared
memory and walks them with one warp. It is built with ``nvcc`` at first
use (``ops/_build.py``) and launched through ctypes on PyTorch's current
stream. Its plain version is ``ops/nms.nms_sweep_reference``, against
which it is held to identical alive masks.
"""

from __future__ import annotations

import ctypes

import torch

from deepvision_tpu_torch.ops import note_captured
from deepvision_tpu_torch.ops._build import load_library

__all__ = ["nms_sweep_cuda", "KERNEL_NAME"]

KERNEL_NAME = "nms_sweep_f32"


def _bind(lib: ctypes.CDLL):
    fn = lib.nms_sweep_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, ctypes.c_float, p]
        fn.restype = i
        lib.nms_max_k.restype = i
    return fn


def nms_sweep_cuda(boxes: torch.Tensor, alive: torch.Tensor,
                   iou_thresh: float) -> torch.Tensor:
    """``boxes (B, K, 4)`` float32 corners sorted by score and ``alive
    (B, K)`` bool seeds, contiguous CUDA tensors -> the alive mask after
    the greedy sweep, ``(B, K)`` bool.

    ``nms_sweep_cuda.launches`` counts kernel launches."""
    who = "nms_sweep_cuda"
    if boxes.device.type != "cuda" or alive.device != boxes.device:
        raise ValueError(f"{who} takes CUDA tensors on one card, got "
                         f"{boxes.device} and {alive.device}")
    if boxes.dtype != torch.float32 or alive.dtype != torch.bool:
        raise TypeError(f"{who} takes float32 boxes and bool seeds, got "
                        f"{boxes.dtype} and {alive.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 \
            or tuple(alive.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"{who} needs boxes (B, K, 4) and alive (B, K), "
                         f"got {tuple(boxes.shape)} and {tuple(alive.shape)}")
    if not (boxes.is_contiguous() and alive.is_contiguous()):
        raise ValueError(f"{who} needs contiguous tensors")
    if boxes.data_ptr() % 16:
        raise ValueError(f"{who} reads boxes as float4: the tensor must be "
                         f"16-byte aligned, got {boxes.data_ptr():#x}")
    lib = load_library("nms")
    fn = _bind(lib)
    b, k = alive.shape
    if k > lib.nms_max_k():
        raise ValueError(f"{who} holds at most {lib.nms_max_k()} candidates "
                         f"an image in shared memory, got {k}")
    out = torch.empty_like(alive)
    if out.numel() == 0:
        return out
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = fn(boxes.data_ptr(), alive.data_ptr(), out.data_ptr(), b, k,
                 iou_thresh, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: CUDA error {err} "
                           f"(images={b}, K={k})")
    if torch.cuda.is_current_stream_capturing():
        note_captured("nms_sweep")  # recorded into a graph, launched by replays
    else:
        nms_sweep_cuda.launches += 1
    return out


nms_sweep_cuda.launches = 0

"""On-device image normalization for uint8 wire transfer.

The twin of ``deepvision_tpu/ops/normalize.py``: host pipelines may ship
uint8 images (a quarter of float32's bytes over the host-to-device
link), and the train step normalizes on the device.
:func:`maybe_normalize` touches only uint8 batches, so float32 batches
(preprocessed on the host, like the synthetic set) pass through.
"""

from __future__ import annotations

import torch

__all__ = ["imagenet_normalize", "torch_normalize", "tanh_normalize",
           "maybe_normalize"]

IMAGENET_CHANNEL_MEANS = (123.68, 116.78, 103.94)
TORCH_CHANNEL_MEANS = (0.485, 0.456, 0.406)
TORCH_CHANNEL_STDS = (0.229, 0.224, 0.225)


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def imagenet_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32, channel means subtracted."""
    return images.float() - _const(IMAGENET_CHANNEL_MEANS, images)


def torch_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 ((x/255) - mean)/std, torchvision's."""
    x = images.float() / 255.0
    return ((x - _const(TORCH_CHANNEL_MEANS, images))
            / _const(TORCH_CHANNEL_STDS, images))


def tanh_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [-1,1]."""
    return images.float() / 127.5 - 1.0


def maybe_normalize(images: torch.Tensor, kind: str = "imagenet"):
    """Normalize on the device iff the batch arrived as uint8."""
    if kind not in ("imagenet", "tanh", "torch"):
        raise ValueError(f"unknown normalization kind {kind!r}")
    if images.dtype != torch.uint8:
        return images
    if kind == "imagenet":
        return imagenet_normalize(images)
    if kind == "torch":
        return torch_normalize(images)
    return tanh_normalize(images)

"""The uint8 wire's one quantization point, the twin of ``tf_wire_uint8``
in ``deepvision_tpu/data/image_io.py``.

Every reader that ships uint8 images over the host-to-device link goes
through :func:`wire_uint8`: round half to even (``tf.round``'s rule,
and ``torch.round``'s), then clip to [0, 255], then cast. The device-side
twins (``data/device_aug.py``'s re-rounding after jitter and mixup) use
the same expression, so every path quantizes alike.
"""

from __future__ import annotations

import torch

__all__ = ["wire_uint8"]


def wire_uint8(images: torch.Tensor) -> torch.Tensor:
    """float pixels in [0, 255] -> uint8: round half to even, clip,
    cast."""
    return torch.round(images).clamp_(0.0, 255.0).to(torch.uint8)

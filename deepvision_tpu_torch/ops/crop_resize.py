"""Crop and resize on the device, the glue between a pipeline's stages.

The twin of ``deepvision_tpu/ops/crop_resize.py``. A serving DAG
(``serve/pipeline.py``) composes models of different geometries: detect
at one input size, pose at another, with a box-conditioned crop between.
Every function here is fixed-shape tensor code on the batch's device, so
that the glue runs inside the DAG's CUDA graph and no intermediate
tensor goes back to the host. JAX computes these in stock XLA, not in a
TPU kernel, so the port uses ATen's gathers and ``F.interpolate``.

- :func:`crop_and_resize`: ``(B,H,W,C)`` images and ``(B,K,4)``
  normalized corner boxes -> ``(B,K,S,S,C)`` bilinear crops, sampled at
  the S pixel centres spanning each box by edge-clamped four-corner
  gathers. Boxes are clipped to [0, 1] first, so that the +/-inf corners
  of a saturated detector give no NaN; a degenerate box (NMS's zero
  padding rows) samples a constant patch, which the caller's ``valid``
  plane masks.
- :func:`resize_bilinear`: a whole-image resize, as
  ``jax.image.resize(method="bilinear")``, which antialiases when it
  shrinks (``antialias=True``; the reader's ``data/jpeg.resize_bilinear``
  is tf's, without, and differs at a shrink).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["crop_and_resize", "resize_bilinear"]


def crop_and_resize(images: torch.Tensor, boxes: torch.Tensor,
                    size: int) -> torch.Tensor:
    """``(B,H,W,C)`` images + ``(B,K,4)`` normalized ``(x1,y1,x2,y2)``
    corner boxes -> ``(B,K,S,S,C)`` bilinear crops (float32)."""
    images = images.float()
    b, h, w, _ = images.shape
    box = boxes.float().clamp(0.0, 1.0)
    x1, y1, x2, y2 = (box[..., i, None] for i in range(4))  # (B,K,1)
    # pixel-centre sample coordinates in source-pixel space, computed as
    # JAX does, one rounding an operation
    frac = (torch.arange(size, dtype=torch.float32, device=images.device)
            + 0.5) / size
    fy = (y1 + (y2 - y1) * frac) * h - 0.5  # (B,K,S)
    fx = (x1 + (x2 - x1) * frac) * w - 0.5
    y0 = torch.floor(fy)
    x0 = torch.floor(fx)
    wy = (fy - y0)[..., :, None, None]  # (B,K,S,1,1)
    wx = (fx - x0)[..., None, :, None]  # (B,K,1,S,1)
    y0i = y0.to(torch.int64).clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x0i = x0.to(torch.int64).clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    bi = torch.arange(b, device=images.device)[:, None, None, None]

    def corner(rows, cols):  # -> (B,K,S,S,C)
        return images[bi, rows[..., :, None], cols[..., None, :]]

    top = corner(y0i, x0i) * (1 - wx) + corner(y0i, x1i) * wx
    bot = corner(y1i, x0i) * (1 - wx) + corner(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """``(B,H,W,C)`` -> ``(B,size,size,C)`` bilinear resize (float32),
    antialiased when it shrinks, as ``jax.image.resize``."""
    x = images.float().permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).contiguous()

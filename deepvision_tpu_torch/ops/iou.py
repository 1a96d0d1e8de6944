"""Box coordinate conversions, broadcast IoU and the clipped BCE.

The twins of ``deepvision_tpu/ops/iou.py``, op for op in float32: the
NMS sweep kernel (``csrc/nms.cu``) computes :func:`broadcast_iou` with
the same operations in the same order, so that both give the same bits
at the threshold (trap C18). ``torch.maximum``, ``torch.minimum`` and
``clamp`` propagate NaN as ``jnp.maximum`` and ``jnp.clip`` do, so a box
that overflowed to inf gives the JAX function's NaN and inf.
"""

from __future__ import annotations

import torch

__all__ = ["xywh_to_corners", "corners_to_xywh", "broadcast_iou",
           "binary_cross_entropy"]


def xywh_to_corners(xywh: torch.Tensor) -> torch.Tensor:
    """``[..., (cx, cy, w, h)] -> [..., (x1, y1, x2, y2)]``."""
    xy, wh = xywh[..., :2], xywh[..., 2:4]
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)


def corners_to_xywh(corners: torch.Tensor) -> torch.Tensor:
    p1, p2 = corners[..., :2], corners[..., 2:4]
    return torch.cat([(p1 + p2) / 2, p2 - p1], dim=-1)


def broadcast_iou(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """IoU of every a-box against every b-box: ``(..., A, 4)`` and
    ``(..., B, 4)`` corners -> ``(..., A, B)``; the union floored at
    1e-9."""
    a = box_a[..., :, None, :]
    b = box_b[..., None, :, :]
    inter_lo = torch.maximum(a[..., :2], b[..., :2])
    inter_hi = torch.minimum(a[..., 2:4], b[..., 2:4])
    inter_wh = (inter_hi - inter_lo).clamp(min=0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0.0) * (
        a[..., 3] - a[..., 1]).clamp(min=0.0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0.0) * (
        b[..., 3] - b[..., 1]).clamp(min=0.0)
    return inter / (area_a + area_b - inter).clamp(min=1e-9)


def binary_cross_entropy(pred_prob: torch.Tensor, labels: torch.Tensor, *,
                         eps: float = 1e-7) -> torch.Tensor:
    """Elementwise BCE on probabilities clipped to ``[eps, 1 - eps]``."""
    p = pred_prob.clamp(eps, 1.0 - eps)
    return -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))

"""CenterNet peak decoding, heatmaps to the top-K detections: the twin of
``deepvision_tpu/ops/centernet_decode.py``.

The class scores are the heatmap logits' sigmoid; a 3x3 stride-1 max
pool (padded with -inf, XLA's SAME window) keeps the local maxima, and
every other score becomes 0. The K best of the ``(B, G·G·C)`` scores,
flattened in NHWC order, give the classes and cells, whose sizes and
offsets are gathered.

``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk``
promises no order on CUDA. Ties are the rule here: the zeroed non-peaks
tie at exactly 0.0 whenever an image has fewer than K peaks, and a
saturated head ties at 1.0 (trap C20). So the K best are taken by a
stable descending sort, as ``ops/nms.nms_prefilter`` takes them (trap
C17).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["peak_scores", "decode_centernet"]


def peak_scores(heatmap_logits: torch.Tensor) -> torch.Tensor:
    """``(B, G, G, C)`` logits -> float32 scores, zero except at the
    maxima of their 3x3 window."""
    scores = torch.sigmoid(heatmap_logits.float())
    pooled = F.max_pool2d(scores.permute(0, 3, 1, 2), 3, 1, 1).permute(
        0, 2, 3, 1)
    return torch.where(scores == pooled, scores, torch.zeros_like(scores))


def decode_centernet(heatmap_logits: torch.Tensor, wh: torch.Tensor,
                     offset: torch.Tensor, *, top_k: int = 100) -> dict:
    """``(B, G, G, C)`` logits, ``(B, G, G, 2)`` sizes and offsets ->
    ``{"boxes" (B, K, 4) normalized xywh, "scores" (B, K), "classes"
    (B, K) int32}`` by descending score, equal scores in index order."""
    b, g, _, c = heatmap_logits.shape
    flat = peak_scores(heatmap_logits).reshape(b, -1)
    top_scores, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :top_k], idx[:, :top_k]
    cls = (idx % c).to(torch.int32)
    cell = idx // c
    cy, cx = cell // g, cell % g
    image = torch.arange(b, device=idx.device)[:, None]
    off = offset[image, cy, cx].float()  # (B, K, 2) = (dx, dy)
    sizes = wh[image, cy, cx].float()  # (B, K, 2) = (w, h) in cells
    x = (cx.float() + off[..., 0]) / g
    y = (cy.float() + off[..., 1]) / g
    boxes = torch.stack([x, y, sizes[..., 0] / g, sizes[..., 1] / g], dim=-1)
    return {"boxes": boxes, "scores": top_scores, "classes": cls}

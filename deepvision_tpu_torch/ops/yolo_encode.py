"""YOLO v3 ground-truth grids, encoded inside the train step: the twin of
``deepvision_tpu/ops/yolo_encode.py``.

Padded boxes ``(B, M, 4)`` (xywh normalized, zero rows for padding) and
labels ``(B, M)`` (-1 for padding) become three grids ``(B, S, S, 3, 5 +
C)`` of ``(x, y, w, h, 1, one-hot class)``, each box in the cell of its
centre and the anchor of its scale that it overlaps best (centred wh-IoU
against the 9 anchors, which are the reference's pixels over 416).

The JAX encoder scatters the rows with ``mode="drop"`` and sends padding
rows out of range. torch keeps no such rows, so padding rows are masked
out instead. Two boxes can share a (cell, anchor) slot; XLA's scatter
then keeps the last in index order, while ``index_put_`` with repeated
indices leaves the winner undefined on CUDA (trap C16). So each slot's
owner is chosen explicitly, the largest box index by
``scatter_reduce(amax)``, and its features are gathered once.
"""

from __future__ import annotations

import numpy as np
import torch

from deepvision_tpu_torch.ops.yolo_decode import anchor_tensor

__all__ = ["ANCHORS_WH", "GRID_SIZES", "MAX_BOXES", "best_anchor",
           "encode_labels"]

# (w, h) / 416, the reference's anchors
ANCHORS_WH = (
    np.array(
        [[10, 13], [16, 30], [33, 23], [30, 61], [62, 45], [59, 119],
         [116, 90], [156, 198], [373, 326]],
        np.float32,
    )
    / 416.0
)
GRID_SIZES = (52, 26, 13)  # scale 0 = small boxes ... 2 = large
MAX_BOXES = 100  # the true-box cap


def best_anchor(wh: torch.Tensor) -> torch.Tensor:
    """``wh (..., 2)`` normalized -> the best of the 9 anchors by centred
    IoU (the first on a tie)."""
    anchors = anchor_tensor(ANCHORS_WH, wh)
    inter = torch.minimum(wh[..., None, 0], anchors[:, 0]) * torch.minimum(
        wh[..., None, 1], anchors[:, 1])
    union = (wh[..., None, 0] * wh[..., None, 1]
             + anchors[:, 0] * anchors[:, 1] - inter)
    return torch.argmax(inter / union.clamp(min=1e-9), dim=-1)


@torch.no_grad()
def encode_labels(boxes: torch.Tensor, labels: torch.Tensor,
                  num_classes: int, *, grid_sizes=GRID_SIZES):
    """``boxes (B, M, 4)``, ``labels (B, M)`` -> a tuple of 3 grids
    ``(B, S, S, 3, 5 + num_classes)`` in the boxes' dtype."""
    b, m, _ = boxes.shape
    dev = boxes.device
    anchor_idx = best_anchor(boxes[..., 2:4])  # (B, M) in [0, 9)
    scale_idx = anchor_idx // 3
    within = anchor_idx % 3
    valid = labels >= 0
    onehot = torch.nn.functional.one_hot(
        labels.long().clamp(min=0), num_classes).to(boxes.dtype)
    features = torch.cat(
        [boxes, torch.ones((b, m, 1), dtype=boxes.dtype, device=dev),
         onehot], dim=-1)  # (B, M, 5 + C)
    rows = torch.arange(m, device=dev).expand(b, m)
    image = torch.arange(b, device=dev)[:, None]

    outputs = []
    for s, size in enumerate(grid_sizes):
        cell_x = torch.floor(boxes[..., 0] * size).long().clamp(0, size - 1)
        cell_y = torch.floor(boxes[..., 1] * size).long().clamp(0, size - 1)
        on_scale = valid & (scale_idx == s)
        slot = ((image * size + cell_y) * size + cell_x) * 3 + within
        # each slot's owner: the last box in index order (-1: none)
        owner = torch.full((b * size * size * 3,), -1, dtype=torch.long,
                           device=dev)
        owner.scatter_reduce_(0, slot.reshape(-1),
                              torch.where(on_scale, rows, -1).reshape(-1),
                              reduce="amax")
        slot_image = torch.arange(owner.numel(), device=dev) // (
            size * size * 3)
        grid = features[slot_image, owner.clamp(min=0)]
        grid = torch.where((owner >= 0)[:, None], grid,
                           torch.zeros_like(grid))
        outputs.append(grid.reshape(b, size, size, 3, -1))
    return tuple(outputs)

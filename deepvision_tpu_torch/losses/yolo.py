"""The YOLO v3 loss over three scales, the twin of
``deepvision_tpu/losses/yolo.py``; all of it in float32.

- xy and wh: squared error on cell-relative coordinates over the cells
  that hold a box, weighted by ``2 - w·h`` and by lambda_coord = 5;
- class: elementwise BCE on the sigmoid probabilities, object cells
  only;
- objectness: BCE over object cells, plus lambda_noobj = 0.5 times the
  BCE over the other cells whose predicted box overlaps no true box at
  IoU 0.5 or more (the ignore mask, against the padded true boxes of the
  batch, whose zero rows overlap nothing).

Each component is a per-image sum, ``(B,)``; the train step takes the
batch mean and the eval step mask-weighted sums. The ignore mask is a
comparison, which carries no gradient, so it is computed without
recording one.
"""

from __future__ import annotations

import torch

from deepvision_tpu_torch.ops.iou import (
    binary_cross_entropy,
    broadcast_iou,
    xywh_to_corners,
)
from deepvision_tpu_torch.ops.yolo_decode import (
    decode_absolute,
    encode_relative,
)
from deepvision_tpu_torch.ops.yolo_encode import ANCHORS_WH

__all__ = ["LAMBDA_COORD", "LAMBDA_NOOBJ", "IGNORE_THRESH",
           "yolo_scale_loss", "yolo_loss"]

LAMBDA_COORD = 5.0
LAMBDA_NOOBJ = 0.5
IGNORE_THRESH = 0.5
ANCHOR_GROUPS = (ANCHORS_WH[0:3], ANCHORS_WH[3:6], ANCHORS_WH[6:9])

_CELLS = (1, 2, 3)  # the grid's S, S and anchor axes


def yolo_scale_loss(y_true: torch.Tensor, y_pred: torch.Tensor, anchors_wh,
                    num_classes: int,
                    true_boxes_xywh: torch.Tensor | None = None) -> dict:
    """The loss of one scale: ``y_true`` from ``encode_labels``,
    ``y_pred`` the raw grid, both ``(B, S, S, 3, 5 + C)``;
    ``true_boxes_xywh`` ``(B, M, 4)`` the padded true boxes for the
    ignore mask (default: every cell of ``y_true``). -> per-image ``(B,)``
    ``loss``, ``xy``, ``wh``, ``class`` and ``obj``."""
    y_pred = y_pred.float()
    y_true = y_true.float()

    pred_xy_rel = torch.sigmoid(y_pred[..., 0:2])
    pred_wh_rel = y_pred[..., 2:4]
    pred_box_abs, pred_obj, pred_class = decode_absolute(
        y_pred, anchors_wh, num_classes)

    true_wh = y_true[..., 2:4]
    true_obj = y_true[..., 4]
    true_class = y_true[..., 5:]
    true_rel = encode_relative(y_true[..., 0:4], anchors_wh)

    weight = 2.0 - true_wh[..., 0] * true_wh[..., 1]
    xy_loss = torch.square(true_rel[..., 0:2] - pred_xy_rel).sum(-1)
    xy_loss = LAMBDA_COORD * (true_obj * weight * xy_loss).sum(_CELLS)
    wh_loss = torch.square(true_rel[..., 2:4] - pred_wh_rel).sum(-1)
    wh_loss = LAMBDA_COORD * (true_obj * weight * wh_loss).sum(_CELLS)

    class_loss = binary_cross_entropy(pred_class, true_class).sum(-1)
    class_loss = (true_obj * class_loss).sum(_CELLS)

    b = y_pred.shape[0]
    with torch.no_grad():
        if true_boxes_xywh is None:
            true_boxes_xywh = y_true[..., 0:4].reshape(b, -1, 4)
        true_corners = xywh_to_corners(true_boxes_xywh.float())
        pred_corners = xywh_to_corners(pred_box_abs.detach()).reshape(
            b, -1, 4)
        best_iou = broadcast_iou(pred_corners, true_corners).amax(-1)
        ignore = (best_iou.reshape(true_obj.shape) < IGNORE_THRESH).float()

    obj_entropy = binary_cross_entropy(pred_obj[..., 0], true_obj)
    obj_part = (true_obj * obj_entropy).sum(_CELLS)
    noobj_part = LAMBDA_NOOBJ * (
        (1.0 - true_obj) * obj_entropy * ignore).sum(_CELLS)
    obj_loss = obj_part + noobj_part

    total = xy_loss + wh_loss + class_loss + obj_loss
    return {"loss": total, "xy": xy_loss, "wh": wh_loss,
            "class": class_loss, "obj": obj_loss}


def yolo_loss(y_true_grids, y_pred_grids, num_classes: int,
              true_boxes_xywh: torch.Tensor | None = None) -> dict:
    """Per-image ``(B,)`` components summed over the three scales, each
    scale with its anchor triple."""
    totals = None
    for y_true, y_pred, anchors in zip(y_true_grids, y_pred_grids,
                                       ANCHOR_GROUPS):
        part = yolo_scale_loss(y_true, y_pred, anchors, num_classes,
                               true_boxes_xywh)
        totals = part if totals is None else {
            k: totals[k] + part[k] for k in totals}
    return totals

"""YOLO v3 inference post-process: decode the three scales, then batched
NMS; the twin of ``deepvision_tpu/ops/yolo_postprocess.py``.

The three decoded scales are concatenated (N = 3 · (52² + 26² + 13²) =
10,647 boxes at 416), scored by objectness, classed by the argmax class
probability (the first on a tie), and suppressed by
``ops/nms.batched_nms``, whose greedy sweep runs on the CUDA kernel for
tensors on the card.
"""

from __future__ import annotations

import torch

from deepvision_tpu_torch.losses.yolo import ANCHOR_GROUPS
from deepvision_tpu_torch.ops.iou import xywh_to_corners
from deepvision_tpu_torch.ops.nms import batched_nms
from deepvision_tpu_torch.ops.yolo_decode import decode_absolute

__all__ = ["yolo_candidates", "yolo_postprocess"]


def yolo_candidates(pred_grids, num_classes: int):
    """Raw grids (three ``(B, S, S, 3, 5 + C)``) -> every scale's boxes
    concatenated: corners ``(B, N, 4)``, objectness scores ``(B, N)``,
    argmax classes ``(B, N)`` int32."""
    boxes, scores, classes = [], [], []
    for y_pred, anchors in zip(pred_grids, ANCHOR_GROUPS):
        b_xywh, obj, cls = decode_absolute(y_pred, anchors, num_classes)
        b = b_xywh.shape[0]
        boxes.append(xywh_to_corners(b_xywh).reshape(b, -1, 4))
        scores.append(obj.reshape(b, -1))
        classes.append(torch.argmax(cls, dim=-1).reshape(b, -1))
    return (torch.cat(boxes, dim=1), torch.cat(scores, dim=1),
            torch.cat(classes, dim=1).to(torch.int32))


def yolo_postprocess(pred_grids, num_classes: int, *,
                     iou_thresh: float = 0.5, score_thresh: float = 0.5,
                     max_out: int = 100, sweep=None):
    """Raw grids (three ``(B, S, S, 3, 5 + C)``) -> (boxes ``(B, K, 4)``
    corners, scores ``(B, K)``, classes ``(B, K)`` int32, valid ``(B,
    K)``, n_candidates ``(B,)``) with K = ``max_out``; ``sweep`` as in
    ``batched_nms``."""
    return batched_nms(*yolo_candidates(pred_grids, num_classes),
                       iou_thresh=iou_thresh, score_thresh=score_thresh,
                       max_out=max_out, sweep=sweep)

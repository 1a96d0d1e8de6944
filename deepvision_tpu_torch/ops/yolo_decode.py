"""YOLO grid <-> absolute box transforms, the twins of
``deepvision_tpu/ops/yolo_decode.py``.

Grids are ``(..., S, S, 3, 5 + C)``: axis -4 indexes rows (y), axis -3
columns (x), and a cell's offset is ``(x, y)``.

- absolute: ``b_xy = (sigmoid(t_xy) + cell) / S``, ``b_wh = exp(t_wh) ·
  anchor``, sigmoid objectness and classes;
- relative (the inverse, for the loss): ``t_xy = b_xy · S - cell``,
  ``t_wh = log(max(b_wh / anchor, 1e-12))``, zero where the ratio is not
  positive (an empty cell).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["decode_absolute", "encode_relative", "anchor_tensor"]


def _cell_offsets(size: int, device=None) -> torch.Tensor:
    """``(S, S, 1, 2)`` float32 where ``[y, x, 0] = (x, y)``."""
    r = torch.arange(size, device=device)
    cx, cy = torch.meshgrid(r, r, indexing="xy")
    return torch.stack([cx, cy], dim=-1)[:, :, None, :].float()


@functools.lru_cache(maxsize=None)
def _anchor_tensor(values: tuple, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    # a normal tensor even when first made under inference_mode (a
    # served batch), so that a train step can save it for backward
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def anchor_tensor(anchors_wh, like: torch.Tensor) -> torch.Tensor:
    """``anchors_wh`` (numpy) as a tensor in ``like``'s dtype on its
    device, made once a device: a host-to-device copy of a pageable
    array waits for the host, and the train step makes none."""
    from torch._subclasses.fake_tensor import FakeTensor

    values = tuple(map(tuple, np.asarray(anchors_wh, np.float32).tolist()))
    if torch.compiler.is_compiling() or isinstance(like, FakeTensor):
        # under torch.export, or a pipeline's shape propagation
        # (``serve/pipeline.py``), ``like`` is a fake tensor: the anchors
        # are a constant of the traced program, and a fake one must never
        # reach the cache that eager calls read
        return torch.tensor(values, dtype=like.dtype, device=like.device)
    return _anchor_tensor(values, like.dtype, like.device)


def decode_absolute(y_pred: torch.Tensor, anchors_wh, num_classes: int):
    """Raw grid ``(B, S, S, 3, 5 + C)`` -> ``(boxes_xywh, objectness,
    classes)``: boxes normalized to the image, objectness ``(..., 1)``
    and classes ``(..., C)`` as sigmoid probabilities."""
    del num_classes  # the grid's width says it
    size = y_pred.shape[-4]
    t_xy = y_pred[..., 0:2]
    t_wh = y_pred[..., 2:4]
    objectness = torch.sigmoid(y_pred[..., 4:5])
    classes = torch.sigmoid(y_pred[..., 5:])
    b_xy = (torch.sigmoid(t_xy) + _cell_offsets(size, y_pred.device)) / size
    b_wh = torch.exp(t_wh) * anchor_tensor(anchors_wh, y_pred)
    return torch.cat([b_xy, b_wh], dim=-1), objectness, classes


def encode_relative(true_xywh: torch.Tensor, anchors_wh) -> torch.Tensor:
    """Absolute grid targets ``(B, S, S, 3, 4)`` -> cell-relative
    ``(t_xy, t_wh)``; cells without a box (wh = 0) give zeros."""
    size = true_xywh.shape[-4]
    t_xy = true_xywh[..., 0:2] * size - _cell_offsets(size, true_xywh.device)
    ratio = true_xywh[..., 2:4] / anchor_tensor(anchors_wh, true_xywh)
    t_wh = torch.log(ratio.clamp(min=1e-12))
    t_wh = torch.where(ratio > 0, t_wh, torch.zeros_like(t_wh))
    return torch.cat([t_xy.to(t_wh.dtype), t_wh], dim=-1)

"""The CenterNet losses, the twin of ``deepvision_tpu/losses/centernet.py``;
all of it in float32.

- the penalty-reduced pixelwise focal loss on the class heatmaps (alpha
  2, beta 4, the probabilities clipped to [EPS, 1 - EPS]), normalized by
  each image's count of positives (target peaks equal to 1), at least 1;
- L1 on the centre offsets (lambda_off 1) and on the box sizes in cells
  (lambda_size 0.1) at the centre cells, normalized by each image's
  count of objects, at least 1;

summed over the stacks (intermediate supervision). With ``per_sample``
each part is per image ``(B,)`` (the eval step's mask-weighted sums),
else the batch mean.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["ALPHA", "BETA", "LAMBDA_SIZE", "LAMBDA_OFF", "EPS",
           "centernet_focal_loss", "masked_l1", "centernet_loss"]

ALPHA = 2.0
BETA = 4.0
LAMBDA_SIZE = 0.1
LAMBDA_OFF = 1.0
EPS = 1e-6


def centernet_focal_loss(heatmap_logits: torch.Tensor, target: torch.Tensor,
                         *, per_sample: bool = False) -> torch.Tensor:
    """The penalty-reduced focal loss; target peaks (``>= 1``) are the
    positives."""
    p = torch.clamp(torch.sigmoid(heatmap_logits), EPS, 1.0 - EPS)
    pos = (target >= 1.0).float()
    neg = 1.0 - pos
    pos_term = -pos * ((1 - p) ** ALPHA) * torch.log(p)
    neg_term = -neg * ((1 - target) ** BETA) * (p ** ALPHA) * torch.log(1 - p)
    dims = tuple(range(1, heatmap_logits.ndim))
    n_pos = torch.clamp(pos.sum(dims), min=1.0)
    loss = (pos_term.sum(dims) + neg_term.sum(dims)) / n_pos
    return loss if per_sample else loss.mean()


def masked_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """The mean over objects of the L1 at the centre cells, per image:
    ``pred`` and ``target`` ``(B, G, G, 2)``, ``mask (B, G, G)``."""
    dims = tuple(range(1, mask.ndim))
    n = torch.clamp(mask.sum(dims), min=1.0)
    err = ((pred - target).abs() * mask[..., None]).sum(dims + (mask.ndim,))
    return err / n


def centernet_loss(targets: dict, outputs: Sequence[tuple], *,
                   per_sample: bool = False) -> dict:
    """``targets`` from ``ops/centernet_encode``; ``outputs``: per stack
    ``(heatmap logits, wh, offset)`` -> ``{"loss", "heatmap_loss",
    "wh_loss", "offset_loss"}``."""
    total = heat_l = wh_l = off_l = 0.0
    for heat, wh, off in outputs:
        hl = centernet_focal_loss(heat.float(), targets["heatmap"],
                                  per_sample=True)
        wl = masked_l1(wh.float(), targets["wh"], targets["mask"])
        ol = masked_l1(off.float(), targets["offset"], targets["mask"])
        heat_l = heat_l + hl
        wh_l = wh_l + wl
        off_l = off_l + ol
        total = total + hl + LAMBDA_SIZE * wl + LAMBDA_OFF * ol
    parts = {"loss": total, "heatmap_loss": heat_l, "wh_loss": wh_l,
             "offset_loss": off_l}
    if per_sample:
        return parts
    return {k: v.mean() for k, v in parts.items()}

"""The pose heatmap loss, the twin of ``deepvision_tpu/losses/pose.py``:
the mean squared error against the targets with the foreground (target
above 0) weighted by 81 + 1, summed over the stacks' outputs
(intermediate supervision), in float32."""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["FOREGROUND_WEIGHT", "weighted_heatmap_mse"]

FOREGROUND_WEIGHT = 81.0


def weighted_heatmap_mse(targets: torch.Tensor,
                         outputs: Sequence[torch.Tensor] | torch.Tensor, *,
                         per_sample: bool = False) -> torch.Tensor:
    """``targets (B, H, W, K)``; ``outputs`` one ``(B, H, W, K)`` a
    stack. The per-image loss ``(B,)`` with ``per_sample``, else its
    batch mean."""
    if not isinstance(outputs, (tuple, list)):
        outputs = (outputs,)
    targets = targets.float()
    weights = (targets > 0).float() * FOREGROUND_WEIGHT + 1.0
    total = 0.0
    for out in outputs:
        sq = (targets - out.float()) ** 2 * weights
        total = total + sq.mean(dim=(1, 2, 3))
    return total if per_sample else total.mean()

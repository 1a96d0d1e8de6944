"""Classification loss and top-k metrics.

The twin of ``deepvision_tpu/losses/classification.py``: integer labels
and logits, cross-entropy in float32 with optional label smoothing
(``(1 - e)·onehot + e/C``, optax's ``smooth_labels`` and torch's
``label_smoothing`` alike), and top-k by strict rank: the true class is a
hit iff fewer than k classes score strictly higher, so ties count as
hits (``torch.topk`` would break them by index instead).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["softmax_cross_entropy_per_sample", "softmax_cross_entropy",
           "topk_correct", "topk_accuracy"]


def softmax_cross_entropy_per_sample(logits: torch.Tensor,
                                     labels: torch.Tensor, *,
                                     label_smoothing: float = 0.0
                                     ) -> torch.Tensor:
    """Per-sample CE losses ``(B,)``; ``labels`` are integer class ids."""
    return F.cross_entropy(logits.float(), labels.long(), reduction="none",
                           label_smoothing=label_smoothing)


def softmax_cross_entropy(logits, labels, *, label_smoothing: float = 0.0):
    """Mean CE over the batch."""
    return softmax_cross_entropy_per_sample(
        logits, labels, label_smoothing=label_smoothing).mean()


def topk_correct(logits: torch.Tensor, labels: torch.Tensor,
                 ks=(1, 5)) -> dict[str, torch.Tensor]:
    """Per-sample top-k hit indicators ``(B,)`` float32, by strict rank."""
    logits = logits.float()
    target = logits.gather(-1, labels.long()[:, None])
    rank = (logits > target).sum(-1)
    return {f"top{k}": (rank < k).float() for k in ks}


def topk_accuracy(logits, labels, ks=(1, 5)) -> dict[str, torch.Tensor]:
    """Top-k accuracies (fractions in [0, 1]) as 0-d tensors."""
    return {k: v.mean() for k, v in topk_correct(logits, labels, ks).items()}

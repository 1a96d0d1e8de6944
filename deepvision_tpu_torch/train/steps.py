"""The classification, YOLO, CenterNet and pose train and eval steps.

The twins of ``classification_train_step``,
``classification_eval_step``, ``yolo_train_step``, ``yolo_eval_step``,
``centernet_train_step``, ``centernet_eval_step``, ``pose_train_step``,
``pose_eval_step`` and ``aggregate_eval_parts`` in
``deepvision_tpu/train/steps.py``. The detection and pose steps encode
their targets on the device, inside the step, from the batch's boxes or
keypoints, and wait for nothing on the host. A train step updates the
:class:`~deepvision_tpu_torch.train.state.TrainState` in place and
returns its metrics as device tensors, so that the caller decides when
to wait for them.
"""

from __future__ import annotations

from typing import Iterable

import torch

from deepvision_tpu_torch.core.precision import precision_metrics
from deepvision_tpu_torch.losses.classification import (
    softmax_cross_entropy,
    softmax_cross_entropy_per_sample,
    topk_accuracy,
    topk_correct,
)
from deepvision_tpu_torch.ops.normalize import maybe_normalize
from deepvision_tpu_torch.train.state import TrainState

__all__ = ["classification_train_step", "classification_eval_step",
           "yolo_train_step", "yolo_eval_step", "centernet_train_step",
           "centernet_eval_step", "pose_train_step", "pose_eval_step",
           "aggregate_eval_parts"]


def _eval_mask(batch: dict, images: torch.Tensor) -> torch.Tensor:
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(images.shape[0], device=images.device)
    return mask


def classification_train_step(state: TrainState, batch: dict,
                              generator: torch.Generator,
                              normalize_kind: str = "imagenet") -> dict:
    """One SGD step on ``{"image", "label"}`` device tensors, dropout
    masks from ``generator``; returns the metrics (0-d device tensors).

    ``normalize_kind`` is the uint8 wire's normalization (``"torch"`` for
    configs with ``augment: "pt"``). With ``label_b`` and ``lam`` in the
    batch the loss is mixup's convex pair ``lam·CE(y) + (1-lam)·CE(y_b)``;
    top-k stays against ``label``. The module runs in training mode: BN
    normalizes by the batch and updates its running statistics, as
    flax's ``mutable=["batch_stats"]`` returns them. A model that
    returns a tuple adds its auxiliary heads' losses at 0.3. The backward
    runs on the loss scaled by the state's loss scale; the metrics carry
    the raw loss."""
    images = maybe_normalize(batch["image"], normalize_kind)
    labels = batch["label"]
    labels_b, lam = batch.get("label_b"), batch.get("lam")

    def mixed_ce(logits):
        loss = softmax_cross_entropy(logits, labels)
        if labels_b is None:
            return loss
        return lam * loss + (1.0 - lam) * softmax_cross_entropy(
            logits, labels_b)

    state.optimizer.zero_grad(set_to_none=True)
    batch_stats = state.copy_batch_stats()  # the forward updates them
    out = state.module(images, train=True, generator=generator)
    if isinstance(out, (tuple, list)):
        logits, *aux = out
        loss = mixed_ce(logits)
        for a in aux:
            loss = loss + 0.3 * mixed_ce(a)
    else:
        logits = out
        loss = mixed_ce(logits)
    state.scale_loss(loss).backward()
    state.apply_gradients(batch_stats)
    return {"loss": loss.detach(), **topk_accuracy(logits.detach(), labels),
            **precision_metrics(state)}


@torch.no_grad()
def classification_eval_step(state: TrainState, batch: dict,
                             normalize_kind: str = "imagenet") -> dict:
    """Count-weighted sums over one batch (0-d device tensors), BN on
    its running statistics; ``batch["mask"]`` (optional, 1/0 a row)
    drops padding rows."""
    images = maybe_normalize(batch["image"], normalize_kind)
    labels = batch["label"]
    mask = _eval_mask(batch, images)
    logits = state.module(images, train=False)
    if isinstance(logits, (tuple, list)):
        logits = logits[0]
    losses = softmax_cross_entropy_per_sample(logits, labels)
    correct = topk_correct(logits, labels)
    return {"loss_sum": (losses * mask).sum(), "count": mask.sum(),
            **{k: (v * mask).sum() for k, v in correct.items()}}


def _grid_sizes(images: torch.Tensor) -> tuple[int, int, int]:
    size = images.shape[1]
    return size // 8, size // 16, size // 32


def yolo_train_step(state: TrainState, batch: dict,
                    generator: torch.Generator) -> dict:
    """One detection step on ``{"image", "boxes", "label"}``: ``boxes``
    ``(B, M, 4)`` xywh normalized with zero padding rows, ``label`` ``(B,
    M)`` with -1 padding. The images normalize as ``"tanh"`` (uint8 to
    [-1, 1]); the grids are encoded inside the step
    (``ops/yolo_encode``), never on the host; the loss is the batch mean
    of ``yolo_loss``'s per-image sums. Returns ``loss``, ``xy``, ``wh``,
    ``class`` and ``obj`` (batch means) and the precision metrics."""
    from deepvision_tpu_torch.losses.yolo import yolo_loss
    from deepvision_tpu_torch.ops.yolo_encode import encode_labels

    del generator  # YOLO v3 draws no random numbers in the step
    images = maybe_normalize(batch["image"], "tanh")
    boxes, labels = batch["boxes"], batch["label"]
    state.optimizer.zero_grad(set_to_none=True)
    batch_stats = state.copy_batch_stats()
    preds = state.module(images, train=True)
    num_classes = preds[0].shape[-1] - 5
    y_true = encode_labels(boxes, labels, num_classes,
                           grid_sizes=_grid_sizes(images))
    parts = yolo_loss(y_true, preds, num_classes, true_boxes_xywh=boxes)
    loss = parts["loss"].mean()
    state.scale_loss(loss).backward()
    state.apply_gradients(batch_stats)
    return {**{k: v.detach().mean() for k, v in parts.items()},
            **precision_metrics(state)}


@torch.no_grad()
def yolo_eval_step(state: TrainState, batch: dict) -> dict:
    """The mask-weighted validation-loss sum and count (0-d device
    tensors) of one batch, BN on its running statistics."""
    from deepvision_tpu_torch.losses.yolo import yolo_loss
    from deepvision_tpu_torch.ops.yolo_encode import encode_labels

    images = maybe_normalize(batch["image"], "tanh")
    boxes, labels = batch["boxes"], batch["label"]
    mask = _eval_mask(batch, images)
    preds = state.module(images, train=False)
    num_classes = preds[0].shape[-1] - 5
    y_true = encode_labels(boxes, labels, num_classes,
                           grid_sizes=_grid_sizes(images))
    parts = yolo_loss(y_true, preds, num_classes, true_boxes_xywh=boxes)
    return {"loss_sum": (parts["loss"] * mask).sum(), "count": mask.sum()}


def _centernet_parts(module, images, batch, train, per_sample=False):
    from deepvision_tpu_torch.losses.centernet import centernet_loss
    from deepvision_tpu_torch.ops.centernet_encode import encode_centernet

    outputs = module(images, train=train)
    targets = encode_centernet(batch["boxes"], batch["label"],
                               outputs[0][0].shape[-1],
                               images.shape[1] // 4)  # output stride 4
    return centernet_loss(targets, outputs, per_sample=per_sample)


def centernet_train_step(state: TrainState, batch: dict,
                         generator: torch.Generator) -> dict:
    """One CenterNet step on the detection batch (``image``, ``boxes``,
    ``label``, as :func:`yolo_train_step` takes it): the images
    normalize as ``"tanh"``, the targets are encoded on the output grid
    (a quarter of the input) inside the step (``ops/centernet_encode``),
    and the loss is the focal and L1 losses summed over the stacks
    (``losses/centernet``). Returns ``loss``, ``heatmap_loss``,
    ``wh_loss`` and ``offset_loss`` (batch means) and the precision
    metrics."""
    del generator  # CenterNet draws no random numbers in the step
    images = maybe_normalize(batch["image"], "tanh")
    state.optimizer.zero_grad(set_to_none=True)
    batch_stats = state.copy_batch_stats()
    parts = _centernet_parts(state.module, images, batch, train=True)
    state.scale_loss(parts["loss"]).backward()
    state.apply_gradients(batch_stats)
    return {**{k: v.detach() for k, v in parts.items()},
            **precision_metrics(state)}


@torch.no_grad()
def centernet_eval_step(state: TrainState, batch: dict) -> dict:
    """The mask-weighted validation-loss sum and count of one batch, BN
    on its running statistics."""
    images = maybe_normalize(batch["image"], "tanh")
    mask = _eval_mask(batch, images)
    parts = _centernet_parts(state.module, images, batch, train=False,
                             per_sample=True)
    return {"loss_sum": (parts["loss"] * mask).sum(), "count": mask.sum()}


def _pose_loss(module, images, batch, train, per_sample=False):
    from deepvision_tpu_torch.losses.pose import weighted_heatmap_mse
    from deepvision_tpu_torch.ops.heatmap import gaussian_heatmaps

    grid = images.shape[1] // 4  # the stem's stride
    targets = gaussian_heatmaps(batch["kx"], batch["ky"], batch["v"],
                                height=grid, width=grid)
    return weighted_heatmap_mse(targets, module(images, train=train),
                                per_sample=per_sample)


def pose_train_step(state: TrainState, batch: dict,
                    generator: torch.Generator) -> dict:
    """One pose step on ``{"image", "kx", "ky", "v"}``: the Gaussian
    heatmap targets are rasterized inside the step (``ops/heatmap``) and
    the loss is the foreground-weighted MSE summed over the stacks
    (``losses/pose``). Returns ``loss`` and the precision metrics."""
    del generator  # the hourglass draws no random numbers
    images = maybe_normalize(batch["image"], "tanh")
    state.optimizer.zero_grad(set_to_none=True)
    batch_stats = state.copy_batch_stats()
    loss = _pose_loss(state.module, images, batch, train=True)
    state.scale_loss(loss).backward()
    state.apply_gradients(batch_stats)
    return {"loss": loss.detach(), **precision_metrics(state)}


@torch.no_grad()
def pose_eval_step(state: TrainState, batch: dict) -> dict:
    """The mask-weighted validation-loss sum and count of one batch, BN
    on its running statistics."""
    images = maybe_normalize(batch["image"], "tanh")
    mask = _eval_mask(batch, images)
    losses = _pose_loss(state.module, images, batch, train=False,
                        per_sample=True)
    return {"loss_sum": (losses * mask).sum(), "count": mask.sum()}


def aggregate_eval_parts(parts: Iterable[dict]) -> tuple[dict, float]:
    """Sum eval-step outputs into ``(val_* means, total count)``;
    ``<k>_sum`` and bare keys both become ``val_<k>``."""
    totals = None
    for part in parts:
        part = {k: float(v) for k, v in part.items()}
        if totals is None:
            totals = part
        else:
            totals = {k: totals[k] + part[k] for k in totals}
    if not totals:
        return {}, 0.0
    n = totals.pop("count")
    return {
        f"val_{k[:-4] if k.endswith('_sum') else k}": v / n
        for k, v in totals.items()
    }, n

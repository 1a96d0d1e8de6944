"""The training loop: validation, epochs, plateau LR, checkpoints, resume.

The twin of ``deepvision_tpu/train/trainer.py`` for one device. Kept from
the JAX Trainer:

- validation before training, logged at epoch -1;
- ``train_epoch`` over the device feed (``data/prefetch.py``), one
  dropout generator a step from the epoch's stream ``KeySeq(seed + 1,
  epoch)``, metrics fetched every ``log_every`` steps and at the epoch's
  end, never per step;
- masked validation (exact over the whole held-out set), through the
  device feed too, so that packed JPEG batches decode on its side
  stream;
- the plateau controller on ``val_top1`` (else the negated loss); a
  step-count schedule (``inception_poly``, ``step``) follows the
  optimizer's own update count on the device, which checkpoints carry,
  so a resume goes on mid-schedule;
- a checkpoint every epoch and :meth:`Trainer.resume`;
- images per second.

Left for later slices: recovery and fault injection, the sentinel, the
cluster, preemption, the stall watchdog, the RSS limit, the profiler
window, ZeRO-1, async checkpoints, ``keep_best`` and data echo.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from deepvision_tpu_torch.core.precision import get_policy
from deepvision_tpu_torch.core.prng import KeySeq
from deepvision_tpu_torch.data.prefetch import DevicePrefetcher, FeedTelemetry
from deepvision_tpu_torch.device import resolve_device
from deepvision_tpu_torch.train.checkpoint import CheckpointManager
from deepvision_tpu_torch.train.loggers import Loggers
from deepvision_tpu_torch.train.optimizers import make_optimizer, set_lr_scale
from deepvision_tpu_torch.train.state import TrainState
from deepvision_tpu_torch.train.steps import (
    aggregate_eval_parts,
    classification_eval_step,
    classification_train_step,
)

__all__ = ["Trainer"]

# feed telemetry logged per epoch, as input_<key>
_INPUT_KEYS = ("host_wait_ms", "shard_ms", "h2d_wait_ms", "step_ms",
               "wait_frac", "h2d_bytes_per_image", "image_bytes_per_image")


def _fmt(d: dict) -> str:
    return " ".join(f"{k}={v:.4g}" for k, v in d.items())


class Trainer:
    def __init__(
        self,
        module: nn.Module,
        config: dict,
        train_data: Callable[[int], Iterable[dict]],
        val_data: Callable[[], Iterable[dict]],
        *,
        device: str | torch.device | None = None,
        workdir: str | Path = "runs",
        train_step=classification_train_step,
        eval_step=classification_eval_step,
        log_every: int = 10,
        seed: int = 0,
        prefetch_depth: int = 2,
        steps_per_epoch: int | None = None,
    ):
        """``module`` holds the starting weights, on ``device`` (default
        ``"cuda"``), with the policy's compute dtype; ``train_data(epoch)``
        and ``val_data()`` yield host batches (dicts of numpy arrays).
        ``steps_per_epoch`` sets the epoch of a step-count schedule
        (1000 when not given, as the JAX Trainer counts)."""
        self.device = resolve_device(device)
        self.config = config
        self.train_data = train_data
        self.val_data = val_data
        self.workdir = Path(workdir) / config.get("name", "run")
        self.log_every = log_every
        self.seed = seed
        if prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {prefetch_depth}")
        self.prefetch_depth = int(prefetch_depth)
        self.policy = get_policy(config.get("precision", "bf16"))
        optimizer, self.plateau = make_optimizer(
            config, module.parameters(), steps_per_epoch or 1000)
        self.state = TrainState(
            module, optimizer,
            loss_scale=self.policy.make_loss_scale(self.device))
        self._train_step = train_step
        self._eval_step = eval_step
        self.loggers = Loggers()
        self.ckpt = CheckpointManager(self.workdir / "ckpt")
        self.start_epoch = 0
        self.best_metric = -float("inf")

    # -- resume ----------------------------------------------------------
    def resume(self, epoch: int | None = None) -> None:
        """Restore the newest (or the given) verified checkpoint: the
        train state, the metric history, the plateau controller and the
        best metric; training goes on at the next epoch."""
        meta = self.ckpt.restore(self.state, epoch)
        if meta.get("loggers"):
            self.loggers = meta["loggers"]
        extra = meta.get("extra", {})
        if self.plateau is not None and "plateau" in extra:
            self.plateau.load_state_dict(extra["plateau"])
            set_lr_scale(self.state.optimizer, self.plateau.scale)
        if meta.get("best_metric") is not None:
            self.best_metric = meta["best_metric"]
        self.start_epoch = meta["epoch"] + 1

    # -- loops -----------------------------------------------------------
    def train_epoch(self, epoch: int) -> dict:
        keys = KeySeq(self.seed + 1, epoch, device=self.device)
        counts: list[int] = []
        pending: list[dict] = []  # device metrics not yet fetched
        fetched: list[dict] = []

        def drain():
            # one device-to-host copy for every pending metric
            if not pending:
                return
            names = list(pending[0])
            values = torch.stack([torch.stack([m[k].float() for k in names])
                                  for m in pending]).tolist()
            fetched.extend(dict(zip(names, row)) for row in values)
            pending.clear()

        def counted():
            for batch in self.train_data(epoch):
                # a packed batch's image count, else its rows
                counts.append(getattr(batch, "n_images", None)
                              or len(batch["image"]))
                yield batch

        tel = FeedTelemetry()
        t0 = time.perf_counter()
        feed = DevicePrefetcher(counted(), self.device,
                                depth=self.prefetch_depth, telemetry=tel)
        try:
            for i, batch in enumerate(feed):
                pending.append(self._train_step(self.state, batch,
                                                next(keys)))
                if self.log_every and i % self.log_every == 0:
                    drain()
                    running = np.mean([m["loss"] for m in fetched])
                    print(f"[epoch {epoch} batch {i}] "
                          f"loss={fetched[-1]['loss']:.4f} "
                          f"running={running:.4f}", flush=True)
        finally:
            feed.close()
        drain()  # waits for the epoch's last step
        dt = time.perf_counter() - t0
        summary = tel.summary()
        print(f"[feed] epoch {epoch}: wire {summary['wire_dtype']}, "
              f"{summary['h2d_bytes_per_image']} bytes an image crossed "
              f"({summary['image_bytes_per_image']} of them image bytes), "
              f"h2d_wait {summary['h2d_wait_ms']} ms and host_wait "
              f"{summary['host_wait_ms']} ms a batch, wait_frac "
              f"{summary['wait_frac']}", flush=True)
        out = {f"train_{k}": float(np.average([m[k] for m in fetched],
                                               weights=counts))
               for k in (fetched[0] if fetched else {})}
        out.update({f"input_{k}": float(summary[k]) for k in _INPUT_KEYS})
        out.update(examples_per_sec=sum(counts) / dt,
                   lr_scale=self.plateau.scale if self.plateau else 1.0)
        return out

    def validate(self) -> dict:
        feed = DevicePrefetcher(self.val_data(), self.device,
                                depth=self.prefetch_depth)
        try:
            metrics, _ = aggregate_eval_parts(
                self._eval_step(self.state, b) for b in feed)
        finally:
            feed.close()
        return metrics

    def fit(self, epochs: int | None = None) -> Loggers:
        total = epochs or self.config.get("total_epochs", 1)
        if self.start_epoch == 0:
            val = self.validate()  # pre-train validation
            if val:
                self.loggers.log_metrics(-1, val)
                print(f"[pre-train] {_fmt(val)}", flush=True)
        for epoch in range(self.start_epoch, total):
            tr = self.train_epoch(epoch)
            val = self.validate()
            epoch_metrics = {**tr, **val}
            self.loggers.log_metrics(epoch, epoch_metrics)
            print(f"[epoch {epoch}] {_fmt(epoch_metrics)}", flush=True)
            # plateau metric: accuracy when there is one, else the
            # negated loss
            metric = val.get("val_top1", -val["val_loss"] if "val_loss"
                             in val else -tr["train_loss"])
            if self.plateau is not None:
                set_lr_scale(self.state.optimizer, self.plateau.update(metric))
            self.best_metric = max(self.best_metric, metric)
            self.ckpt.save(
                epoch, self.state, loggers=self.loggers,
                extra=({"plateau": self.plateau.state_dict()}
                       if self.plateau else {}),
                best_metric=self.best_metric, config=self.config)
        return self.loggers

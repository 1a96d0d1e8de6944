"""Learning-rate schedules, the twins of ``deepvision_tpu/train/schedules.py``.

- ``step_decay``: StepLR, ``gamma`` every ``step_size_epochs``;
- ``inception_poly``: (1 - e/60)^0.5 for e < 60, then 1e-2, then 1e-3 of
  the base;
- ``linear_decay``: constant, then linear to 0;
- :class:`PlateauController`: torch's ReduceLROnPlateau as a host-side
  LR scale, which ``train/optimizers.set_lr_scale`` writes into the
  optimizer's param groups.

Each schedule maps the optimizer's update count (the count before the
update, as optax's: a float32 tensor on the device, or a Python int) to
the learning rate as a float32 0-d tensor on the count's device, in
float32 arithmetic as the JAX schedules compute it. The optimizer
evaluates it on the card at every update (``train/optimizers.py``), so
the host never waits for the count.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["step_decay", "inception_poly", "linear_decay",
           "PlateauController"]

Schedule = Callable[[torch.Tensor | int], torch.Tensor]


def _count(count: torch.Tensor | int) -> torch.Tensor:
    return torch.as_tensor(count, dtype=torch.float32)


def step_decay(base_lr: float, steps_per_epoch: int, step_size_epochs: int,
               gamma: float) -> Schedule:
    def schedule(count):
        epoch = _count(count) // steps_per_epoch
        return base_lr * gamma ** (epoch // step_size_epochs)
    return schedule


def inception_poly(base_lr: float, steps_per_epoch: int) -> Schedule:
    def schedule(count):
        epoch = _count(count) // steps_per_epoch
        frac = torch.sqrt(torch.clamp(1.0 - epoch / 60.0, min=0.0))
        return base_lr * torch.where(
            epoch < 60, frac, torch.where(epoch < 75, 0.01, 0.001))
    return schedule


def linear_decay(base_lr: float, total_steps: int,
                 decay_start: int) -> Schedule:
    def schedule(count):
        frac = (_count(count) - decay_start) / max(total_steps - decay_start,
                                                    1)
        return base_lr * (1.0 - torch.clamp(frac, 0.0, 1.0))
    return schedule


@dataclasses.dataclass
class PlateauController:
    """torch ReduceLROnPlateau semantics (mode/factor/patience/threshold).

    ``update(metric)`` returns the new LR scale in (0, 1]."""

    mode: str = "max"
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    min_scale: float = 1e-8

    scale: float = 1.0
    best: float | None = None
    bad_epochs: int = 0

    def update(self, metric: float) -> float:
        if self.best is None:
            self.best = metric
            return self.scale
        if self.mode == "max":
            improved = metric > self.best * (1 + self.threshold)
        else:
            improved = metric < self.best * (1 - self.threshold)
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale

    def state_dict(self) -> dict:
        return {"scale": self.scale, "best": self.best,
                "bad_epochs": self.bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.scale = d["scale"]
        self.best = d["best"]
        self.bad_epochs = d["bad_epochs"]

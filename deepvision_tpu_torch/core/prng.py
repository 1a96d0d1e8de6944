"""PRNG discipline on ``torch.Generator``.

The twin of ``deepvision_tpu/core/prng.py``. No global RNG state: a run
derives its streams from its integer seed, and :class:`KeySeq` hands out
one fresh generator a step. The Trainer builds ``KeySeq(seed + 1,
epoch)`` each epoch, as the JAX Trainer folds the epoch into
``key(seed + 1)``, so a resume at an epoch draws what the uninterrupted
run drew there. The numbers are torch's (Philox on the card), never
threefry's: tests compare no sampled streams across the two packages.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["KeySeq"]


class KeySeq:
    """``next(seq)`` -> a fresh ``torch.Generator`` on ``device``.

    Draw ``i`` of ``KeySeq(seed, *path)`` is seeded from numpy's
    ``SeedSequence(seed, spawn_key=(*path, i))``: distinct paths and
    draws give independent streams, and the same ones give the same."""

    def __init__(self, seed: int, *path: int,
                 device: torch.device | str = "cpu"):
        self.seed = int(seed)
        self.path = tuple(int(p) for p in path)
        self.device = torch.device(device)
        self._drawn = 0

    def __next__(self) -> torch.Generator:
        seq = np.random.SeedSequence(self.seed,
                                     spawn_key=(*self.path, self._drawn))
        self._drawn += 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seq.generate_state(1, np.uint64)[0]))
        return gen

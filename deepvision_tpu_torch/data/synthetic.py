"""Hermetic synthetic classification set, a copy of
``deepvision_tpu/data/synthetic.py``: the same seed gives the same
arrays, byte for byte, as the JAX package's.

The class signal is a channel-0 brightness shift of ``0.3 * (label %
7)``: with ``num_classes <= 7`` every class is separable.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_classification"]


def synthetic_classification(
    n: int, size: int, channels: int, num_classes: int, batch_size: int,
) -> tuple[np.ndarray, np.ndarray, int]:
    """-> (images, labels, split): ``images[:split]`` is the held-out
    validation slice, ``images[split:]`` the training set."""
    r = np.random.default_rng(0)
    labels = r.integers(0, num_classes, n).astype(np.int32)
    imgs = r.normal(0, 1, (n, size, size, channels)).astype(np.float32)
    for i in range(n):  # make it learnable
        imgs[i, :, :, 0] += (labels[i] % 7) * 0.3
    split = max(batch_size, int(n * 0.1))
    return imgs, labels, split

"""Epoch batching over host arrays, a copy of ``batches`` in
``deepvision_tpu/data/mnist.py`` (the idx reader comes with the LeNet
slice)."""

from __future__ import annotations

import numpy as np

from deepvision_tpu_torch.data.padding import pad_partial_batch

__all__ = ["batches"]


def batches(images, labels, batch_size, *, rng=None, drop_remainder=True):
    """Epoch iterator over host arrays, shuffled by ``rng`` if given.

    ``drop_remainder=False`` (the eval path) pads the final partial batch
    to ``batch_size`` and attaches a 0/1 ``mask`` to every batch."""
    n = len(images)
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    end = n - n % batch_size if drop_remainder else n
    for s in range(0, end, batch_size):
        sel = idx[s : s + batch_size]
        batch = {"image": images[sel], "label": labels[sel]}
        if not drop_remainder:
            batch = pad_partial_batch(batch, batch_size)
        yield batch

"""Batch iteration and final-partial-batch padding, a copy of
``deepvision_tpu/data/padding.py`` (without the tf.data iterator).

Training takes full batches; evaluation pads the final partial batch to
the full batch shape and attaches a 0/1 ``mask`` of real rows, which the
eval step weights its sums by.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pad_partial_batch", "iter_array_batches"]


def pad_partial_batch(batch: dict, batch_size: int) -> dict:
    """Pad every array in ``batch`` along axis 0 to ``batch_size`` and
    attach ``mask`` ((batch_size,) float32, 1 = real row, 0 = padding)."""
    n = len(next(iter(batch.values())))
    if n > batch_size:
        raise ValueError(f"batch of {n} exceeds pad target {batch_size}")
    pad = batch_size - n
    out = {}
    for key, value in batch.items():
        value = np.asarray(value)
        if pad:
            value = np.pad(value, ((0, pad),) + ((0, 0),) * (value.ndim - 1))
        out[key] = value
    mask = np.ones(batch_size, np.float32)
    mask[n:] = 0.0
    out["mask"] = mask
    return out


def iter_array_batches(arrays: dict, batch_size: int, *, rng=None,
                       drop_remainder: bool = True):
    """Epoch iterator over a dict of equal-length host arrays;
    ``drop_remainder=False`` pads the final partial batch and attaches a
    mask to every batch."""
    n = len(next(iter(arrays.values())))
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    end = n - n % batch_size if drop_remainder else n
    for s in range(0, end, batch_size):
        sel = idx[s : s + batch_size]
        batch = {k: v[sel] for k, v in arrays.items()}
        if not drop_remainder:
            batch = pad_partial_batch(batch, batch_size)
        yield batch

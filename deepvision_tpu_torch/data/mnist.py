"""MNIST: the idx reader, the synthetic stand-in and epoch batching, a
copy of ``deepvision_tpu/data/mnist.py``.

:func:`load_mnist_idx` parses the raw idx format (magic check,
big-endian dims, uint8 -> float32 / 255, optionally gzipped) and pads 28
to 32 for LeNet-5 (DCGAN keeps 28 with ``pad_to_32=False``);
:func:`synthetic_mnist` is the JAX package's learnable toy set (one
bright 8x8 blob at a class position), array for array; the images are
NHWC ``(N, 32, 32, 1)``.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

from deepvision_tpu_torch.data.padding import pad_partial_batch

__all__ = ["load_mnist_idx", "synthetic_mnist", "batches"]


def _read_idx(path: str | Path) -> np.ndarray:
    p = Path(path)
    opener = gzip.open if p.suffix == ".gz" else open
    with opener(p, "rb") as f:
        data = f.read()
    zeros, dtype_code, ndim = struct.unpack(">HBB", data[:4])
    if zeros != 0:
        raise ValueError(f"{p}: bad idx magic")
    if dtype_code != 0x08:  # uint8, the only type MNIST uses
        raise ValueError(f"{p}: unsupported idx dtype 0x{dtype_code:02x}")
    dims = struct.unpack(f">{ndim}I", data[4:4 + 4 * ndim])
    arr = np.frombuffer(data, np.uint8, offset=4 + 4 * ndim)
    return arr.reshape(dims)


def load_mnist_idx(images_path, labels_path,
                   pad_to_32: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """-> (images ``(N, 32, 32, 1)`` float32 in [0, 1], labels ``(N,)``
    int32); ``pad_to_32=False`` keeps 28x28."""
    images = _read_idx(images_path).astype(np.float32) / 255.0
    labels = _read_idx(labels_path).astype(np.int32)
    if pad_to_32:
        images = np.pad(images, ((0, 0), (2, 2), (2, 2)))
    return images[..., None], labels


def synthetic_mnist(n: int = 512, num_classes: int = 10, seed: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Learnable synthetic digits: one bright 8x8 blob at class ``k``'s
    cell of a 4x4 grid, on N(0.1, 0.05) noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    images = rng.normal(0.1, 0.05, size=(n, 32, 32, 1)).astype(np.float32)
    rows, cols = labels // 4, labels % 4
    for i in range(n):
        r, c = rows[i] * 8 + 2, cols[i] * 8 + 2
        images[i, r:r + 8, c:c + 8, 0] += 1.0
    return images, labels


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

"""Pose records -> device batches, the port's twin of
``deepvision_tpu/data/pose.py`` (one process reads; ``tf.data`` is
replaced by plain Python over the port's own record codec).

Records follow the pose builder's schema
(``deepvision_tpu/data/builders/pose.py``): ``image/encoded`` JPEG bytes,
``image/person/keypoints/{x,y}`` normalized to the image,
``image/person/keypoints/v`` (0: absent) and ``image/person/scale`` (the
MPII person scale, body height / 200 px). Training reads ``train-*``,
validation ``val-*``.

Each record, as the JAX reader's ``prep``:

- :func:`crop_person_roi`: the window around the visible keypoints,
  padded by ``margin`` times the body height, computed in float32 on the
  host from the JPEG header's size with tf's truncating ``int32`` casts
  (trap C15's lesson), and the keypoints renormalized to it; the margin
  is drawn U(0.1, 0.3) by numpy from the epoch's seed in training (trap
  C6) and is 0.2 at validation;
- :func:`to_model_inputs`: the resize to ``size`` x ``size`` (bilinear,
  half-pixel centres, no antialias: ``tf.image.resize``'s default, trap
  C9), the keypoints cut or padded with zeros to :data:`NUM_JOINTS`, and
  the images as the uint8 wire (``device_aug``) or as float32 in [-1, 1].

The batch crosses packed (``data/detection.PackedTargetBatch``) and the
decode, the crop and the resize run on the device feed's side stream:
nvJPEG on the card, PIL on the CPU when the CPU is asked for (trap C14).
With ``device_aug`` the step flips images and keypoints together
(``DeviceAugment("pose")``). :func:`synthetic_pose` is the JAX package's
learnable synthetic set, array for array.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from deepvision_tpu_torch.data.detection import (
    DecodePlan,
    PackedTargetBatch,
    _model_pixels,
    jpeg_size,
)
from deepvision_tpu_torch.data.imagenet import (
    _chunks,
    process_shard,
    shuffled_records,
)
from deepvision_tpu_torch.data.jpeg import resize_bilinear
from deepvision_tpu_torch.data.padding import iter_array_batches
from deepvision_tpu_torch.data.tfrecord import decode_example, read_records

__all__ = ["NUM_JOINTS", "TRAIN_MARGIN", "VAL_MARGIN", "parse_pose_record",
           "crop_person_roi", "fixed_joints", "to_model_inputs",
           "train_batches", "eval_batches", "synthetic_pose",
           "synthetic_pose_batches", "make_pose_data"]

NUM_JOINTS = 16
TRAIN_MARGIN = (0.1, 0.3)  # U(0.1, 0.3) of the body height
VAL_MARGIN = 0.2

_F32 = np.float32


def parse_pose_record(record):
    """One Example -> (JPEG bytes, kx, ky float32 ``(N,)``, v int32
    ``(N,)``, scale float32)."""
    f = decode_example(record)

    def values(key, dtype):
        return np.asarray(f.get(f"image/person/keypoints/{key}", []), dtype)

    return (f["image/encoded"][0], values("x", _F32), values("y", _F32),
            values("v", np.int64).astype(np.int32),
            _F32(f["image/person/scale"][0]))


def crop_person_roi(h: int, w: int, kx: np.ndarray, ky: np.ndarray,
                    v: np.ndarray, scale, margin):
    """The person window of an ``h`` x ``w`` image -> ((top, left,
    height, width), kx, ky renormalized to it): the visible keypoints'
    bounding box (the whole frame if none is visible) padded by ``margin
    · scale · 200`` px, clipped to the image and at least one pixel a
    side; the JAX ``crop_person_roi``'s float32 arithmetic, with its
    truncating casts."""
    img_h, img_w = _F32(h), _F32(w)
    px = kx.astype(_F32) * img_w
    py = ky.astype(_F32) * img_h
    vis = v > 0
    if vis.any():
        xmin, xmax = px[vis].min(), px[vis].max()
        ymin, ymax = py[vis].min(), py[vis].max()
    else:
        xmin, ymin, xmax, ymax = _F32(0), _F32(0), img_w, img_h
    pad = _F32(scale) * _F32(200.0) * _F32(margin)
    x1 = int(max(xmin - pad, _F32(0)))
    y1 = int(max(ymin - pad, _F32(0)))
    x2 = max(int(min(xmax + pad, img_w)), x1 + 1)
    y2 = max(int(min(ymax + pad, img_h)), y1 + 1)
    nkx = (px - _F32(x1)) / _F32(x2 - x1)
    nky = (py - _F32(y1)) / _F32(y2 - y1)
    return (y1, x1, y2 - y1, x2 - x1), nkx, nky


def fixed_joints(kx: np.ndarray, ky: np.ndarray, v: np.ndarray):
    """The first :data:`NUM_JOINTS` joints, padded with zeros: (kx, ky
    float32, v int32), each ``(NUM_JOINTS,)``."""
    def fix(t, dtype):
        out = np.zeros(NUM_JOINTS, dtype)
        t = t[:NUM_JOINTS]
        out[:len(t)] = t
        return out

    return fix(kx, _F32), fix(ky, _F32), fix(v, np.int32)


def to_model_inputs(image: torch.Tensor, kx, ky, v, size: int,
                    as_uint8: bool = False):
    """HWC crop -> (``size`` x ``size`` image, as uint8 or float32 in
    [-1, 1]; kx, ky, v of :func:`fixed_joints`)."""
    x = _model_pixels(resize_bilinear(image, size, size), as_uint8)
    return (x, *fixed_joints(kx, ky, v))


def _packed(records, size: int, margins, as_uint8: bool,
            pad_to: int | None = None) -> PackedTargetBatch:
    blobs, windows, joints = [], [], []
    for rec, margin in zip(records, margins):
        blob, kx, ky, v, scale = parse_pose_record(rec)
        window, nkx, nky = crop_person_roi(*jpeg_size(blob), kx, ky, v,
                                           scale, margin)
        blobs.append(blob)
        windows.append(window)
        joints.append(fixed_joints(nkx, nky, v))
    kx, ky, v = (np.stack(t) for t in zip(*joints))
    return PackedTargetBatch(blobs, {"kx": kx, "ky": ky, "v": v}, DecodePlan(
        size, windows=tuple(windows), as_uint8=as_uint8, pad_to=pad_to))


def train_batches(files, batch_size: int, size: int, *, seed: int,
                  steps: int | None, device_aug: bool = False,
                  rank: int = 0, world: int = 1,
                  shuffle_buffer: int = 1000):
    """Training batches of the ``train-*`` shards, each image cropped to
    its person with a margin drawn U(0.1, 0.3) from ``seed``'s stream;
    ``steps`` full batches (None: forever)."""
    rng, records = shuffled_records(files, seed=seed, rank=rank,
                                    world=world,
                                    shuffle_buffer=shuffle_buffer)
    for chunk in _chunks(records, batch_size, steps):
        if len(chunk) < batch_size:
            return
        margins = rng.uniform(*TRAIN_MARGIN, len(chunk)).astype(_F32)
        yield _packed(chunk, size, margins, as_uint8=device_aug)


def eval_batches(files, batch_size: int, size: int, *,
                 as_uint8: bool = False, pad: bool = True, rank: int = 0,
                 world: int = 1):
    """Batches of the shards in file order at the validation margin,
    each process its row block of every global batch of ``batch_size``;
    with ``pad`` a short block is padded to ``batch_size // world`` and
    masked (else it stays short, as ``evaluate.py`` reads it)."""
    local = batch_size // world
    records = (rec for path in sorted(files) for rec in read_records(path))
    for chunk in _chunks(records, batch_size, None):
        mine = chunk[rank * local:(rank + 1) * local]
        yield _packed(mine, size, [VAL_MARGIN] * len(mine), as_uint8,
                      pad_to=local if pad else None)


def synthetic_pose(n: int = 128, size: int = 64,
                   num_joints: int = NUM_JOINTS, seed: int = 0):
    """The JAX package's learnable synthetic pose set: one bright blob a
    visible joint in the channel ``joint % 3``, on a dim noisy field;
    returns (float32 images near 0, kx, ky, v)."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0.0, 0.05, size=(n, size, size, 3)).astype(_F32)
    kx = rng.uniform(0.15, 0.85, size=(n, num_joints)).astype(_F32)
    ky = rng.uniform(0.15, 0.85, size=(n, num_joints)).astype(_F32)
    v = (rng.uniform(size=(n, num_joints)) > 0.2).astype(np.int32)
    r = max(size // 32, 1)
    for i in range(n):
        for j in range(num_joints):
            if not v[i, j]:
                continue
            cx, cy = int(kx[i, j] * size), int(ky[i, j] * size)
            images[i, max(cy - r, 0):cy + r + 1,
                   max(cx - r, 0):cx + r + 1, j % 3] = 1.0
    return images, kx, ky, v


def synthetic_pose_batches(images, kx, ky, v, batch_size, *, rng=None,
                           drop_remainder=True):
    """Epoch iterator over the synthetic arrays (the eval tail padded and
    masked)."""
    return iter_array_batches({"image": images, "kx": kx, "ky": ky, "v": v},
                              batch_size, rng=rng,
                              drop_remainder=drop_remainder)


def make_pose_data(data_dir: str, batch_size: int, size: int = 256, *,
                   train_pattern: str = "train-*", val_pattern: str = "val-*",
                   steps_per_epoch: int, device_aug: bool = False):
    """-> (train_data(epoch) -> iterator, val_data() -> iterator,
    steps_per_epoch), the JAX ``make_pose_data`` for one loader process:
    ``batch_size`` is global, each process reads its share of the
    training files and its row block of every validation batch.
    ``device_aug`` ships uint8 and leaves the flip to the step."""
    d = Path(data_dir)
    rank, world = process_shard()
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} not divisible by "
                         f"{world} processes")
    local = batch_size // world
    train_files = sorted(d.glob(train_pattern))
    val_files = sorted(d.glob(val_pattern))
    if not train_files:
        raise FileNotFoundError(f"no {train_pattern} records under {d}")

    def train_data(epoch: int):
        return train_batches(train_files, local, size, seed=epoch,
                             steps=steps_per_epoch, device_aug=device_aug,
                             rank=rank, world=world)

    def val_data():
        return eval_batches(val_files, batch_size, size,
                            as_uint8=device_aug, rank=rank, world=world)

    return train_data, val_data, steps_per_epoch

"""Detection records -> padded device batches, the port's twin of
``deepvision_tpu/data/detection.py`` (one process reads; ``tf.data`` is
replaced by plain Python over the port's own record codec).

Records follow the reference builder's schema
(``deepvision_tpu/data/builders/detection.py``): ``image/encoded`` JPEG
bytes, ``image/object/bbox/{xmin,ymin,xmax,ymax}`` normalized corners
and ``image/object/class/label`` 1-based (shifted to 0-based here).
Training reads ``train-*``, validation ``val-*``.

Training, as the JAX reader's ``prep``:

- a horizontal flip with probability 1/2 (:func:`flip_corners`), unless
  ``device_aug``, where the step flips images and boxes together
  (``data/device_aug.py``, ``DeviceAugment("detection")``);
- the bbox-preserving random crop with probability 1/2
  (:func:`crop_window`, :func:`crop_corners`): the four margins drawn
  between the union of the boxes and the border, the offsets floored and
  the extents ceiled in float32 as tf computes them, clamped to the
  image, and the boxes renormalized to that pixel window with the far
  edge clipped at 1;
- :func:`to_model_inputs`: the resize to ``size`` x ``size`` without
  keeping the aspect (bilinear, half-pixel centres, no antialias:
  ``tf.image.resize``'s default, trap C9), corners -> xywh, padding to
  :data:`MAX_BOXES` boxes with zero rows and -1 labels, and the images as
  the uint8 wire (``device_aug``) or as float32 in [-1, 1].

The host draws every decision (coins and crop draws) from numpy
generators seeded by the epoch (trap C6) and computes the crop window
from the JPEG header's size (:func:`jpeg_size`) and the boxes; the batch
crosses packed (:class:`PackedTargetBatch`), and the decode, the
flip, the crop and the resize run on the device feed's side stream:
nvJPEG on the card (``data/jpeg.py``; its ``gpu_hybrid`` decoder or an
error), PIL on the CPU when the CPU is asked for.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from deepvision_tpu_torch.data.image_io import wire_uint8
from deepvision_tpu_torch.data.imagenet import (
    _chunks,
    process_shard,
    shuffled_records,
)
from deepvision_tpu_torch.data.jpeg import decode_images, pack, resize_bilinear
from deepvision_tpu_torch.data.padding import pad_partial_batch
from deepvision_tpu_torch.data.tfrecord import decode_example, read_records

__all__ = ["MAX_BOXES", "parse_detection_record", "jpeg_size",
           "flip_corners", "crop_window", "crop_corners", "to_model_inputs",
           "DecodePlan", "PackedTargetBatch", "train_batches",
           "eval_batches", "synthetic_detection", "synthetic_batches",
           "make_detection_data"]

MAX_BOXES = 100  # the loss's true-box cap

_F32 = np.float32


def parse_detection_record(record) -> tuple[bytes, np.ndarray, np.ndarray]:
    """One Example -> (JPEG bytes, corners ``(N, 4)`` float32, labels
    ``(N,)`` int32 shifted to 0-based)."""
    f = decode_example(record)
    boxes = np.stack([np.asarray(f.get(f"image/object/bbox/{k}", []), _F32)
                      for k in ("xmin", "ymin", "xmax", "ymax")], axis=-1)
    labels = np.asarray(f.get("image/object/class/label", []),
                        np.int64).astype(np.int32) - 1
    return f["image/encoded"][0], boxes.reshape(-1, 4), labels


def jpeg_size(blob) -> tuple[int, int]:
    """``(height, width)`` from a JPEG's start-of-frame header."""
    data = bytes(blob)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG: no start-of-image marker")
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise ValueError(f"corrupt JPEG: no marker at byte {i}")
        marker = data[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        i += 2
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:  # no length field
            continue
        length = (data[i] << 8) | data[i + 1]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return ((data[i + 3] << 8) | data[i + 4],
                    (data[i + 5] << 8) | data[i + 6])
        i += length
    raise ValueError("corrupt JPEG: no start-of-frame header")


def flip_corners(corners: np.ndarray) -> np.ndarray:
    """The boxes of a horizontally flipped image: ``(1 - xmax, ymin, 1 -
    xmin, ymax)``."""
    x1, y1, x2, y2 = np.moveaxis(corners, -1, 0)
    return np.stack([_F32(1) - x2, y1, _F32(1) - x1, y2], axis=-1)


def crop_window(corners: np.ndarray, h: int, w: int, draws
                ) -> tuple[int, int, int, int] | None:
    """The bbox-preserving crop's pixel window ``(top, left, height,
    width)`` of an ``h`` x ``w`` image, or None for no crop, from five
    uniform draws in [0, 1): the coin (a crop below 1/2, and only with
    boxes) and the left, top, right and bottom margins' fractions of
    their room between the boxes' union and the border. The JAX
    ``random_crop``'s float32 arithmetic: offsets truncated, extents
    ceiled, both clamped to the image."""
    coin, ux1, uy1, ux2, uy2 = (_F32(d) for d in draws)
    if not (coin < _F32(0.5) and len(corners)):
        return None
    eps = _F32(1e-6)
    dx1 = ux1 * max(corners[:, 0].min(), eps)
    dy1 = uy1 * max(corners[:, 1].min(), eps)
    dx2 = ux2 * max(_F32(1) - corners[:, 2].max(), eps)
    dy2 = uy2 * max(_F32(1) - corners[:, 3].max(), eps)
    sx = _F32(1) - dx1 - dx2
    sy = _F32(1) - dy1 - dy2
    hf, wf = _F32(h), _F32(w)
    top, left = int(dy1 * hf), int(dx1 * wf)
    th = min(int(np.ceil(sy * hf)), h - top)
    tw = min(int(np.ceil(sx * wf)), w - left)
    return top, left, th, tw


def crop_corners(corners: np.ndarray, window, h: int, w: int) -> np.ndarray:
    """Boxes renormalized to the pixel ``window`` ``(top, left, height,
    width)`` of an ``h`` x ``w`` image, the far edges clipped at 1."""
    top, left, th, tw = window
    fx1, fy1 = _F32(left) / _F32(w), _F32(top) / _F32(h)
    fsx, fsy = _F32(tw) / _F32(w), _F32(th) / _F32(h)
    return np.stack([(corners[:, 0] - fx1) / fsx,
                     (corners[:, 1] - fy1) / fsy,
                     np.minimum((corners[:, 2] - fx1) / fsx, _F32(1)),
                     np.minimum((corners[:, 3] - fy1) / fsy, _F32(1))],
                    axis=-1).astype(_F32)


def padded_targets(corners: np.ndarray, labels: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Corners -> xywh, the first :data:`MAX_BOXES` kept, padded with
    zero boxes and -1 labels."""
    xy = (corners[:, 0:2] + corners[:, 2:4]) / _F32(2)
    wh = corners[:, 2:4] - corners[:, 0:2]
    n = min(len(corners), MAX_BOXES)
    boxes = np.zeros((MAX_BOXES, 4), _F32)
    boxes[:n] = np.concatenate([xy, wh], axis=-1)[:n]
    out = np.full(MAX_BOXES, -1, np.int32)
    out[:n] = labels[:n]
    return boxes, out


def _model_pixels(images: torch.Tensor, as_uint8: bool) -> torch.Tensor:
    """Resized float pixels -> the uint8 wire, or float32 in [-1, 1]."""
    return wire_uint8(images) if as_uint8 else images / 127.5 - 1.0


def to_model_inputs(image: torch.Tensor, corners: np.ndarray,
                    labels: np.ndarray, size: int, as_uint8: bool = False):
    """HWC pixels -> (``size`` x ``size`` image, as uint8 or float32 in
    [-1, 1]; xywh boxes ``(MAX_BOXES, 4)``; labels ``(MAX_BOXES,)``)."""
    x = _model_pixels(resize_bilinear(image, size, size), as_uint8)
    return (x, *padded_targets(corners, labels))


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """What the decode stage does to each image of a packed batch: the
    flip (``flips``, (B,) bool, or None), the crop (``windows``, one
    ``(top, left, height, width)`` or None an image, or None), then the
    resize to ``size`` and the uint8 wire (``as_uint8``) or float32 in
    [-1, 1]; ``pad_to`` pads a short batch with zero rows and a
    ``mask``."""

    size: int
    flips: np.ndarray | None = None
    windows: tuple | None = None
    as_uint8: bool = False
    pad_to: int | None = None


class PackedTargetBatch(dict):
    """A batch of JPEGs and their targets as it crosses to the device:
    ``jpeg`` (packed bytes), ``offsets``, and the targets, numpy arrays
    the host already moved with the planned flip and crop (detection:
    ``boxes`` ``(B, MAX_BOXES, 4)`` and ``label`` ``(B, MAX_BOXES)``;
    pose, ``data/pose.py``: ``kx``, ``ky`` and ``v``). A packed batch of
    the device feed (``data/prefetch.py``): the feed runs :meth:`decode`
    on its side stream."""

    wire_dtype = "jpeg"

    def __init__(self, blobs, targets: dict, plan: DecodePlan):
        packed, offsets = pack(blobs)
        super().__init__(jpeg=packed, offsets=offsets, **targets)
        self.targets = tuple(targets)
        self.plan = plan

    @property
    def n_images(self) -> int:
        return len(self["offsets"]) - 1

    @property
    def image_bytes(self) -> int:
        return int(self["jpeg"].nbytes)

    def decode(self, device: torch.device) -> dict:
        """Decode, flip, crop and resize as planned -> ``image`` and the
        targets (and ``mask`` when padded) on ``device``."""
        device = torch.device(device)
        plan = self.plan
        s = plan.size
        images = []
        for i, img in enumerate(decode_images(self["jpeg"], self["offsets"],
                                              device)):
            if plan.flips is not None and plan.flips[i]:
                img = img.flip(1)
            window = plan.windows[i] if plan.windows is not None else None
            if window is not None:
                top, left, th, tw = window
                img = img[top:top + th, left:left + tw]
            images.append(resize_bilinear(img, s, s))
        x = _model_pixels(torch.stack(images) if images
                          else torch.zeros((0, s, s, 3), device=device),
                          plan.as_uint8)
        batch = {"image": x, **{k: torch.from_numpy(self[k]).to(device)
                                for k in self.targets}}
        n = self.n_images
        if plan.pad_to is not None:
            pad = plan.pad_to - n
            if pad < 0:
                raise ValueError(f"batch of {n} exceeds pad target "
                                 f"{plan.pad_to}")
            batch = {k: torch.cat([v, v.new_zeros((pad, *v.shape[1:]))])
                     for k, v in batch.items()}
            mask = torch.zeros(plan.pad_to, dtype=torch.float32)
            mask[:n] = 1.0
            batch["mask"] = mask.to(device)
        return batch


def _targets(parsed) -> dict:
    boxes, labels = zip(*(padded_targets(c, lbl) for c, lbl in parsed))
    return {"boxes": np.stack(boxes), "label": np.stack(labels)}


def train_batches(files, batch_size: int, size: int, *, seed: int,
                  steps: int | None, device_aug: bool = False,
                  rank: int = 0, world: int = 1,
                  shuffle_buffer: int = 1000):
    """Training batches of the ``train-*`` shards as
    :class:`PackedTargetBatch`: a flip (unless ``device_aug``) and the
    bbox-preserving crop, each with probability 1/2, drawn here; ``steps``
    full batches (None: forever)."""
    rng, records = shuffled_records(files, seed=seed, rank=rank,
                                    world=world,
                                    shuffle_buffer=shuffle_buffer)
    for chunk in _chunks(records, batch_size, steps):
        if len(chunk) < batch_size:
            return
        blobs, parsed, flips, windows = [], [], [], []
        for rec in chunk:
            blob, corners, labels = parse_detection_record(rec)
            h, w = jpeg_size(blob)
            flip = not device_aug and rng.random() < 0.5
            if flip:
                corners = flip_corners(corners)
            window = crop_window(corners, h, w, rng.random(5))
            if window is not None:
                corners = crop_corners(corners, window, h, w)
            blobs.append(blob)
            parsed.append((corners, labels))
            flips.append(flip)
            windows.append(window)
        yield PackedTargetBatch(blobs, _targets(parsed), DecodePlan(
            size, flips=np.array(flips), windows=tuple(windows),
            as_uint8=device_aug))


def eval_batches(files, batch_size: int, size: int, *,
                 as_uint8: bool = False, pad: bool = True, rank: int = 0,
                 world: int = 1):
    """Batches of the shards in file order, neither flipped nor cropped,
    each process its row block of every global batch of ``batch_size``;
    with ``pad`` a short block is padded to ``batch_size // world`` and
    masked (else it stays short, as ``evaluate.py`` reads it)."""
    local = batch_size // world
    records = (rec for path in sorted(files) for rec in read_records(path))
    for chunk in _chunks(records, batch_size, None):
        blobs, parsed = [], []
        for rec in chunk[rank * local:(rank + 1) * local]:
            blob, corners, labels = parse_detection_record(rec)
            blobs.append(blob)
            parsed.append((corners, labels))
        yield PackedTargetBatch(blobs, _targets(parsed), DecodePlan(
            size, as_uint8=as_uint8, pad_to=local if pad else None))


def synthetic_detection(n: int = 256, size: int = 128, num_classes: int = 3,
                        seed: int = 0, max_boxes: int = MAX_BOXES):
    """The JAX package's learnable synthetic set, array for array: each
    image carries 1-3 filled rectangles whose colour encodes the class;
    returns (float32 images near 0, padded xywh boxes, labels)."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0.0, 0.05, size=(n, size, size, 3)).astype(_F32)
    boxes = np.zeros((n, max_boxes, 4), _F32)
    labels = np.full((n, max_boxes), -1, np.int32)
    colors = np.linspace(0.4, 1.0, num_classes)
    for i in range(n):
        for b in range(rng.integers(1, 4)):
            cls = int(rng.integers(0, num_classes))
            w, h = rng.uniform(0.2, 0.5, size=2)
            cx = rng.uniform(w / 2, 1 - w / 2)
            cy = rng.uniform(h / 2, 1 - h / 2)
            x1, y1 = int((cx - w / 2) * size), int((cy - h / 2) * size)
            x2, y2 = int((cx + w / 2) * size), int((cy + h / 2) * size)
            images[i, y1:y2, x1:x2, cls % 3] = colors[cls]
            boxes[i, b] = [cx, cy, w, h]
            labels[i, b] = cls
    return images, boxes, labels


def synthetic_batches(images, boxes, labels, batch_size, *, rng=None,
                      drop_remainder=True, augment=False):
    """Epoch iterator over the synthetic arrays (the eval tail padded and
    masked); ``augment`` flips each sample with probability 1/2 from
    ``rng`` (columns reversed, cx -> 1 - cx on real rows), as the JAX
    ``synthetic_batches``."""
    n = len(images)
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    end = n - n % batch_size if drop_remainder else n
    for s in range(0, end, batch_size):
        sel = idx[s:s + batch_size]
        img, box, lbl = images[sel], boxes[sel], labels[sel]
        if augment and rng is not None:
            flip = rng.random(len(sel)) < 0.5
            img[flip] = img[flip, :, ::-1]
            real = (lbl >= 0) & flip[:, None]
            box[..., 0] = np.where(real, 1.0 - box[..., 0], box[..., 0])
        batch = {"image": img, "boxes": box, "label": lbl}
        if not drop_remainder:
            batch = pad_partial_batch(batch, batch_size)
        yield batch


def make_detection_data(data_dir: str, batch_size: int, size: int = 416, *,
                        train_pattern: str = "train-*",
                        val_pattern: str = "val-*", steps_per_epoch: int,
                        device_aug: bool = False):
    """-> (train_data(epoch) -> iterator, val_data() -> iterator,
    steps_per_epoch), the JAX ``make_detection_data`` for one loader
    process: ``batch_size`` is global, each process reads its share of
    the training files and its row block of every validation batch.
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

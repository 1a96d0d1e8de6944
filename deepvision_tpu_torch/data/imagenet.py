"""ImageNet from sharded TFRecords, the port's twin of
``deepvision_tpu/data/imagenet.py`` (one process reads; ``tf.data`` is
replaced by plain Python over the port's own record codec).

Records follow the reference builder's schema: ``image/encoded`` JPEG
bytes (``train-*``, ``validation-*``) or, in the raw-crop shards
(``raw-train-*``, with a ``raw-train.meta.json`` sidecar), ``image/raw``
uint8 frames of the full shorter-side-``stored`` resize with
``image/height`` and ``image/width``; ``image/class/label`` in [1, 1000]
(shifted to [0, 999] here).

Training batches are uint8 (the wire; the step normalizes on the device):

- raw-crop shards: parse, random ``size``² crop and, without
  ``device_aug``, the random flip and (``augment="pt"``) the color jitter
  on the host (:func:`parse_raw_crop`, :func:`host_augment`);
- JPEG shards: the batch crosses packed (``data/jpeg.py``), and the
  decode, resize, random crop, flip and jitter run on the device feed's
  side stream, with the decisions drawn here on the host;
- with ``device_aug`` the host stage is the crop only (``"crop"``), and
  ``data/device_aug.py`` runs the rest inside the step.

Validation always reads ``validation-*`` JPEG: central crop, float32
normalized (``"torch"`` for ``augment="pt"``, else the channel means),
the final partial batch padded and masked. The random streams are
numpy's and torch's, never tf's (trap C6): an epoch's order is
deterministic, seeded by the epoch (files shuffled, then a shuffle buffer
of records), but not tf's order. Files are sharded across processes by
``torch.distributed``'s rank and world size when it is initialized.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from deepvision_tpu_torch.data.jpeg import (
    JpegPlan,
    PackedJpegBatch,
    resize_min_for,
)
from deepvision_tpu_torch.data.padding import pad_partial_batch
from deepvision_tpu_torch.data.tfrecord import decode_example, read_records

__all__ = ["PT_JITTER", "parse_raw_crop", "parse_jpeg_record",
           "host_augment", "shuffled_records", "process_shard",
           "raw_train_batches", "raw_eval_batches", "jpeg_train_batches",
           "val_batches", "make_imagenet_data"]

# the PT configs' ColorJitter(0.2, 0.2, 0.2) (ref:
# ResNet/pytorch/train.py:319)
PT_JITTER = 0.2


def parse_raw_crop(record) -> tuple[np.ndarray, int]:
    """One raw-frame Example -> (uint8 (height, width, 3) frame, label
    shifted to 0-indexed)."""
    f = decode_example(record, views=True)  # the frame stays in place
    h, w = f["image/height"][0], f["image/width"][0]
    frame = np.frombuffer(f["image/raw"][0], np.uint8).reshape(h, w, 3)
    return frame, f["image/class/label"][0] - 1


def parse_jpeg_record(record) -> tuple[bytes, int]:
    """One JPEG Example -> (JPEG bytes, label shifted to 0-indexed)."""
    f = decode_example(record)
    return f["image/encoded"][0], f["image/class/label"][0] - 1


def host_augment(images: np.ndarray, flips: np.ndarray,
                 jitter: np.ndarray | None) -> np.ndarray:
    """The raw reader's host flip and jitter of uint8 crops: flip where
    ``flips``, then (``jitter``, (B, 3) factors) the color jitter in
    float32, rounded back to uint8 (the JAX ``_random_jitter``'s
    ``clip(round(.))``)."""
    from deepvision_tpu_torch.data.device_aug import color_jitter, flip

    x = flip(torch.from_numpy(images), torch.from_numpy(flips))
    if jitter is not None:
        f = torch.from_numpy(np.asarray(jitter, np.float32))
        x = color_jitter(x, f[:, 0], f[:, 1], f[:, 2])
    return x.numpy()


def process_shard() -> tuple[int, int]:
    """(rank, world size) from ``torch.distributed`` when it is
    initialized, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _streams(seed: int, rank: int):
    """(the files' generator, shared by every process; this process's
    records' generator) for ``seed``."""
    def gen(*key):
        return np.random.default_rng(np.random.SeedSequence(seed,
                                                            spawn_key=key))
    return gen(0), gen(1, rank)


def shuffled_records(files: list[Path], *, seed: int, rank: int = 0,
                     world: int = 1, shuffle_buffer: int = 10_000,
                     repeat: bool = True):
    """(records generator, record bytes stream) of the training files:
    each pass shuffles the file list (the same order on every process,
    then this process's share, ``order[rank::world]``) and draws records
    through a shuffle buffer of ``shuffle_buffer``; ``repeat`` passes
    forever, as the JAX reader's ``.repeat()``."""
    files_rng, rng = _streams(seed, rank)
    files = sorted(files)

    def stream() -> Iterator[bytes]:
        while True:
            order = [files[i] for i in files_rng.permutation(len(files))]
            mine = order[rank::world]
            if not mine:
                raise ValueError(f"{len(files)} files leave process {rank} "
                                 f"of {world} none to read")
            buf: list[bytes] = []
            for path in mine:
                for rec in read_records(path):
                    if len(buf) < shuffle_buffer:
                        buf.append(rec)
                        continue
                    i = int(rng.integers(len(buf)))
                    yield buf[i]
                    buf[i] = rec
            while buf:  # drain in random order
                i = int(rng.integers(len(buf)))
                buf[i], buf[-1] = buf[-1], buf[i]
                yield buf.pop()
            if not repeat:
                return

    return rng, stream()


def _chunks(records: Iterator[bytes], n: int, limit: int | None):
    count = 0
    while limit is None or count < limit:
        chunk = [rec for _, rec in zip(range(n), records)]
        if not chunk:
            return
        yield chunk
        count += 1


def raw_train_batches(files, batch_size: int, size: int, *, seed: int,
                      steps: int | None, augment: str = "tf",
                      device_aug: bool = False, rank: int = 0,
                      world: int = 1, shuffle_buffer: int = 10_000):
    """Training batches of the raw-crop shards: uint8 ``size``² crops at
    random offsets inside each stored frame, flipped and (``"pt"``)
    jittered on the host unless ``device_aug``; ``steps`` full batches
    (None: forever)."""
    rng, records = shuffled_records(files, seed=seed, rank=rank,
                                    world=world,
                                    shuffle_buffer=shuffle_buffer)
    for chunk in _chunks(records, batch_size, steps):
        if len(chunk) < batch_size:
            return
        parsed = [parse_raw_crop(r) for r in chunk]
        dims = np.array([f.shape[:2] for f, _ in parsed])
        if (dims < size).any():
            raise ValueError(f"a stored frame {dims.min(0)} is smaller "
                             f"than the crop {size}")
        u = rng.random((batch_size, 2))
        offs = np.minimum((u * (dims - size + 1)).astype(np.int64),
                          dims - size)
        images = np.stack([f[t:t + size, l:l + size]
                           for (f, _), (t, l) in zip(parsed, offs)])
        labels = np.array([lbl for _, lbl in parsed], np.int32)
        if not device_aug:
            flips = rng.random(batch_size) < 0.5
            images = host_augment(images, flips,
                                  _jitter(rng, batch_size, augment))
        yield {"image": images, "label": labels}


def raw_eval_batches(files, batch_size: int, size: int):
    """Evaluation batches of raw-crop shards, in file order: uint8 central
    ``size``² crops of each stored frame (the JAX ``make_raw_dataset(...,
    is_training=False)``), the last batch padded and masked."""
    records = (rec for path in sorted(files) for rec in read_records(path))
    for chunk in _chunks(records, batch_size, None):
        parsed = [parse_raw_crop(r) for r in chunk]
        crops = []
        for frame, _ in parsed:
            h, w = frame.shape[:2]
            top, left = (h - size) // 2, (w - size) // 2
            crops.append(frame[top:top + size, left:left + size])
        yield pad_partial_batch(
            {"image": np.stack(crops),
             "label": np.array([lbl for _, lbl in parsed], np.int32)},
            batch_size)


def _jitter(rng, n: int, augment: str) -> np.ndarray | None:
    """(n, 3) PIL-enhance factors U[max(0, 1 - a), 1 + a] for the PT
    lineage's jitter, else None."""
    if augment != "pt":
        return None
    return rng.uniform(max(0.0, 1.0 - PT_JITTER), 1.0 + PT_JITTER,
                       (n, 3)).astype(np.float32)


def jpeg_train_batches(files, batch_size: int, size: int, *, seed: int,
                       steps: int | None, augment: str = "tf",
                       device_aug: bool = False, rank: int = 0,
                       world: int = 1, shuffle_buffer: int = 10_000):
    """Training batches of the JPEG shards as :class:`PackedJpegBatch`:
    the device feed decodes, resizes, crops at the drawn offsets and,
    unless ``device_aug``, flips and (``"pt"``) jitters, to uint8."""
    rng, records = shuffled_records(files, seed=seed, rank=rank,
                                    world=world,
                                    shuffle_buffer=shuffle_buffer)
    for chunk in _chunks(records, batch_size, steps):
        if len(chunk) < batch_size:
            return
        blobs, labels = zip(*(parse_jpeg_record(r) for r in chunk))
        plan = {"crop_u": rng.random((batch_size, 2))}
        if not device_aug:
            plan["flips"] = rng.random(batch_size) < 0.5
            plan["jitter"] = _jitter(rng, batch_size, augment)
        yield PackedJpegBatch(blobs, labels, JpegPlan(
            size, resize_min_for(size), **plan))


def val_batches(files, batch_size: int, size: int, *, augment: str = "tf",
                rank: int = 0, world: int = 1):
    """Validation batches of the JPEG shards, in file order: central
    crops, float32 normalized, each process its row block of every
    global batch of ``batch_size``, padded to ``batch_size // world``
    with a ``mask``."""
    local = batch_size // world
    records = (rec for path in sorted(files) for rec in read_records(path))
    normalize = "torch" if augment == "pt" else "imagenet"
    for chunk in _chunks(records, batch_size, None):
        mine = chunk[rank * local:(rank + 1) * local]
        parsed = [parse_jpeg_record(r) for r in mine]
        yield PackedJpegBatch(
            [b for b, _ in parsed], [lbl for _, lbl in parsed],
            JpegPlan(size, resize_min_for(size), normalize=normalize,
                     pad_to=local))


def make_imagenet_data(
    data_dir: str, batch_size: int, size: int = 224, *,
    train_images: int = 1_281_167, augment: str = "tf",
    use_raw: bool | None = None, steps_per_epoch: int | None = None,
    device_aug: bool = False, shuffle_buffer: int = 10_000,
):
    """-> (train_data(epoch) -> iterator, val_data() -> iterator,
    steps_per_epoch), the JAX ``make_imagenet_data`` for one loader
    process.

    ``batch_size`` is the global batch; each process reads its share of
    the files at ``batch_size // world``. Training reads ``raw-train-*``
    when ``raw-train.meta.json`` says ``full_frame`` and ``size <
    stored``, else ``train-*`` JPEG: ``use_raw`` True demands the raw
    shards (raising without usable ones), False never reads them, None
    takes them when usable, with a notice. ``device_aug``: the host stage
    is the crop only, and the step must run ``DeviceAugment``."""
    d = Path(data_dir)
    steps = steps_per_epoch or train_images // batch_size
    rank, world = process_shard()
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} not divisible by "
                         f"{world} processes")
    local_bs = batch_size // world

    raw_stored = None
    raw_full = False
    meta_path = d / "raw-train.meta.json"
    if use_raw is not False and meta_path.exists():
        meta = json.loads(meta_path.read_text())
        raw_stored = meta.get("stored")
        # legacy shards stored only the center square: never auto-enable
        raw_full = bool(meta.get("full_frame"))
    have_raw = (raw_stored is not None and size < raw_stored
                and any(d.glob("raw-train-*")))
    if use_raw is True and not (have_raw and raw_full):
        raise FileNotFoundError(
            f"use_raw=True but no usable raw-train-* shards under {d} "
            f"(stored={raw_stored}, crop={size}, full_frame={raw_full}; "
            "legacy center-square shards must be rebuilt with full frames)")
    if have_raw and not raw_full:
        print(f"[data] raw-train-* shards under {d} are legacy center-square "
              f"records (no full_frame in {meta_path.name}): falling back to "
              "JPEG records; rebuild them with full frames to re-enable the "
              "fast path", flush=True)
        have_raw = False
    if have_raw and use_raw is None:
        print(f"[data] raw-frame fast path ENABLED (raw-train-* + "
              f"{meta_path.name}, stored={raw_stored}); pass use_raw=False / "
              "--no-raw to read the JPEG records instead", flush=True)
    train_files = sorted(d.glob("raw-train-*" if have_raw else "train-*"))
    val_files = sorted(d.glob("validation-*"))
    if not train_files:
        raise FileNotFoundError(f"no train-* records under {d}")
    reader = raw_train_batches if have_raw else jpeg_train_batches

    def train_data(epoch: int):
        return reader(train_files, local_bs, size, seed=epoch, steps=steps,
                      augment=augment, device_aug=device_aug, rank=rank,
                      world=world, shuffle_buffer=shuffle_buffer)

    def val_data():
        return val_batches(val_files, batch_size, size, augment=augment,
                           rank=rank, world=world)

    return train_data, val_data, steps

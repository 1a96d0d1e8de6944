"""GAN input pipelines, the twin of ``deepvision_tpu/data/gan.py``.

- :func:`synthetic_unpaired`: the JAX package's hermetic unpaired
  domains (bright squares in A, the same distribution colour-inverted in
  B), array for array.
- The CycleGAN record reader: ``trainA-*`` and ``trainB-*`` shards in
  the builders' schema (``image/encoded`` JPEG, ``deepvision_tpu/data/
  builders/gan.py``), each domain shuffled through a buffer and repeated
  forever, so that an epoch of ``steps_per_epoch`` batches cycles the
  shorter domain (the JAX reader's ``zip`` of two ``repeat()``\\ ed
  streams). The shuffle order is the port's own (numpy, from the
  epoch's seed), not tf.data's.

Each batch crosses packed (:class:`PackedUnpairedBatch`) and is decoded
on the device feed's side stream: nvJPEG on the card, PIL on the CPU
when the CPU is asked for (trap C14). Each image is resized to ``size +
30`` square (bilinear, half-pixel centres, no antialias:
``tf.image.resize``'s default, trap C9); then either the host's flip
and ``size``² crop, drawn by numpy from the epoch's seed (trap C6), and
[-1, 1], as the JAX ``_parse_and_augment``; or, with ``device_aug``, the
uint8 ``size + 30`` canvas crosses and the step crops, flips and
normalizes (``DeviceAugment("gan", crop=size, normalize="tanh")``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from deepvision_tpu_torch.data.image_io import wire_uint8
from deepvision_tpu_torch.data.imagenet import _chunks, shuffled_records
from deepvision_tpu_torch.data.jpeg import decode_images, pack, resize_bilinear
from deepvision_tpu_torch.data.tfrecord import decode_example

__all__ = ["CANVAS_MARGIN", "synthetic_unpaired", "parse_gan_record",
           "UnpairedPlan", "PackedUnpairedBatch", "train_batches",
           "make_cyclegan_data"]

# the resize canvas's margin over the crop (CycleGAN's 286 for 256)
CANVAS_MARGIN = 30
DOMAINS = ("a", "b")


def synthetic_unpaired(n: int = 64, size: int = 64, seed: int = 0):
    """Hermetic unpaired domains with a learnable mapping: domain A =
    bright squares, domain B = the same distribution colour-inverted."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0.0, 0.05, (n, size, size, 3)).astype(np.float32)
    b = rng.normal(0.0, 0.05, (n, size, size, 3)).astype(np.float32)
    for i in range(n):
        x1, y1 = rng.integers(4, size // 2, 2)
        w = rng.integers(size // 4, size // 2)
        a[i, y1:y1 + w, x1:x1 + w, :] += 0.9
        x1, y1 = rng.integers(4, size // 2, 2)
        b[i, y1:y1 + w, x1:x1 + w, :] -= 0.9
    return np.clip(a, -1, 1), np.clip(b, -1, 1)


def parse_gan_record(record) -> bytes:
    """One Example -> its JPEG bytes."""
    return decode_example(record)["image/encoded"][0]


@dataclasses.dataclass(frozen=True)
class UnpairedPlan:
    """What the decode stage does to each domain's images: the resize to
    ``size + CANVAS_MARGIN`` square, then, unless ``as_uint8``, the flips
    (``flips``: domain -> (B,) bool) and the crops (``offsets``: domain
    -> (B, 2) top and left) to ``size`` and [-1, 1]; with ``as_uint8``
    the canvas as the uint8 wire."""

    size: int
    flips: dict | None = None
    offsets: dict | None = None
    as_uint8: bool = False


class PackedUnpairedBatch(dict):
    """A batch of both domains' JPEGs as it crosses to the device:
    ``jpeg_a``/``offsets_a`` and ``jpeg_b``/``offsets_b`` (packed bytes),
    decoded on the device feed's side stream by :meth:`decode` into
    ``{"a", "b"}`` image batches."""

    wire_dtype = "jpeg"

    def __init__(self, blobs: dict, plan: UnpairedPlan):
        fields = {}
        for d in DOMAINS:
            fields[f"jpeg_{d}"], fields[f"offsets_{d}"] = pack(blobs[d])
        super().__init__(**fields)
        self.plan = plan

    @property
    def n_images(self) -> int:
        return sum(len(self[f"offsets_{d}"]) - 1 for d in DOMAINS)

    @property
    def image_bytes(self) -> int:
        return sum(int(self[f"jpeg_{d}"].nbytes) for d in DOMAINS)

    def decode(self, device: torch.device) -> dict:
        device = torch.device(device)
        plan = self.plan
        canvas = plan.size + CANVAS_MARGIN
        out = {}
        for d in DOMAINS:
            images = []
            for i, img in enumerate(decode_images(
                    self[f"jpeg_{d}"], self[f"offsets_{d}"], device)):
                if plan.flips is not None and plan.flips[d][i]:
                    img = img.flip(1)
                img = resize_bilinear(img, canvas, canvas)
                if plan.offsets is not None:
                    top, left = (int(v) for v in plan.offsets[d][i])
                    img = img[top:top + plan.size, left:left + plan.size]
                images.append(img)
            x = torch.stack(images)
            out[d] = wire_uint8(x) if plan.as_uint8 else x / 127.5 - 1.0
        return out


def train_batches(files_a, files_b, batch_size: int, size: int, *,
                  seed: int, steps: int | None, device_aug: bool = False,
                  shuffle_buffer: int = 1000):
    """``steps`` (None: forever) training batches of both domains, each
    domain's records shuffled and repeated from its own stream of
    ``seed``; the flips and crop offsets (without ``device_aug``) drawn
    by numpy from ``seed``."""
    # each domain its own record stream: seeds 2·seed and 2·seed + 1
    streams = {d: shuffled_records(files, seed=2 * seed + i,
                                   shuffle_buffer=shuffle_buffer)[1]
               for i, (d, files) in enumerate(zip(DOMAINS,
                                                  (files_a, files_b)))}
    rng = np.random.default_rng(np.random.SeedSequence(seed,
                                                       spawn_key=(2,)))
    chunks = {d: _chunks(s, batch_size, steps) for d, s in streams.items()}
    for parts in zip(*chunks.values()):
        blobs = {d: [parse_gan_record(r) for r in part]
                 for d, part in zip(DOMAINS, parts)}
        if device_aug:
            plan = UnpairedPlan(size, as_uint8=True)
        else:
            plan = UnpairedPlan(
                size,
                flips={d: rng.random(batch_size) < 0.5 for d in DOMAINS},
                offsets={d: rng.integers(0, CANVAS_MARGIN + 1,
                                         (batch_size, 2))
                         for d in DOMAINS})
        yield PackedUnpairedBatch(blobs, plan)


def make_cyclegan_data(data_dir: str, batch_size: int, size: int = 256, *,
                       steps_per_epoch: int, device_aug: bool = False):
    """-> ``train_data(epoch)``, an iterator of ``steps_per_epoch``
    packed ``{"a", "b"}`` batches of ``{data_dir}/trainA-*`` and
    ``trainB-*``."""
    d = Path(data_dir)
    files = {dom: sorted(d.glob(f"train{dom.upper()}-*")) for dom in DOMAINS}
    for dom, found in files.items():
        if not found:
            raise FileNotFoundError(
                f"no train{dom.upper()}-* records under {d}")

    def train_data(epoch: int):
        return train_batches(files["a"], files["b"], batch_size, size,
                             seed=epoch, steps=steps_per_epoch,
                             device_aug=device_aug)

    return train_data

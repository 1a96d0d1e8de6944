"""Pre-decoded raw-frame shards, the twin of
``deepvision_tpu/data/builders/raw_crops.py``.

Each reference-schema JPEG record becomes ``image/raw``: the full
aspect-preserving resize, shorter side ``stored``, as uint8 bytes, with
``image/height``, ``image/width`` and ``image/class/label``; the long
side is centre-cropped to ``round(stored · max_aspect)``. The training
reader (``data/imagenet.raw_train_batches``) then parses and crops, with
no JPEG work. The JAX builder decodes and resizes with TensorFlow; the
port decodes with ``data/jpeg.decode_images`` (nvJPEG on the card, PIL
on the CPU) and resizes with ``data/jpeg.resize_bilinear`` at
``data/jpeg.resize_dims``'s float32 target (tf's arithmetic, trap C9),
then rounds half to even and clips (``wire_uint8``). tf's default decode
is libjpeg's fast IDCT, PIL's and nvJPEG's the accurate one: the frames
differ from the JAX builder's by a few uint8 steps (traps C14, C15).
A ``raw-<split>.meta.json`` sidecar records ``stored``, the count and
``full_frame``.
"""

from __future__ import annotations

import json
from functools import partial
from pathlib import Path

import torch

__all__ = ["jpeg_record_to_raw", "build_raw_crops"]


def jpeg_record_to_raw(serialized: bytes, stored: int,
                       max_aspect: float = 2.0,
                       device: str = "cpu") -> dict:
    """One reference-schema JPEG Example -> the raw-frame features."""
    from deepvision_tpu_torch.data.image_io import wire_uint8
    from deepvision_tpu_torch.data.jpeg import (
        decode_images,
        pack,
        resize_bilinear,
        resize_dims,
    )
    from deepvision_tpu_torch.data.tfrecord import decode_example

    feats = decode_example(serialized)
    packed, offsets = pack([feats["image/encoded"][0]])
    (image,) = decode_images(packed, offsets, torch.device(device))
    new_h, new_w = resize_dims(image.shape[0], image.shape[1], stored)
    image = resize_bilinear(image, new_h, new_w)
    cap = int(round(stored * max_aspect))
    keep_h, keep_w = min(new_h, cap), min(new_w, cap)
    top, left = (new_h - keep_h) // 2, (new_w - keep_w) // 2
    raw = wire_uint8(image[top:top + keep_h, left:left + keep_w])
    return {
        "image/raw": [raw.cpu().numpy().tobytes()],
        "image/class/label": [int(feats["image/class/label"][0])],
        "image/height": [keep_h],
        "image/width": [keep_w],
    }


def build_raw_crops(jpeg_dir: str | Path, output_dir: str | Path, *,
                    split: str = "train", stored: int = 256,
                    num_shards: int = 64, num_workers: int = 8,
                    device: str = "cuda") -> int:
    """Reference-schema JPEG shards (``<split>-*``) -> raw-crop shards
    (``raw-<split>-*``) and their sidecar. Returns the record count.
    ``device`` decodes and resizes (``"cuda"``, the default, raises
    without a card)."""
    from deepvision_tpu_torch.data.builders.shard_writer import write_sharded
    from deepvision_tpu_torch.data.tfrecord import read_records
    from deepvision_tpu_torch.device import resolve_device

    device = resolve_device(device)
    files = sorted(Path(jpeg_dir).glob(f"{split}-*"))
    if not files:
        raise FileNotFoundError(f"no {split}-* records under {jpeg_dir}")
    items = [rec for f in files for rec in read_records(f)]
    written = write_sharded(
        items, partial(jpeg_record_to_raw, stored=stored, device=str(device)),
        output_dir, f"raw-{split}", num_shards=num_shards,
        num_workers=num_workers)
    # named with '.' so that the 'raw-<split>-*' shard glob misses it
    (Path(output_dir) / f"raw-{split}.meta.json").write_text(
        json.dumps({"stored": stored, "count": written, "full_frame": True}))
    return written

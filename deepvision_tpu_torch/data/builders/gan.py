"""CycleGAN unpaired-image records and the CelebA attribute splitter, the
twins of ``deepvision_tpu/data/builders/gan.py``.

- :func:`build_cyclegan_tfrecords`: ``trainA``/``trainB``/``testA``/
  ``testB`` image folders (``.jpg``, ``.jpeg``, ``.png``) -> image-only
  records (``image/encoded``, height, width, filename), each image
  repaired to RGB JPEG on the builder's device;
- :func:`split_celeba_by_attribute`: ``img_align_celeba`` and
  ``list_attr_celeba.txt`` -> ``trainA`` (attribute -1) and ``trainB``
  (+1) file trees.
"""

from __future__ import annotations

import shutil
from functools import partial
from pathlib import Path

from deepvision_tpu_torch.data.builders.shard_writer import write_sharded
from deepvision_tpu_torch.data.image_io import ensure_rgb_jpeg

__all__ = ["build_cyclegan_tfrecords", "split_celeba_by_attribute"]


def _image_features(path: Path, device: str = "cpu") -> dict:
    data, width, height = ensure_rgb_jpeg(path.read_bytes(), device)
    return {
        "image/encoded": [data],
        "image/height": [height],
        "image/width": [width],
        "image/filename": [path.name.encode()],
    }


def build_cyclegan_tfrecords(
    data_root: str | Path, output_dir: str | Path,
    *, num_shards: int = 4, num_workers: int = 4, device: str = "cuda",
) -> dict[str, int]:
    """data_root holds trainA/trainB/testA/testB image folders; returns
    the records written by split. ``device`` repairs the images
    (``"cuda"``, the default, raises without a card)."""
    from deepvision_tpu_torch.device import resolve_device

    device = resolve_device(device)
    counts = {}
    for split in ("trainA", "trainB", "testA", "testB"):
        d = Path(data_root) / split
        if not d.is_dir():
            continue
        files = sorted(p for p in d.iterdir()
                       if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
        counts[split] = write_sharded(
            files, partial(_image_features, device=str(device)), output_dir,
            split, num_shards=num_shards, num_workers=num_workers)
    return counts


def split_celeba_by_attribute(
    celeba_dir: str | Path, attr_file: str | Path, output_root: str | Path,
    *, attribute: str = "Male", limit_per_side: int | None = None,
) -> tuple[int, int]:
    """img_align_celeba + list_attr_celeba.txt -> trainA (attr=-1) /
    trainB (attr=+1) file trees; returns the files copied to each."""
    lines = Path(attr_file).read_text().splitlines()
    header = lines[1].split()
    col = header.index(attribute)
    out_a = Path(output_root) / "trainA"
    out_b = Path(output_root) / "trainB"
    out_a.mkdir(parents=True, exist_ok=True)
    out_b.mkdir(parents=True, exist_ok=True)
    n_a = n_b = 0
    for line in lines[2:]:
        parts = line.split()
        if not parts:
            continue
        name, value = parts[0], int(parts[1 + col])
        src = Path(celeba_dir) / name
        if not src.exists():
            continue
        if value < 0 and (limit_per_side is None or n_a < limit_per_side):
            shutil.copy(src, out_a / name)
            n_a += 1
        elif value > 0 and (limit_per_side is None or n_b < limit_per_side):
            shutil.copy(src, out_b / name)
            n_b += 1
    return n_a, n_b

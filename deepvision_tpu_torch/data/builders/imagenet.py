"""ILSVRC2012 TFRecord builder, the twin of
``deepvision_tpu/data/builders/imagenet.py``.

Input: the flattened layout, ``<synset>_<name>.JPEG`` in one directory.
Each record follows the reference schema: ``image/encoded``,
``image/height`` and ``image/width``, ``image/colorspace`` (RGB),
``image/channels`` (3), ``image/format`` (JPEG), ``image/class/label``
(1-based), ``image/class/synset``, ``image/class/text``,
``image/filename`` and, where the bounding-box CSV has boxes for the
file, ``image/object/bbox/{xmin,ymin,xmax,ymax,label}``. A grayscale or
CMYK JPEG, or a PNG under a ``.JPEG`` name, is re-encoded as an RGB JPEG
(``data/image_io.ensure_rgb_jpeg``: PIL on the CPU, nvJPEG on the card);
a file that cannot be converted is left out and reported by name. The
default shard counts are 1024 (train) and 128 (other splits).
"""

from __future__ import annotations

from pathlib import Path

from deepvision_tpu_torch.data.builders.shard_writer import write_sharded
from deepvision_tpu_torch.data.folder import load_synset_maps
from deepvision_tpu_torch.data.image_io import ensure_rgb_jpeg

__all__ = ["ImageNetFeatures", "load_bbox_csv", "build_imagenet_tfrecords"]


class ImageNetFeatures:
    """The features of one image file; a module-level class, so that the
    spawn pool can pickle it into its workers."""

    def __init__(self, wnid_to_idx, human_map, bboxes, device: str = "cpu"):
        self.wnid_to_idx = wnid_to_idx
        self.human_map = human_map
        self.bboxes = bboxes
        self.device = str(device)

    def __call__(self, path: Path) -> dict:
        data, width, height = ensure_rgb_jpeg(path.read_bytes(), self.device)
        synset = path.name.split("_")[0]
        label = self.wnid_to_idx[synset] + 1  # 1-based, the reference's
        feats = {
            "image/encoded": [data],
            "image/height": [height],
            "image/width": [width],
            "image/colorspace": [b"RGB"],
            "image/channels": [3],
            "image/format": [b"JPEG"],
            "image/class/label": [label],
            "image/class/synset": [synset.encode()],
            "image/class/text": [self.human_map.get(synset, "").encode()],
            "image/filename": [path.name.encode()],
        }
        boxes = self.bboxes.get(path.name, [])
        if boxes:
            for i, key in enumerate(("xmin", "ymin", "xmax", "ymax")):
                feats[f"image/object/bbox/{key}"] = [float(b[i])
                                                     for b in boxes]
            feats["image/object/bbox/label"] = [label] * len(boxes)
        return feats


def load_bbox_csv(csv_path: str | Path) -> dict[str, list]:
    """The bounding-box CSV (``builders/imagenet_bbox.py``:
    ``filename,xmin,ymin,xmax,ymax`` normalized to [0, 1]) -> boxes by
    file name; {} when the file does not exist."""
    out: dict[str, list] = {}
    p = Path(csv_path)
    if not p.exists():
        return out
    for line in p.read_text().splitlines():
        parts = line.strip().split(",")
        if len(parts) != 5:
            continue
        name, *coords = parts
        out.setdefault(name, []).append([float(c) for c in coords])
    return out


def build_imagenet_tfrecords(
    image_dir: str | Path, synsets_file: str | Path, output_dir: str | Path,
    split: str = "train", *, human_labels_file: str | Path | None = None,
    bbox_csv: str | Path | None = None, num_shards: int | None = None,
    num_workers: int = 16, device: str = "cuda",
) -> int:
    """Write the ``<split>-*`` shards of every ``*.JPEG`` under
    ``image_dir``; returns the records written. ``device`` re-encodes
    the files that need it (``"cuda"``, the default, raises without a
    card)."""
    from deepvision_tpu_torch.device import resolve_device

    device = resolve_device(device)
    wnid_to_idx, _ = load_synset_maps(synsets_file)
    human_map = {}
    if human_labels_file and Path(human_labels_file).exists():
        for line in Path(human_labels_file).read_text().splitlines():
            if "\t" in line:
                wnid, text = line.split("\t", 1)
                human_map[wnid] = text.strip()
    bboxes = load_bbox_csv(bbox_csv) if bbox_csv else {}
    if num_shards is None:
        num_shards = 1024 if split == "train" else 128
    files = sorted(Path(image_dir).glob("*.JPEG"))
    return write_sharded(
        files, ImageNetFeatures(wnid_to_idx, human_map, bboxes, device),
        output_dir, split, num_shards=num_shards, num_workers=num_workers)

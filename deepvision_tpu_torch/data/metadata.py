"""Dataset metadata: the ImageNet synsets and names, the validation
labels and the detection class names, the twin of
``deepvision_tpu/data/metadata.py``.

The assets are the port's own copies under ``data/assets/``:
``imagenet_synsets.txt`` (1000 lines ``wnid name[, name...]``, line i is
label i, 1-based in the records), ``imagenet_val_labels.txt`` (the
50,000 validation images' synsets in sorted file order), and the VOC
(20) and MSCOCO (80) name lists.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

__all__ = ["ASSETS", "imagenet_synsets", "imagenet_wnid_to_index",
           "imagenet_label_name", "imagenet_val_synsets", "class_names"]

ASSETS = Path(__file__).resolve().parent / "assets"


@lru_cache(maxsize=None)
def imagenet_synsets() -> list[tuple[str, str]]:
    """1000 ``(wnid, human name)`` pairs in label order (label i in
    [0, 999] is entry i)."""
    out = []
    for line in (ASSETS / "imagenet_synsets.txt").read_text().splitlines():
        wnid, _, name = line.partition(" ")
        out.append((wnid, name))
    return out


@lru_cache(maxsize=None)
def imagenet_wnid_to_index() -> dict[str, int]:
    """wnid -> 0-based label."""
    return {w: i for i, (w, _) in enumerate(imagenet_synsets())}


def imagenet_label_name(index: int) -> str:
    """0-based label -> its human-readable name."""
    return imagenet_synsets()[index][1]


@lru_cache(maxsize=None)
def imagenet_val_synsets() -> list[str]:
    """The synset of each of the 50,000 validation images, in sorted file
    name order."""
    return (ASSETS / "imagenet_val_labels.txt").read_text().split()


@lru_cache(maxsize=None)
def class_names(dataset: str) -> list[str]:
    """Detection class names: ``voc`` (20) or ``mscoco`` (80)."""
    path = ASSETS / f"{'voc' if dataset == 'voc' else 'mscoco'}_names.txt"
    return path.read_text().splitlines()

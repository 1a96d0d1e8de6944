"""MPII keypoint TFRecord builder, the twin of
``deepvision_tpu/data/builders/pose.py``.

One record a person: 16 joints as x and y normalized by the image size
(floats) and visibility (int64), a missing or negative joint stored as
visibility 0 at (0, 0); the person's centre (normalized) and scale.
Images are repaired to RGB JPEG by ``data/image_io.ensure_rgb_jpeg`` on
the builder's device; an image that cannot be converted is left out and
reported by name.
"""

from __future__ import annotations

import json
from functools import partial
from pathlib import Path

from deepvision_tpu_torch.data.builders.shard_writer import write_sharded
from deepvision_tpu_torch.data.image_io import ensure_rgb_jpeg

__all__ = ["MPII_NUM_JOINTS", "build_mpii_tfrecords"]

MPII_NUM_JOINTS = 16


def _pose_features(item: dict, device: str = "cpu") -> dict:
    path = Path(item["image_path"])
    data, width, height = ensure_rgb_jpeg(path.read_bytes(), device)
    xs, ys, vs = [], [], []
    joints = {int(j["id"]): j for j in item["joints"]}
    for jid in range(MPII_NUM_JOINTS):
        j = joints.get(jid)
        if j is None or j["x"] < 0 or j["y"] < 0:
            xs.append(0.0)
            ys.append(0.0)
            vs.append(0)
        else:
            xs.append(float(j["x"]) / width)
            ys.append(float(j["y"]) / height)
            vs.append(int(j.get("visible", 1)))
    return {
        "image/encoded": [data],
        "image/height": [height],
        "image/width": [width],
        "image/filename": [path.name.encode()],
        "image/person/center/x": [float(item["center"][0]) / width],
        "image/person/center/y": [float(item["center"][1]) / height],
        "image/person/scale": [float(item["scale"])],
        "image/person/keypoints/x": xs,
        "image/person/keypoints/y": ys,
        "image/person/keypoints/v": vs,
    }


def build_mpii_tfrecords(
    images_dir: str | Path, annotations_json: str | Path,
    output_dir: str | Path, split: str = "train",
    *, num_shards: int = 64, num_workers: int = 8, device: str = "cuda",
) -> int:
    """annotations_json: a list of ``{image, joints: [{id, x, y,
    visible}], center: [x, y], scale}`` (the common MPII JSON export).
    ``device`` repairs the images (``"cuda"``, the default, raises
    without a card)."""
    from deepvision_tpu_torch.device import resolve_device

    device = resolve_device(device)
    anns = json.loads(Path(annotations_json).read_text())
    items = [{**a, "image_path": str(Path(images_dir) / a["image"])}
             for a in anns]
    return write_sharded(
        items, partial(_pose_features, device=str(device)), output_dir,
        split, num_shards=num_shards, num_workers=num_workers)

"""VOC and MSCOCO detection TFRecord builders, the twins of
``deepvision_tpu/data/builders/detection.py``.

VOC: the XML annotations, boxes divided by the image size and clamped to
[0, 1], the split from ``ImageSets/Main/<split>.txt``. COCO: the
instances JSON, crowd annotations left out, labels 1..80 in category-id
order. Schema (both): ``image/encoded``, ``image/height`` and
``image/width``, ``image/filename``, the object lists
``image/object/bbox/{xmin,ymin,xmax,ymax}`` (normalized floats),
``image/object/class/text`` and ``/label`` (1-based) and
``image/object/count``. Images are repaired to RGB JPEG by
``data/image_io.ensure_rgb_jpeg`` on the builder's device; an image that
cannot be converted is left out and reported by name.
"""

from __future__ import annotations

import json
import xml.etree.ElementTree as ET
from functools import partial
from pathlib import Path

from deepvision_tpu_torch.data.builders.shard_writer import write_sharded
from deepvision_tpu_torch.data.image_io import ensure_rgb_jpeg
from deepvision_tpu_torch.data.tfrecord import BytesList, FloatList, Int64List

__all__ = ["VOC_CLASSES", "parse_voc_xml", "build_voc_tfrecords",
           "build_coco_tfrecords"]

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def parse_voc_xml(xml_path: Path) -> dict:
    """One annotation file -> {filename, width, height, objects:[...]}."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    width = int(size.find("width").text)
    height = int(size.find("height").text)
    objects = []
    for obj in root.findall("object"):
        box = obj.find("bndbox")
        name = obj.find("name").text
        xmin = float(box.find("xmin").text) / width
        ymin = float(box.find("ymin").text) / height
        xmax = float(box.find("xmax").text) / width
        ymax = float(box.find("ymax").text) / height
        # clamped to [0, 1] (the reference asserted the range)
        xmin, ymin = max(0.0, xmin), max(0.0, ymin)
        xmax, ymax = min(1.0, xmax), min(1.0, ymax)
        objects.append({
            "name": name, "label": VOC_CLASSES.index(name) + 1,
            "xmin": xmin, "ymin": ymin, "xmax": xmax, "ymax": ymax,
        })
    return {
        "filename": root.find("filename").text,
        "width": width, "height": height, "objects": objects,
    }


def _detection_features(item, device: str = "cpu") -> dict:
    """(image path, annotation) -> the record's features."""
    image_path, ann = item
    data, _, _ = ensure_rgb_jpeg(Path(image_path).read_bytes(), device)
    objs = ann["objects"]
    return {
        "image/encoded": [data],
        "image/height": [ann["height"]],
        "image/width": [ann["width"]],
        "image/filename": [ann["filename"].encode()],
        # typed lists: images with no objects keep the FloatList/… wire type
        "image/object/bbox/xmin": FloatList(o["xmin"] for o in objs),
        "image/object/bbox/ymin": FloatList(o["ymin"] for o in objs),
        "image/object/bbox/xmax": FloatList(o["xmax"] for o in objs),
        "image/object/bbox/ymax": FloatList(o["ymax"] for o in objs),
        "image/object/class/text": BytesList(
            o["name"].encode() for o in objs
        ),
        "image/object/class/label": Int64List(o["label"] for o in objs),
        "image/object/count": [len(objs)],
    }


def build_voc_tfrecords(
    voc_root: str | Path, output_dir: str | Path, split: str = "train",
    *, num_shards: int = 16, num_workers: int = 8, device: str = "cuda",
) -> int:
    """voc_root = .../VOCdevkit/VOC2007; splits from ImageSets/Main.
    ``device`` repairs the images (``"cuda"``, the default, raises
    without a card)."""
    from deepvision_tpu_torch.device import resolve_device

    device = resolve_device(device)
    root = Path(voc_root)
    names = (root / "ImageSets" / "Main" / f"{split}.txt").read_text().split()
    items = []
    for name in names:
        ann = parse_voc_xml(root / "Annotations" / f"{name}.xml")
        items.append((root / "JPEGImages" / f"{name}.jpg", ann))
    return write_sharded(
        items, partial(_detection_features, device=str(device)), output_dir,
        split, num_shards=num_shards, num_workers=num_workers)


def build_coco_tfrecords(
    images_dir: str | Path, instances_json: str | Path,
    output_dir: str | Path, split: str = "train",
    *, num_shards: int = 64, num_workers: int = 8, device: str = "cuda",
) -> int:
    """COCO2017 instances -> detection records (64 shards by default);
    ``device`` as for :func:`build_voc_tfrecords`."""
    from deepvision_tpu_torch.device import resolve_device

    device = resolve_device(device)
    meta = json.loads(Path(instances_json).read_text())
    cats = {c["id"]: c["name"] for c in meta["categories"]}
    # contiguous label ids 1..80 in category-id order
    cat_to_label = {cid: i + 1 for i, cid in enumerate(sorted(cats))}
    images = {im["id"]: im for im in meta["images"]}
    anns_by_img: dict[int, list] = {}
    for a in meta["annotations"]:
        if a.get("iscrowd"):
            continue
        anns_by_img.setdefault(a["image_id"], []).append(a)
    items = []
    for img_id, im in images.items():
        objs = []
        for a in anns_by_img.get(img_id, []):
            x, y, w, h = a["bbox"]
            objs.append({
                "name": cats[a["category_id"]],
                "label": cat_to_label[a["category_id"]],
                "xmin": max(0.0, x / im["width"]),
                "ymin": max(0.0, y / im["height"]),
                "xmax": min(1.0, (x + w) / im["width"]),
                "ymax": min(1.0, (y + h) / im["height"]),
            })
        ann = {"filename": im["file_name"], "width": im["width"],
               "height": im["height"], "objects": objs}
        items.append((Path(images_dir) / im["file_name"], ann))
    return write_sharded(
        items, partial(_detection_features, device=str(device)), output_dir,
        split, num_shards=num_shards, num_workers=num_workers)

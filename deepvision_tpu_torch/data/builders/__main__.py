"""The dataset builders from the command line.

    python -m deepvision_tpu_torch.data.builders imagenet IMAGE_DIR \
        SYNSETS OUT [--split train] [--bbox-csv CSV] [--human-labels TXT]
    python -m deepvision_tpu_torch.data.builders raw JPEG_DIR OUT \
        [--split train] [--stored 256]
    python -m deepvision_tpu_torch.data.builders bbox ANNOTATIONS_DIR CSV
    python -m deepvision_tpu_torch.data.builders voc VOC_ROOT OUT [--split]
    python -m deepvision_tpu_torch.data.builders coco IMAGES JSON OUT [--split]
    python -m deepvision_tpu_torch.data.builders mpii IMAGES JSON OUT [--split]
    python -m deepvision_tpu_torch.data.builders cyclegan ROOT OUT
    python -m deepvision_tpu_torch.data.builders celeba CELEBA_DIR ATTRS OUT \
        [--attribute Male] [--limit N]

Each shard builder takes ``--shards`` and ``--workers`` (the spawn pool;
1 writes in this process) and ``--device``: ``cuda`` (the default,
raises without a card) re-encodes the odd image with nvJPEG and decodes
the raw crops on the card, ``cpu`` with PIL. Each prints a ``[build]``
line a split to stderr, naming every file it left out and why, and the
count as JSON to stdout.
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["main"]


def main(argv=None) -> int:
    from deepvision_tpu_torch.data.builders import (
        detection,
        gan,
        imagenet,
        imagenet_bbox,
        pose,
        raw_crops,
    )

    p = argparse.ArgumentParser(
        prog="python -m deepvision_tpu_torch.data.builders",
        description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="command", required=True)

    def shards(sp, n_shards, n_workers):
        sp.add_argument("--shards", type=int, default=n_shards)
        sp.add_argument("--workers", type=int, default=n_workers)
        sp.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")

    sp = sub.add_parser("imagenet", help="flattened ImageNet -> records")
    for a in ("image_dir", "synsets", "out"):
        sp.add_argument(a)
    sp.add_argument("--split", default="train")
    sp.add_argument("--bbox-csv", default=None)
    sp.add_argument("--human-labels", default=None)
    shards(sp, None, 16)
    sp = sub.add_parser("raw", help="JPEG records -> raw-crop records")
    sp.add_argument("jpeg_dir")
    sp.add_argument("out")
    sp.add_argument("--split", default="train")
    sp.add_argument("--stored", type=int, default=256)
    shards(sp, 64, 8)
    sp = sub.add_parser("bbox", help="bounding-box XML tree -> CSV")
    sp.add_argument("annotations_dir")
    sp.add_argument("csv")
    sp = sub.add_parser("voc", help="VOC tree -> detection records")
    sp.add_argument("root")
    sp.add_argument("out")
    sp.add_argument("--split", default="train")
    shards(sp, 16, 8)
    for name, help_ in (("coco", "COCO instances -> detection records"),
                        ("mpii", "MPII JSON -> pose records")):
        sp = sub.add_parser(name, help=help_)
        for a in ("images", "json", "out"):
            sp.add_argument(a)
        sp.add_argument("--split", default="train")
        shards(sp, 64, 8)
    sp = sub.add_parser("cyclegan", help="trainA/B, testA/B -> records")
    sp.add_argument("root")
    sp.add_argument("out")
    shards(sp, 4, 4)
    sp = sub.add_parser("celeba", help="CelebA -> trainA/trainB by an "
                                       "attribute")
    for a in ("celeba_dir", "attrs", "out"):
        sp.add_argument(a)
    sp.add_argument("--attribute", default="Male")
    sp.add_argument("--limit", type=int, default=None)
    a = p.parse_args(argv)

    pool = ({"num_shards": a.shards, "num_workers": a.workers,
             "device": a.device} if hasattr(a, "shards") else {})
    if a.command == "imagenet":
        out = imagenet.build_imagenet_tfrecords(
            a.image_dir, a.synsets, a.out, a.split, bbox_csv=a.bbox_csv,
            human_labels_file=a.human_labels, **pool)
    elif a.command == "raw":
        out = raw_crops.build_raw_crops(a.jpeg_dir, a.out, split=a.split,
                                        stored=a.stored, **pool)
    elif a.command == "bbox":
        out = imagenet_bbox.process_bounding_boxes(a.annotations_dir, a.csv)
    elif a.command == "voc":
        out = detection.build_voc_tfrecords(a.root, a.out, a.split, **pool)
    elif a.command == "coco":
        out = detection.build_coco_tfrecords(a.images, a.json, a.out,
                                             a.split, **pool)
    elif a.command == "mpii":
        out = pose.build_mpii_tfrecords(a.images, a.json, a.out, a.split,
                                        **pool)
    elif a.command == "cyclegan":
        out = gan.build_cyclegan_tfrecords(a.root, a.out, **pool)
    else:
        out = gan.split_celeba_by_attribute(a.celeba_dir, a.attrs, a.out,
                                            attribute=a.attribute,
                                            limit_per_side=a.limit)
    print(json.dumps({"command": a.command, "written": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

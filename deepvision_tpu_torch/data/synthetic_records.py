"""Small synthetic record directories, in the reference builders'
schemas, for drives and tests of the record readers (``data/imagenet.py``;
with ``--detection``, ``data/detection.py``; with ``--pose``,
``data/pose.py``; with ``--gan``, ``data/gan.py``).

    python -m deepvision_tpu_torch.data.synthetic_records DIR \\
        [--train 64] [--val 16] [--raw 64] [--classes 5] [--device cuda|cpu]
    python -m deepvision_tpu_torch.data.synthetic_records DIR --detection \\
        [--train 64] [--val 16] [--classes 20] [--device cuda|cpu]
    python -m deepvision_tpu_torch.data.synthetic_records DIR --pose \\
        [--train 64] [--val 16] [--device cuda|cpu]
    python -m deepvision_tpu_torch.data.synthetic_records DIR --gan \\
        [--train 64] [--val 16] [--device cuda|cpu]

writes ``train-*`` and ``validation-*`` JPEG shards and, with ``--raw``,
``raw-train-*`` raw-frame shards of the full shorter-side-``stored``
frame (256 by 256 to 512, either way round) with their
``raw-train.meta.json`` sidecar. Images are smooth random fields tinted
by class, made from ``--seed``; labels are 1-indexed on disk, as the
reference builder writes them. ``--detection`` writes ``train-*`` and
``val-*`` shards in the detection builder's schema (``image/encoded``,
``image/height``, ``image/width``, ``image/object/bbox/{xmin,ymin,xmax,
ymax}``, ``image/object/class/label`` 1-based, ``image/object/count``):
images of sides 300 to 500, each with 1-3 filled rectangles whose colour
encodes the class, on a dim noisy field. ``--pose`` writes ``train-*``
and ``val-*`` shards in the pose builder's schema (``image/encoded``,
``image/height``, ``image/width``, ``image/filename``,
``image/person/center/{x,y}`` and ``image/person/scale``,
``image/person/keypoints/{x,y}`` normalized to the image and
``image/person/keypoints/v``, 16 joints, the absent ones at (0, 0) with
v = 0): images of sides 300 to 500, one person a record whose visible
joints are bright squares in the channel ``joint % 3``. ``--gan`` writes
``trainA-*``, ``trainB-*``, ``testA-*`` and ``testB-*`` shards in the
CycleGAN builder's schema (``image/encoded``, ``image/height``,
``image/width``, ``image/filename``), ``--train`` and ``--val`` images a
domain, of sides 286 to 400 (CycleGAN's 256 crop of its 286 canvas):
domain A a bright square on a mid-grey noisy field, domain B a dark one,
the unpaired pair of ``data/gan.synthetic_unpaired``. It runs on the card
(``--device cuda``, the default, which raises without one; JPEGs are
encoded by nvJPEG), and on the CPU when asked (``--device cpu``; JPEGs
are encoded by PIL).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from deepvision_tpu_torch.data.jpeg import encode_images
from deepvision_tpu_torch.data.tfrecord import (
    FloatList,
    Int64List,
    encode_example,
    write_records,
)
from deepvision_tpu_torch.device import resolve_device

__all__ = ["synthetic_image", "write_synthetic_imagenet",
           "detection_image", "write_synthetic_detection", "pose_image",
           "write_synthetic_pose", "gan_image", "write_synthetic_gan",
           "main"]


def synthetic_image(rng: np.random.Generator, h: int, w: int, label: int,
                    device: torch.device) -> torch.Tensor:
    """A uint8 (h, w, 3) image on ``device``: an 8x8 random field
    upsampled bilinearly, tinted by ``label``, with mild noise."""
    low = torch.from_numpy(rng.uniform(0, 255, (1, 3, 8, 8)).astype(
        np.float32)).to(device)
    x = F.interpolate(low, size=(h, w), mode="bilinear",
                      align_corners=False)[0].permute(1, 2, 0)
    tint = torch.tensor([(label * 53) % 256, (label * 101) % 256,
                         (label * 29) % 256], dtype=torch.float32,
                        device=device)
    noise = torch.from_numpy(rng.normal(0, 6, (h, w, 3)).astype(
        np.float32)).to(device)
    return (0.6 * x + 0.4 * tint + noise).round().clamp(0, 255).to(
        torch.uint8)


def _shards(out: Path, prefix: str, records: list[bytes], shards: int):
    n = max(1, min(shards, len(records)))
    for i in range(n):
        write_records(out / f"{prefix}-{i:05d}-of-{n:05d}",
                      records[i::n])


def _sizes(rng, n: int, lo: int, hi: int):
    return [(int(rng.integers(lo, hi + 1)), int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def write_synthetic_imagenet(out_dir, *, train: int = 64, val: int = 16,
                             raw: int = 0, classes: int = 5, shards: int = 2,
                             stored: int = 256, jpeg_sizes=(160, 400),
                             seed: int = 0,
                             device: torch.device | str = "cuda") -> dict:
    """Write the record directory, with the images made and encoded on
    ``device`` (``"cuda"``, raising without a card, or ``"cpu"``);
    returns the counts written."""
    device = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    def jpeg_records(n):
        labels = rng.integers(0, classes, n)
        images = [synthetic_image(rng, h, w, int(lbl), device)
                  for (h, w), lbl in zip(_sizes(rng, n, *jpeg_sizes), labels)]
        return [encode_example({"image/encoded": [blob],
                                "image/class/label": [int(lbl) + 1]})
                for blob, lbl in zip(encode_images(images), labels)]

    _shards(out, "train", jpeg_records(train), shards)
    _shards(out, "validation", jpeg_records(val), shards)
    if raw:
        records = []
        for _ in range(raw):
            label = int(rng.integers(0, classes))
            long = int(rng.integers(stored, 2 * stored + 1))
            h, w = (stored, long) if rng.random() < 0.5 else (long, stored)
            frame = synthetic_image(rng, h, w, label, device).cpu().numpy()
            records.append(encode_example({
                "image/raw": [frame.tobytes()],
                "image/class/label": [label + 1],
                "image/height": [h], "image/width": [w]}))
        _shards(out, "raw-train", records, shards)
        (out / "raw-train.meta.json").write_text(json.dumps(
            {"stored": stored, "count": raw, "full_frame": True}))
    return {"train": train, "validation": val, "raw-train": raw}


def _class_colour(label: int) -> tuple[int, int, int]:
    return ((label * 53 + 96) % 256, (label * 101 + 48) % 256,
            (label * 29 + 160) % 256)


def detection_image(rng: np.random.Generator, h: int, w: int, classes: int,
                    device: torch.device):
    """A uint8 (h, w, 3) image on ``device`` with 1-3 filled rectangles,
    each coloured by its class, on a dim noisy field -> (image, corners
    (N, 4) float32 normalized to the image, labels (N,) 0-based)."""
    noise = rng.normal(40, 8, (h, w, 3)).astype(np.float32)
    image = torch.from_numpy(noise).to(device)
    corners, labels = [], []
    for _ in range(int(rng.integers(1, 4))):
        label = int(rng.integers(0, classes))
        bw, bh = rng.uniform(0.2, 0.5, 2)
        x1 = int(rng.uniform(0, 1 - bw) * w)
        y1 = int(rng.uniform(0, 1 - bh) * h)
        x2, y2 = x1 + max(1, int(bw * w)), y1 + max(1, int(bh * h))
        image[y1:y2, x1:x2] = torch.tensor(_class_colour(label),
                                           dtype=torch.float32,
                                           device=device)
        corners.append((x1 / w, y1 / h, x2 / w, y2 / h))
        labels.append(label)
    image = image.round().clamp(0, 255).to(torch.uint8)
    return image, np.array(corners, np.float32), np.array(labels, np.int64)


def write_synthetic_detection(out_dir, *, train: int = 64, val: int = 16,
                              classes: int = 20, shards: int = 2,
                              sizes=(300, 500), seed: int = 0,
                              device: torch.device | str = "cuda") -> dict:
    """Write ``train-*`` and ``val-*`` detection shards, the images made
    and encoded on ``device`` (``"cuda"``, raising without a card, or
    ``"cpu"``); returns the counts written."""
    device = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    def records(n):
        made = [detection_image(rng, h, w, classes, device)
                for h, w in _sizes(rng, n, *sizes)]
        blobs = encode_images([img for img, _, _ in made])
        return [encode_example({
            "image/encoded": [blob],
            "image/height": [int(img.shape[0])],
            "image/width": [int(img.shape[1])],
            **{f"image/object/bbox/{k}": FloatList(corners[:, i].tolist())
               for i, k in enumerate(("xmin", "ymin", "xmax", "ymax"))},
            "image/object/class/label": Int64List((labels + 1).tolist()),
            "image/object/count": [len(labels)]})
            for blob, (img, corners, labels) in zip(blobs, made)]

    _shards(out, "train", records(train), shards)
    _shards(out, "val", records(val), shards)
    return {"train": train, "val": val}


def pose_image(rng: np.random.Generator, h: int, w: int, joints: int,
               device: torch.device):
    """A uint8 (h, w, 3) image on ``device`` with one person: a body
    height of 0.5 to 0.9 of the shorter side (scale = height / 200), its
    joints spread over a box of half that width and that height around
    the centre, 80% of them visible, each visible one a bright square in
    channel ``joint % 3`` on a dim noisy field -> (image, centre (2,)
    pixels, scale, kx, ky normalized to the image, v (joints,))."""
    noise = rng.normal(40, 8, (h, w, 3)).astype(np.float32)
    image = torch.from_numpy(noise).to(device)
    body = rng.uniform(0.5, 0.9) * min(h, w)
    cx = rng.uniform(0.3, 0.7) * w
    cy = rng.uniform(0.3, 0.7) * h
    px = np.clip(cx + rng.uniform(-0.25, 0.25, joints) * body, 0, w - 1)
    py = np.clip(cy + rng.uniform(-0.5, 0.5, joints) * body, 0, h - 1)
    v = (rng.uniform(size=joints) > 0.2).astype(np.int64)
    r = max(min(h, w) // 64, 2)
    for j in np.flatnonzero(v):
        x, y = int(px[j]), int(py[j])
        image[max(y - r, 0):y + r + 1, max(x - r, 0):x + r + 1, j % 3] = 255.0
    image = image.round().clamp(0, 255).to(torch.uint8)
    kx = np.where(v > 0, px / w, 0.0)
    ky = np.where(v > 0, py / h, 0.0)
    return image, np.array([cx, cy]), body / 200.0, kx, ky, v


def write_synthetic_pose(out_dir, *, train: int = 64, val: int = 16,
                         joints: int = 16, shards: int = 2,
                         sizes=(300, 500), seed: int = 0,
                         device: torch.device | str = "cuda") -> dict:
    """Write ``train-*`` and ``val-*`` pose shards, the images made and
    encoded on ``device`` (``"cuda"``, raising without a card, or
    ``"cpu"``); returns the counts written."""
    device = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    def records(split, n):
        made = [pose_image(rng, h, w, joints, device)
                for h, w in _sizes(rng, n, *sizes)]
        blobs = encode_images([m[0] for m in made])
        return [encode_example({
            "image/encoded": [blob],
            "image/height": [int(img.shape[0])],
            "image/width": [int(img.shape[1])],
            "image/filename": [f"{split}_{i:05d}.jpg".encode()],
            "image/person/center/x": [float(centre[0]) / img.shape[1]],
            "image/person/center/y": [float(centre[1]) / img.shape[0]],
            "image/person/scale": [float(scale)],
            "image/person/keypoints/x": FloatList(kx.tolist()),
            "image/person/keypoints/y": FloatList(ky.tolist()),
            "image/person/keypoints/v": Int64List(v.tolist())})
            for i, (blob, (img, centre, scale, kx, ky, v))
            in enumerate(zip(blobs, made))]

    _shards(out, "train", records("train", train), shards)
    _shards(out, "val", records("val", val), shards)
    return {"train": train, "val": val}


def gan_image(rng: np.random.Generator, h: int, w: int, domain: str,
              device: torch.device) -> torch.Tensor:
    """A uint8 (h, w, 3) image on ``device``: N(128, 12) noise with one
    square of a quarter to a half of the shorter side, 110 brighter
    (domain ``"A"``) or darker (``"B"``)."""
    noise = rng.normal(128, 12, (h, w, 3)).astype(np.float32)
    image = torch.from_numpy(noise).to(device)
    side = int(rng.integers(min(h, w) // 4, min(h, w) // 2))
    y, x = int(rng.integers(0, h - side)), int(rng.integers(0, w - side))
    image[y:y + side, x:x + side] += 110.0 if domain == "A" else -110.0
    return image.round().clamp(0, 255).to(torch.uint8)


def write_synthetic_gan(out_dir, *, train: int = 64, val: int = 16,
                        shards: int = 2, sizes=(286, 400), seed: int = 0,
                        device: torch.device | str = "cuda") -> dict:
    """Write the CycleGAN splits (``trainA``, ``trainB``, ``testA``,
    ``testB``), the images made and encoded on ``device`` (``"cuda"``,
    raising without a card, or ``"cpu"``); returns the counts written."""
    device = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    counts = {}
    for split, n in (("train", train), ("test", val)):
        for domain in ("A", "B"):
            images = [gan_image(rng, h, w, domain, device)
                      for h, w in _sizes(rng, n, *sizes)]
            records = [encode_example({
                "image/encoded": [blob],
                "image/height": [int(img.shape[0])],
                "image/width": [int(img.shape[1])],
                "image/filename": [f"{split}{domain}_{i:05d}.jpg".encode()]})
                for i, (blob, img) in enumerate(zip(encode_images(images),
                                                    images))]
            _shards(out, f"{split}{domain}", records, shards)
            counts[f"{split}{domain}"] = n
    return counts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deepvision_tpu_torch.data.synthetic_records",
        description=__doc__.splitlines()[0])
    p.add_argument("out_dir")
    p.add_argument("--train", type=int, default=64)
    p.add_argument("--val", type=int, default=16)
    p.add_argument("--raw", type=int, default=0)
    kind = p.add_mutually_exclusive_group()
    kind.add_argument("--detection", action="store_true",
                      help="write detection shards (train-*, val-*)")
    kind.add_argument("--pose", action="store_true",
                      help="write pose shards (train-*, val-*)")
    kind.add_argument("--gan", action="store_true",
                      help="write CycleGAN shards (trainA-*, trainB-*, "
                           "testA-*, testB-*)")
    p.add_argument("--classes", type=int, default=None,
                   help="classes (default 5; 20 with --detection)")
    p.add_argument("--shards", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    if (args.detection or args.pose or args.gan) and args.raw:
        p.error("--raw writes ImageNet raw-crop shards, not detection, "
                "pose or GAN")
    if args.gan:
        counts = write_synthetic_gan(
            args.out_dir, train=args.train, val=args.val,
            shards=args.shards, seed=args.seed, device=args.device)
    elif args.pose:
        counts = write_synthetic_pose(
            args.out_dir, train=args.train, val=args.val,
            shards=args.shards, seed=args.seed, device=args.device)
    elif args.detection:
        counts = write_synthetic_detection(
            args.out_dir, train=args.train, val=args.val,
            classes=args.classes or 20, shards=args.shards, seed=args.seed,
            device=args.device)
    else:
        counts = write_synthetic_imagenet(
            args.out_dir, train=args.train, val=args.val, raw=args.raw,
            classes=args.classes or 5, shards=args.shards, seed=args.seed,
            device=args.device)
    print(f"wrote {counts} under {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

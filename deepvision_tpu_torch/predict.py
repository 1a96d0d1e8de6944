"""One-shot inference CLI of the port, the twin of ``predict.py``.

    python -m deepvision_tpu_torch.predict classify -m resnet50 \
        --workdir runs/resnet50 IMG [IMG...] [--top 5] [--num-classes 1000]
    python -m deepvision_tpu_torch.predict detect -m yolov3 \
        --workdir runs/yolov3 IMG -o out.png [--names voc] [--size 416]
    python -m deepvision_tpu_torch.predict pose -m hourglass104 \
        --workdir runs/hourglass104 IMG -o out.png [--size 256]
    python -m deepvision_tpu_torch.predict dcgan --workdir runs/dcgan \
        -o samples.png [-n 16] [--seed 0]
    python -m deepvision_tpu_torch.predict cyclegan --workdir runs/cyclegan \
        IMG -o out.png [--direction a2b] [--size 256]
    python -m deepvision_tpu_torch.predict curves --workdir runs/resnet50 \
        -o curves.png
    python -m deepvision_tpu_torch.predict export -m resnet50 \
        --workdir runs/resnet50 [-o resnet50.pt2] [--num-classes 1000]

Every subcommand but ``curves`` takes ``--device``: ``cuda`` (the
default, which raises without a card) or ``cpu``. ``classify``,
``detect`` and ``pose`` restore and decode through
``serve/models.load_served``, the engine's own path: the newest verified
checkpoint under ``--workdir`` (the trainer's ``{workdir}/{model}``), or
seeded fresh weights without one. ``dcgan`` samples the generator of a
GAN checkpoint from noise of ``--seed`` (torch's generator: the JAX CLI's
threefry stream is another, trap C6), ``cyclegan`` translates with
``gen_a2b`` or ``gen_b2a``.

An image is read by :func:`load_image`: decoded by nvJPEG on a card (a
PNG by ``data/image_io.read_png``) and by PIL on the CPU, resized to the
square input by ``data/jpeg.resize_bilinear`` (tf's bilinear, half-pixel
centres, no antialias) on the device, then scaled to the model's pixel
convention. PNGs are written by ``data/image_io.encode_png``; ``--json
PATH`` also writes the answers (the top-k, the boxes, the joints, an
image's float pixels) as JSON. ``curves``
plots the metric history a checkpoint keeps and needs matplotlib (which
the card's machine lacks); without it, it exits with a message that
says so. ``export`` writes the restored model's eval-mode forward at
batch 1 in float32 as a ``torch.export`` artifact (``export.py``; the
LRN kernels stay ``deepvision::lrn_forward`` nodes), which ``python -m
deepvision_tpu_torch.serve --artifact`` serves without the model's code;
it runs on the device it was exported on. The last stderr line counts
the kernel launches.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

__all__ = ["load_image", "save_image", "draw_box", "draw_dot",
           "sample_noise", "dcgan_grid", "cyclegan_generator", "main"]

_PALETTE = [(255, 64, 64), (64, 255, 64), (64, 64, 255), (255, 255, 64),
            (255, 64, 255), (64, 255, 255), (255, 160, 64), (160, 64, 255)]


# ------------------------------------------------------------- image io


def _decode(data: bytes, device):
    """Image bytes -> uint8 (H, W, 3) RGB tensor on ``device``: PIL on
    the CPU; on a card nvJPEG for a JPEG, ``read_png`` for a PNG."""
    import torch

    from deepvision_tpu_torch.data.image_io import (
        jpeg_header,
        png_header,
        read_png,
    )
    from deepvision_tpu_torch.data.jpeg import decode_images, pack

    if device.type == "cuda" and jpeg_header(data) is None:
        if png_header(data) is None:
            raise ValueError("on the card predict reads JPEG and PNG files")
        return torch.from_numpy(read_png(data)).to(device)
    packed, offsets = pack([data])
    return decode_images(packed, offsets, device)[0]


def load_image(path: str, size: int, *, scale: str,
               device="cpu") -> np.ndarray:
    """JPEG or PNG -> (1, size, size, 3) float32 on the host; ``scale``:
    ``"imagenet"`` (channel means subtracted), ``"torch"`` (torchvision's
    mean and std), ``"unit"`` ([0, 1]) or ``"tanh"`` ([-1, 1])."""
    import torch

    from deepvision_tpu_torch.data.jpeg import resize_bilinear
    from deepvision_tpu_torch.ops.normalize import (
        IMAGENET_CHANNEL_MEANS,
        TORCH_CHANNEL_MEANS,
        TORCH_CHANNEL_STDS,
    )

    img = _decode(Path(path).read_bytes(), torch.device(device))
    img = resize_bilinear(img, size, size).cpu().numpy()
    if scale == "imagenet":
        img = img - np.asarray(IMAGENET_CHANNEL_MEANS, np.float32)
    elif scale == "torch":
        img = (img / 255.0 - np.asarray(TORCH_CHANNEL_MEANS, np.float32)) \
            / np.asarray(TORCH_CHANNEL_STDS, np.float32)
    elif scale == "unit":
        img = img / 255.0
    else:
        img = img / 127.5 - 1.0
    return img[None]


def save_image(path: str, img: np.ndarray) -> np.ndarray:
    """(H, W, C) in [-1, 1] or [0, 255] -> a PNG at ``path`` (gray
    repeated to RGB); returns the uint8 pixels written."""
    from deepvision_tpu_torch.data.image_io import encode_png

    if img.dtype != np.uint8:
        if img.min() < 0 or img.max() <= 1.5:  # the tanh range
            img = (img + 1.0) * 127.5
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    Path(path).write_bytes(encode_png(img))
    print(f"wrote {path}")
    return img


def draw_box(img: np.ndarray, x1, y1, x2, y2, color, thickness=2):
    """In-place rectangle on a (H, W, 3) uint8 array."""
    h, w = img.shape[:2]
    x1, x2 = sorted((int(np.clip(x1, 0, w - 1)), int(np.clip(x2, 0, w - 1))))
    y1, y2 = sorted((int(np.clip(y1, 0, h - 1)), int(np.clip(y2, 0, h - 1))))
    t = thickness
    img[y1:y1 + t, x1:x2 + 1] = color
    img[max(y2 - t, 0):y2 + 1, x1:x2 + 1] = color
    img[y1:y2 + 1, x1:x1 + t] = color
    img[y1:y2 + 1, max(x2 - t, 0):x2 + 1] = color


def draw_dot(img: np.ndarray, x, y, color, radius=3):
    x, y = int(x), int(y)
    img[max(y - radius, 0):y + radius + 1,
        max(x - radius, 0):x + radius + 1] = color


def _canvas(img: np.ndarray) -> np.ndarray:
    return np.clip((img[0] + 1) * 127.5, 0, 255).astype(np.uint8)


# ---------------------------------------------------------- subcommands


def _device(args):
    from deepvision_tpu_torch.device import resolve_device, strict_fp32

    device = resolve_device(args.device)
    if device.type == "cuda":
        strict_fp32()
    return device


def _weights(workdir) -> None:
    print(f"weights of the newest verified checkpoint under {workdir}/ckpt"
          if workdir else "no --workdir: fresh seeded weights")


def cmd_classify(args) -> list[dict]:
    from deepvision_tpu_torch.data.metadata import imagenet_label_name
    from deepvision_tpu_torch.serve.models import (
        input_scale,
        load_served,
        model_geometry,
    )

    device = _device(args)
    size, channels = model_geometry(args.model)
    scale = input_scale(args.model)
    imgs = [load_image(p, size, scale=scale, device=device)
            for p in args.images]
    if channels == 1:  # grayscale nets (lenet5)
        imgs = [img.mean(axis=-1, keepdims=True) for img in imgs]
    served = load_served(args.model, args.workdir, device=device,
                         num_classes=args.num_classes, top_k=args.top)
    _weights(args.workdir)
    out = []
    for path, img in zip(args.images, imgs):
        res = served.postprocess(served.run(img), 0)
        out.append(res)
        print(f"{path}:")
        for cls, prob in zip(res["classes"], res["probs"]):
            name = (imagenet_label_name(cls)
                    if args.num_classes == 1000 else str(cls))
            print(f"  {prob:6.2%}  {name}")
    return out


def cmd_detect(args) -> dict:
    from deepvision_tpu_torch.data.metadata import class_names
    from deepvision_tpu_torch.serve.models import load_served

    device = _device(args)
    names = class_names(args.names)
    img = load_image(args.images[0], args.size, scale="tanh", device=device)
    served = load_served(args.model, args.workdir, device=device,
                         input_size=args.size, num_classes=len(names),
                         score_thresh=args.score)
    _weights(args.workdir)
    det = served.postprocess(served.run(img), 0)
    canvas = _canvas(img)
    for box, score, cls in zip(det["boxes"], det["scores"], det["classes"]):
        x1, y1, x2, y2 = (np.asarray(box) * args.size).tolist()
        draw_box(canvas, x1, y1, x2, y2, _PALETTE[int(cls) % len(_PALETTE)])
        print(f"  {names[int(cls)]}: {score:.2f} at "
              f"({x1:.0f},{y1:.0f})-({x2:.0f},{y2:.0f})")
    print(f"{len(det['boxes'])} detections ≥ {args.score}")
    save_image(args.output, canvas)
    return det


def cmd_pose(args) -> dict:
    from deepvision_tpu_torch.serve.models import load_served

    device = _device(args)
    img = load_image(args.images[0], args.size, scale="tanh", device=device)
    served = load_served(args.model, args.workdir, device=device,
                         input_size=args.size, num_heatmaps=16)
    _weights(args.workdir)
    res = served.postprocess(served.run(img), 0)
    canvas = _canvas(img)
    for j, (x, y, conf) in enumerate(res["joints"]):
        if conf <= args.score:
            continue
        draw_dot(canvas, x * args.size, y * args.size,
                 _PALETTE[j % len(_PALETTE)])
        print(f"  joint {j}: ({x:.3f}, {y:.3f}) conf {conf:.2f}")
    save_image(args.output, canvas)
    return res


def sample_noise(n: int, noise_dim: int, seed: int, device) -> np.ndarray:
    """(n, noise_dim) N(0, 1) noise from a torch generator seeded with
    ``seed`` on ``device``, on the host."""
    import torch

    g = torch.Generator(device).manual_seed(seed)
    return torch.randn((n, noise_dim), generator=g,
                       device=device).cpu().numpy()


def dcgan_grid(samples: np.ndarray) -> np.ndarray:
    """(n, 28, 28, 1) samples -> one square grid, -1 where no sample."""
    n = len(samples)
    side = int(np.ceil(np.sqrt(n)))
    grid = np.full((side * 28, side * 28, 1), -1.0, np.float32)
    for i in range(n):
        r, c = divmod(i, side)
        grid[r * 28:(r + 1) * 28, c * 28:(c + 1) * 28] = samples[i]
    return grid


def cmd_dcgan(args) -> np.ndarray:
    from deepvision_tpu_torch.serve.models import load_served

    device = _device(args)
    served = load_served("dcgan", args.workdir, device=device)
    _weights(args.workdir)
    z = sample_noise(args.n, served.input_shape[0], args.seed, device)
    grid = dcgan_grid(served.run(z)["image"])
    save_image(args.output, grid)
    return grid


def cyclegan_generator(workdir, direction: str, device):
    """``gen_a2b`` or ``gen_b2a`` in evaluation mode: of the newest
    verified GAN checkpoint under ``{workdir}/ckpt``, or fresh seeded
    weights without a workdir."""
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.checkpoint import CheckpointManager

    module = create_model("cyclegan_generator", device=device)
    if workdir:
        weights, _ = CheckpointManager(Path(workdir) / "ckpt").restore_model(
            device=device, net=f"gen_{direction}")
        module.load_state_dict(weights)
    module.eval()
    module.requires_grad_(False)
    return module


def cmd_cyclegan(args) -> np.ndarray:
    import torch

    device = _device(args)
    img = load_image(args.images[0], args.size, scale="tanh", device=device)
    module = cyclegan_generator(args.workdir, args.direction, device)
    _weights(args.workdir)
    with torch.inference_mode():
        out = module(torch.from_numpy(img).to(device)).float().cpu().numpy()
    save_image(args.output, out[0])
    return out[0]


def cmd_curves(args) -> None:
    """Plot the metric history kept in the newest checkpoint's meta."""
    try:
        import matplotlib
    except ImportError:
        sys.exit("predict curves needs matplotlib, which is not installed "
                 "here")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from deepvision_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(Path(args.workdir) / "ckpt")
    epoch = mgr.latest_epoch()
    if epoch is None:
        sys.exit(f"no checkpoints under {args.workdir}/ckpt")
    loggers = mgr.restore_meta(epoch)["loggers"]
    if loggers is None or not loggers.data:
        sys.exit("checkpoint has no logged metrics")
    metrics = sorted(loggers.data)
    rows = (len(metrics) + 1) // 2
    fig, axes = plt.subplots(rows, 2, figsize=(10, 3 * rows), squeeze=False)
    for ax, name in zip(axes.flat, metrics):
        series = loggers.data[name]
        ax.plot(series["epochs"], series["value"])
        ax.set_title(name)
        ax.set_xlabel("epoch")
        ax.grid(alpha=0.3)
    for ax in axes.flat[len(metrics):]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(args.output, dpi=120)
    print(f"wrote {args.output} ({len(metrics)} curves, epoch {epoch})")


def cmd_export(args) -> None:
    from deepvision_tpu_torch.export import (
        SUFFIX,
        export_forward,
        save_exported,
    )
    from deepvision_tpu_torch.serve.models import restore_state

    device = _device(args)
    module, geo = restore_state(args.model, args.workdir, device=device,
                                input_size=args.size,
                                num_classes=args.num_classes)
    _weights(args.workdir)
    size = geo["input_size"]
    sample = np.zeros((1, size, size, geo["channels"]), np.float32)
    data = export_forward(module, sample)
    out = args.output or f"{args.model}{SUFFIX}"
    save_exported(out, data)
    print(f"exported {len(data) / 1e6:.1f} MB torch.export artifact to "
          f"{out}")


def _jsonable(result):
    if isinstance(result, np.ndarray):
        return result.tolist()
    if isinstance(result, dict):
        return {k: _jsonable(v) for k, v in result.items()}
    if isinstance(result, (list, tuple)):
        return [_jsonable(v) for v in result]
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m deepvision_tpu_torch.predict",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, model=None, images=True, output=None):
        if model:
            sp.add_argument("-m", "--model", default=model)
        sp.add_argument("--workdir", default=None)
        if images:
            sp.add_argument("images", nargs="+")
        if output:
            sp.add_argument("-o", "--output", default=output)
        sp.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
        sp.add_argument("--json", default=None,
                        help="also write the answers (an image as its "
                             "float pixels) as JSON to this path")

    sp = sub.add_parser("classify")
    common(sp, model="resnet50")
    sp.add_argument("--top", type=int, default=5)
    sp.add_argument("--num-classes", type=int, default=1000)
    sp.set_defaults(fn=cmd_classify)
    sp = sub.add_parser("detect")
    common(sp, model="yolov3", output="detections.png")
    sp.add_argument("--names", default="voc", choices=["voc", "mscoco"])
    sp.add_argument("--size", type=int, default=416)
    sp.add_argument("--score", type=float, default=0.5)
    sp.set_defaults(fn=cmd_detect)
    sp = sub.add_parser("pose")
    common(sp, model="hourglass104", output="pose.png")
    sp.add_argument("--size", type=int, default=256)
    sp.add_argument("--score", type=float, default=0.1)
    sp.set_defaults(fn=cmd_pose)
    sp = sub.add_parser("dcgan")
    common(sp, images=False, output="samples.png")
    sp.add_argument("-n", type=int, default=16)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_dcgan)
    sp = sub.add_parser("cyclegan")
    common(sp, output="translated.png")
    sp.add_argument("--direction", default="a2b", choices=["a2b", "b2a"])
    sp.add_argument("--size", type=int, default=256)
    sp.set_defaults(fn=cmd_cyclegan)
    sp = sub.add_parser("curves")
    sp.add_argument("--workdir", required=True)
    sp.add_argument("-o", "--output", default="curves.png")
    sp.set_defaults(fn=cmd_curves)
    sp = sub.add_parser("export")
    common(sp, model="resnet50", images=False)
    sp.add_argument("-o", "--output", default=None,
                    help="the artifact's path (default {model}.pt2)")
    sp.add_argument("--num-classes", type=int, default=1000)
    sp.add_argument("--size", type=int, default=None,
                    help="the input size (default the checkpoint's, else "
                         "the config's)")
    sp.set_defaults(fn=cmd_export)
    args = p.parse_args(argv)
    result = args.fn(args)
    if getattr(args, "json", None):
        Path(args.json).write_text(json.dumps(_jsonable(result)))
    if args.cmd != "curves":
        from deepvision_tpu_torch.ops import kernel_launches

        print(f"[predict] {args.cmd}: kernel launches {kernel_launches()}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

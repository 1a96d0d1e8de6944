"""Training CLI of the port, the twin of ``train.py`` for the AlexNets,
Inception V1 and the ResNets.

    python -m deepvision_tpu_torch.train -m alexnet1 [--resume] [--epochs N]
    python -m deepvision_tpu_torch.train -m resnet50

Without a data directory the run trains on the hermetic synthetic set
(``data/synthetic.py``), as ``train.py`` does without ``--data-dir``. It
runs on the card (``--device cuda``, the default, which raises without
one); ``--device cpu`` runs on the CPU when asked. The model is built
with the config's ``model_kwargs`` (``resnet50``'s ``s2d_stem``), as
``train.py`` builds it. The flags are
``train.py``'s names for what this slice serves; the others are not
ported and are absent, so that no flag is silently ignored.
"""

from __future__ import annotations

import argparse
import sys
from functools import partial
from itertools import islice

import numpy as np

__all__ = ["main", "parse_args"]


def parse_args(argv=None) -> argparse.Namespace:
    from deepvision_tpu_torch.core.precision import PRECISION_NAMES
    from deepvision_tpu_torch.train.configs import TRAINABLE

    p = argparse.ArgumentParser(
        prog="python -m deepvision_tpu_torch.train",
        description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model", required=True, choices=TRAINABLE)
    p.add_argument("-c", "--checkpoint", type=int, default=None,
                   help="epoch to resume from")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint")
    p.add_argument("--workdir", default="runs")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-classes", type=int, default=None,
                   help="override the config's class count")
    p.add_argument("--lr", type=float, default=None,
                   help="override the config's base learning rate")
    p.add_argument("--input-size", type=int, default=None,
                   help="override the config's train-time crop size")
    p.add_argument("--precision", default=None, choices=PRECISION_NAMES,
                   help="numerics policy (core/precision.py); default: "
                        "the model config's")
    p.add_argument("--synthetic-size", type=int, default=2048,
                   help="synthetic dataset size")
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="override train steps per epoch")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="device batches the feed keeps in flight ahead "
                        "of the step (data/prefetch.py)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    if args.prefetch_depth < 1:
        p.error(f"--prefetch-depth must be >= 1, got {args.prefetch_depth}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.data.mnist import batches
    from deepvision_tpu_torch.data.synthetic import synthetic_classification
    from deepvision_tpu_torch.device import resolve_device, strict_fp32
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.ops.lrn_cuda import (
        local_response_norm_backward_cuda,
        local_response_norm_cuda,
    )
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.steps import (
        classification_eval_step,
        classification_train_step,
    )
    from deepvision_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    cfg = get_config(args.model)
    if args.batch_size:
        cfg["batch_size"] = args.batch_size
    if args.num_classes:
        cfg["num_classes"] = args.num_classes
    if args.lr:
        cfg["optimizer_params"]["lr"] = args.lr
    if args.input_size:
        cfg["input_size"] = args.input_size
    policy = get_policy(args.precision or cfg["precision"])
    cfg["precision"] = policy.name
    if device.type == "cuda":
        strict_fp32()  # float32 math in full float32, as on the CPU

    bs, size = cfg["batch_size"], cfg["input_size"]
    imgs, labels, split = synthetic_classification(
        args.synthetic_size, size, cfg["channels"], cfg["num_classes"], bs)
    steps = args.steps_per_epoch or (args.synthetic_size - split) // bs

    def train_data(epoch):
        return islice(batches(imgs[split:], labels[split:], bs,
                              rng=np.random.default_rng(epoch)), steps)

    def val_data():
        return batches(imgs[:split], labels[:split], bs,
                       drop_remainder=False)

    kind = "torch" if cfg.get("augment") == "pt" else "imagenet"
    model_kwargs = cfg.get("model_kwargs", {})
    module = create_model(args.model, device=device, seed=0,
                          num_classes=cfg["num_classes"], input_size=size,
                          dtype=policy.compute_dtype, **model_kwargs)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + f"  model: {args.model} {size}x{size}x{cfg['channels']} -> "
          f"{cfg['num_classes']} classes, batch {bs}, {steps} steps an "
          f"epoch, precision {policy.name}, model_kwargs {model_kwargs}",
          flush=True)
    trainer = Trainer(
        module, cfg, train_data, val_data, device=device,
        workdir=args.workdir, prefetch_depth=args.prefetch_depth,
        steps_per_epoch=steps,
        train_step=partial(classification_train_step, normalize_kind=kind),
        eval_step=partial(classification_eval_step, normalize_kind=kind))
    if args.resume or args.checkpoint is not None:
        trainer.resume(args.checkpoint)
        print(f"resumed at epoch {trainer.start_epoch}", flush=True)
    trainer.fit(args.epochs)
    launches = {**local_response_norm_cuda.launches_by_kernel,
                **local_response_norm_backward_cuda.launches_by_kernel}
    print(f"[train] {args.model}: epochs {trainer.start_epoch}.."
          f"{(args.epochs or cfg['total_epochs']) - 1} done, checkpoints "
          f"{trainer.ckpt.saved_epochs()} under {trainer.ckpt.directory}; "
          f"LRN kernel launches {launches}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

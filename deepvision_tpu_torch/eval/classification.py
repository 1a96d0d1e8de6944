"""Classification top-1 and top-5 over a whole validation set, the twin of
``evaluate.py``'s ``classification`` subcommand.

The batches, by the config's dataset:

- ImageNet with ``--data-dir``: the ``validation-*`` JPEG shards
  (``data/imagenet.val_batches``: decoded on the device, central crop,
  float32 normalized in the config's lineage, ``"torch"`` for ``augment:
  "pt"``, the last batch padded and masked);
- MNIST with ``--data-dir``: the ``t10k`` idx files, the last batch
  padded and masked;
- without a data directory: the synthetic set the training CLI's
  fallback draws (``synthetic_mnist(256)`` for an MNIST config, else
  ``synthetic_classification`` and its held-out slice, the first
  ``max(train_batch_size, n / 10)`` images of ``synthetic_size``; without
  the training run's batch size the split is taken at 1, a subset of the
  true held-out slice, as ``evaluate.py``).

Each batch goes through ``train/steps.classification_eval_step`` (the
uint8 wire normalized in the config's lineage) on the newest verified
checkpoint under the workdir (``serve/models.restore_state``), and
``aggregate_eval_parts`` sums them into the masked means of the whole
set, printed as ``evaluate.py``'s JSON line.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

__all__ = ["classification_batches", "evaluate_classification",
           "cmd_classification"]


def classification_batches(cfg: dict, data_dir: str | None,
                           batch_size: int, *, synthetic_size: int = 2048,
                           train_batch_size: int | None = None):
    """The evaluation batches of config ``cfg`` (host dicts, or packed
    JPEG batches that the device feed decodes)."""
    from deepvision_tpu_torch.data.mnist import batches, synthetic_mnist

    size, channels = cfg["input_size"], cfg["channels"]
    if data_dir and cfg["dataset"] == "imagenet":
        from deepvision_tpu_torch.data.imagenet import val_batches

        files = sorted(Path(data_dir).glob("validation-*"))
        if not files:
            raise FileNotFoundError(f"no validation-* records under "
                                    f"{data_dir}")
        return val_batches(files, batch_size, size,
                           augment=cfg.get("augment", "tf"))
    if data_dir and cfg["dataset"] == "mnist":
        from deepvision_tpu_torch.data.mnist import load_mnist_idx

        images, labels = load_mnist_idx(
            os.path.join(data_dir, "t10k-images-idx3-ubyte"),
            os.path.join(data_dir, "t10k-labels-idx1-ubyte"))
    elif cfg["dataset"] == "mnist":
        images, labels = synthetic_mnist(256)
    else:
        from deepvision_tpu_torch.data.synthetic import (
            synthetic_classification,
        )

        images, labels, split = synthetic_classification(
            synthetic_size, size, channels, cfg["num_classes"],
            train_batch_size or 1)
        images, labels = images[:split], labels[:split]
    return batches(images, labels, batch_size, drop_remainder=False)


def evaluate_classification(module, batches, device, *,
                            normalize_kind: str = "imagenet"
                            ) -> tuple[dict, float]:
    """(``val_*`` means, image count) of ``module`` over ``batches``, fed
    to ``device`` by the device feed."""
    import torch

    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import (
        aggregate_eval_parts,
        classification_eval_step,
    )

    state = TrainState(module, None)
    feed = DevicePrefetcher(batches, device)

    def parts():
        for batch in feed:
            with torch.inference_mode():
                yield classification_eval_step(state, batch, normalize_kind)

    try:
        return aggregate_eval_parts(parts())
    finally:
        feed.close()


def cmd_classification(args) -> dict:
    from deepvision_tpu_torch.device import resolve_device, strict_fp32
    from deepvision_tpu_torch.ops import kernel_launches
    from deepvision_tpu_torch.serve.models import restore_state
    from deepvision_tpu_torch.train.configs import get_config

    device = resolve_device(args.device)
    if device.type == "cuda":
        strict_fp32()
    cfg = get_config(args.model)
    if args.num_classes:
        cfg["num_classes"] = args.num_classes
    if args.input_size:
        cfg["input_size"] = args.input_size
    batches = classification_batches(
        cfg, args.data_dir, args.batch_size,
        synthetic_size=args.synthetic_size,
        train_batch_size=args.train_batch_size)
    module, _ = restore_state(args.model, args.workdir, args.epoch,
                              device=device, num_classes=cfg["num_classes"],
                              input_size=cfg["input_size"])
    kind = "torch" if cfg.get("augment") == "pt" else "imagenet"
    metrics, n = evaluate_classification(module, batches, device,
                                         normalize_kind=kind)
    line = {"metric": "classification_eval", "images": int(n),
            **{k: round(v, 4) for k, v in metrics.items()}}
    print(json.dumps(line), flush=True)
    print(f"[eval] {args.model}: {int(n)} images on {device}; kernel "
          f"launches {kernel_launches()}", file=sys.stderr, flush=True)
    return line


def add_parser(sub) -> None:
    """The ``classification`` subcommand of ``python -m
    deepvision_tpu_torch.eval``."""
    sp = sub.add_parser("classification", help="top-1/top-5 over a "
                                               "validation set")
    sp.add_argument("-m", "--model", default="resnet50")
    sp.add_argument("--workdir", default=None)
    sp.add_argument("--data-dir", default=None)
    sp.add_argument("--batch-size", type=int, default=64)
    sp.add_argument("--num-classes", type=int, default=None,
                    help="override the class count (small sets)")
    sp.add_argument("--input-size", type=int, default=None,
                    help="override the eval crop (must match training)")
    sp.add_argument("--epoch", type=int, default=None,
                    help="saved epoch to score (default: the newest)")
    sp.add_argument("--synthetic-size", type=int, default=2048,
                    help="the training run's --synthetic-size: its "
                         "held-out slice is scored")
    sp.add_argument("--train-batch-size", type=int, default=None,
                    help="the training run's batch size (sizes the "
                         "held-out split; default 1)")
    sp.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    sp.set_defaults(fn=cmd_classification)

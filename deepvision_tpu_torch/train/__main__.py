"""Training CLI of the port, the twin of ``train.py`` for LeNet-5, the
AlexNets, Inception V1, the ResNets, Darknet-53, YOLO v3, CenterNet,
Hourglass-104 and the GANs (DCGAN and CycleGAN).

    python -m deepvision_tpu_torch.train -m alexnet1 [--resume] [--epochs N]
    python -m deepvision_tpu_torch.train -m resnet50 --data-dir DIR \
        [--raw|--no-raw] [--device-aug [--mixup ALPHA]] [--steps-per-epoch N]
    python -m deepvision_tpu_torch.train -m yolov3 [--data-dir DIR \
        [--device-aug] [--steps-per-epoch N]]
    python -m deepvision_tpu_torch.train -m centernet [--data-dir DIR ...]
    python -m deepvision_tpu_torch.train -m hourglass104 [--data-dir DIR \
        [--device-aug]] [--num-joints K]
    python -m deepvision_tpu_torch.train -m lenet5 [--data-dir MNIST_DIR]
    python -m deepvision_tpu_torch.train -m dcgan [--data-dir MNIST_DIR] \
        [--label-smooth S]
    python -m deepvision_tpu_torch.train -m cyclegan [--data-dir DIR \
        [--device-aug] [--steps-per-epoch N]]

``--data-dir`` reads ImageNet TFRecords (``data/imagenet.py``): the
raw-crop shards when usable (``--raw`` demands them, ``--no-raw``
refuses them), else the JPEG shards, decoded on the card by nvJPEG;
training batches cross as uint8 and validation reads the JPEG shards.
``--device-aug`` leaves the host only the crop and runs flip, jitter and
``--mixup`` inside the step (``data/device_aug.py``); eval steps are not
augmented. A detection config (``yolov3``) reads detection TFRecords
(``data/detection.py``: ``train-*`` and ``val-*``, the JPEGs decoded on
the card, ``--steps-per-epoch`` defaulting to ``2501 // batch``, VOC
2007's trainval over the batch); ``--device-aug`` moves its flip, with
the boxes, into the step, and its steps encode the label grids and take
the YOLO loss (``train/steps.yolo_train_step``); ``centernet``'s config
(``"steps": "centernet"``) takes the CenterNet steps over the same data.
A pose config (``hourglass104``) reads pose TFRecords (``data/pose.py``:
``train-*`` and ``val-*``, each person cropped on the card,
``--steps-per-epoch`` defaulting to ``22245 // batch``, MPII's training
people over the batch); ``--device-aug`` flips images and keypoints in
the step, swapping the MPII left and right joints when there are 16;
``--num-joints`` overrides the joint count. Without a data directory
the run trains on the hermetic synthetic sets (``data/synthetic.py``;
``data/detection.synthetic_detection``, at most 128 px, flip-augmented;
``data/pose.synthetic_pose``, at most 128 px), as ``train.py`` does
without ``--data-dir``. ``lenet5`` trains on MNIST's idx files
(``train-images-idx3-ubyte`` and the rest, padded to 32) or the
synthetic digits. The GANs run the GAN loop (``train/gan.fit_gan``): a
checkpoint every ``save_every`` epochs of the config keeping 3, no
validation. ``dcgan`` trains on MNIST's 28x28 images (the idx files of
``--data-dir``, or the synthetic digits cropped ``[2:30, 2:30]``) in
[-1, 1], ``--label-smooth`` smoothing its critic's real targets.
``cyclegan`` reads ``trainA-*`` and ``trainB-*`` unpaired records
(``data/gan.py``, the JPEGs decoded on the card, ``--steps-per-epoch``
defaulting to ``1000 // batch``; ``--device-aug`` ships the uint8
``size + 30`` canvas and crops, flips and scales in the step) or, without
``--data-dir``, the synthetic domains at ``min(size, 64)``, as
``train.py``; its Adams follow ``linear_decay`` over the run's steps. A
``bf16_scaled`` GAN run shares one loss scale over both tapes. It
runs on the card (``--device cuda``, the default, which raises without
one); ``--device cpu`` runs on the CPU when asked. The model is built
with the config's ``model_kwargs`` (``resnet50``'s ``s2d_stem``,
``resnet152``'s and ``hourglass104``'s ``remat``), as ``train.py``
builds it.

The resilient run, with ``train.py``'s flags, defaults and refusals:
``--recover`` (NaN rollback to the newest verified checkpoint, transient
read retries, a verified resume; ``--max-rollbacks``, ``--lr-rewarm``),
``--check-numerics`` (the per-step finite flag), ``--faults`` and
``--fault-seed`` (``resilience/faults.py``'s schedule), ``--sentinel``
(``--sentinel-z``, ``--sentinel-warmup``, ``--audit-every``),
``--async-checkpoint``, ``--keep-best``, ``--no-ckpt-integrity``,
``--data-echo``, ``--stall-timeout`` and ``--stall-abort`` (exit 75),
``--rss-limit-gb`` (a preemption save past the limit), ``--trace`` (spans
exported as a Chrome trace on every exit; ``python -m
deepvision_tpu_torch.obs`` summarizes it), ``--profile-steps`` and
``--profile-dir`` (a ``torch.profiler`` window), ``--loader-workers`` and
``--max-worker-restarts`` (spawned ImageNet readers,
``data/loader.py``), ``--output-bucket`` and ``--output-dir``
(``train/publish.py``). SIGTERM saves a mid-epoch checkpoint and exits
143; ``--resume`` continues at the next step; a sentinel trip without
``--recover`` exits 76. The GAN loop takes ``--async-checkpoint``, the
stall and RSS watchdogs, ``--check-numerics`` and SIGTERM (at an epoch's
end), and refuses ``--recover``, ``--faults``, ``--sentinel`` and the
profiler window, as ``train.py`` does. The flags the port does not serve
(``--zero1``, the cluster's) are absent, so that no flag is silently
ignored.
"""

from __future__ import annotations

import argparse
import sys
from functools import partial
from itertools import islice
from pathlib import Path

import numpy as np

__all__ = ["main", "parse_args", "check_data_flags", "run_gan"]


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
    p.add_argument("--num-joints", type=int, default=None,
                   help="override the pose configs' joint count")
    p.add_argument("--precision", default=None, choices=PRECISION_NAMES,
                   help="numerics policy (core/precision.py); default: "
                        "the model config's")
    p.add_argument("--data-dir", default=None,
                   help="TFRecord directory: ImageNet (train-*/"
                        "validation-*, raw-train-* + raw-train.meta.json) "
                        "or detection and pose (train-*/val-*); default: "
                        "the synthetic set")
    p.add_argument("--raw", dest="use_raw", action="store_true",
                   default=None,
                   help="demand the raw-crop shards (raw-train-*) of "
                        "--data-dir")
    p.add_argument("--no-raw", dest="use_raw", action="store_false",
                   help="read the JPEG shards even where raw-crop shards "
                        "are usable")
    p.add_argument("--device-aug", action="store_true",
                   help="split input pipeline (data/device_aug.py): the "
                        "host ships uint8 crops, flip/jitter/normalize "
                        "run inside the train step")
    p.add_argument("--mixup", type=float, default=0.0, metavar="ALPHA",
                   help="device-side mixup with Beta(ALPHA, ALPHA); "
                        "needs --device-aug")
    p.add_argument("--label-smooth", type=float, default=0.0,
                   help="DCGAN: one-sided label smoothing of the "
                        "discriminator's real targets")
    p.add_argument("--synthetic-size", type=int, default=2048,
                   help="synthetic dataset size")
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="override train steps per epoch")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="device batches the feed keeps in flight ahead "
                        "of the step (data/prefetch.py)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--output-bucket", default=None,
                   help="GCS bucket to publish the final checkpoint to")
    p.add_argument("--output-dir", default=None,
                   help="GCS object prefix within --output-bucket")
    p.add_argument("--check-numerics", action="store_true",
                   help="read the step's finite flag every step and raise "
                        "on NaN/Inf (one host sync a step)")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="write the epoch checkpoints in the background "
                        "from a host copy of the state")
    p.add_argument("--keep-best", action="store_true",
                   help="retain the best checkpoints by the plateau metric "
                        "instead of the most recent")
    p.add_argument("--stall-timeout", type=float, default=0.0,
                   help="seconds without a completed step before the stall "
                        "watchdog fires (0 = off); armed by the first step")
    p.add_argument("--stall-abort", action="store_true",
                   help="on stall, exit 75 (EX_TEMPFAIL) so a supervisor "
                        "restarts into --resume")
    p.add_argument("--rss-limit-gb", type=float, default=0.0,
                   help="self-preempt (mid-epoch save + exit 143) when the "
                        "host RSS crosses this many GB (0 = off)")
    p.add_argument("--recover", action="store_true",
                   help="self-healing: the NaN/Inf tripwire rolls back to "
                        "the last verified checkpoint and skips the batch "
                        "window (implies --check-numerics), transient data "
                        "reads retry with backoff, and resume quarantines "
                        "corrupt checkpoints and falls back")
    p.add_argument("--max-rollbacks", type=int, default=3,
                   help="consecutive NaN rollbacks before --recover aborts")
    p.add_argument("--lr-rewarm", type=float, default=None,
                   help="multiply the LR scale by this factor on every "
                        "rollback; default: keep the LR")
    p.add_argument("--faults", default=None,
                   help="deterministic fault schedule "
                        "(resilience/faults.py grammar, e.g. "
                        "'nan@14,ckpt@1,io@8x2')")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="seed for probabilistic (~) fault specs")
    p.add_argument("--sentinel", action="store_true",
                   help="silent-failure defense: update/param norms and the "
                        "loss computed in the step and z-scored on the "
                        "drain cadence; checkpoint manifests carry the "
                        "state fingerprint")
    p.add_argument("--audit-every", type=int, default=16,
                   help="run-step cadence of the state fingerprint audit; "
                        "requires --sentinel")
    p.add_argument("--sentinel-z", type=float, default=8.0,
                   help="z-score threshold of the sentinel detector")
    p.add_argument("--sentinel-warmup", type=int, default=16,
                   help="observations per sentinel series before the "
                        "z-test arms")
    p.add_argument("--no-ckpt-integrity", action="store_true",
                   help="skip the per-save checksum manifest")
    p.add_argument("--data-echo", type=int, default=1,
                   help="optimizer steps per transferred batch (data "
                        "echoing, arXiv:1907.05550)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="span tracing, exported here as a Chrome trace "
                        "on exit (summarize: python -m "
                        "deepvision_tpu_torch.obs PATH)")
    p.add_argument("--profile-steps", default=None, metavar="A:B",
                   help="a torch.profiler window over global steps A..B "
                        "(transferred-batch indices, 0-based)")
    p.add_argument("--profile-dir", default=None,
                   help="where --profile-steps writes its trace (default: "
                        "WORKDIR/MODEL/profile)")
    p.add_argument("--loader-workers", type=int, default=1,
                   help="spread the ImageNet record reader over N spawned "
                        "processes (data/loader.py); ImageNet record runs "
                        "only")
    p.add_argument("--max-worker-restarts", type=int, default=2,
                   help="respawn a dead loader worker at its shard "
                        "position up to this many consecutive times; 0 = "
                        "fail on the first death")
    args = p.parse_args(argv)
    if args.prefetch_depth < 1:
        p.error(f"--prefetch-depth must be >= 1, got {args.prefetch_depth}")
    return args


def check_data_flags(args, cfg: dict) -> None:
    """``train.py``'s refusals of the data flags, with their meaning:
    ``--raw`` needs a ``--data-dir`` ImageNet config, ``--device-aug`` a
    ``--data-dir`` ImageNet, detection, pose or CycleGAN config,
    ``--mixup`` also ``--device-aug`` on ImageNet and a non-negative
    alpha, ``--label-smooth`` the DCGAN config and a value in [0, 1),
    ``--loader-workers`` above 1 a ``--data-dir`` ImageNet config, and
    the GAN configs refuse the Trainer's recovery, faults, sentinel and
    profiler flags."""
    imagenet = bool(args.data_dir) and cfg["dataset"] == "imagenet"
    if args.use_raw is not None and not imagenet:
        raise SystemExit(
            "--raw/--no-raw only applies to --data-dir ImageNet configs "
            f"(this run: dataset={cfg['dataset']!r}, "
            f"data_dir={args.data_dir!r})")
    if args.label_smooth and cfg["dataset"] != "gan_mnist":
        raise SystemExit(
            "--label-smooth only applies to the DCGAN config "
            f"(this run: {args.model!r})")
    if not 0.0 <= args.label_smooth < 1.0:
        raise SystemExit(
            f"--label-smooth must be in [0, 1), got {args.label_smooth}")
    if args.device_aug and not (args.data_dir and cfg["dataset"] in
                                ("imagenet", "detection", "pose",
                                 "gan_unpaired")):
        raise SystemExit(
            "--device-aug splits a record-backed host pipeline: "
            "--data-dir ImageNet, detection, pose and CycleGAN configs only "
            f"(this run: dataset={cfg['dataset']!r}, "
            f"data_dir={args.data_dir!r})")
    if args.mixup and not (args.device_aug and imagenet):
        raise SystemExit(
            "--mixup is a device-side classification augmentation; it "
            "requires --device-aug on a --data-dir ImageNet config "
            f"(this run: {args.model!r})")
    if args.mixup < 0:
        raise SystemExit(f"--mixup must be >= 0, got {args.mixup}")
    if args.stall_timeout < 0:
        raise SystemExit(
            f"--stall-timeout must be >= 0, got {args.stall_timeout}")
    if args.lr_rewarm is not None and not args.recover:
        raise SystemExit("--lr-rewarm only applies with --recover "
                         "(it scales the LR on each rollback)")
    if args.loader_workers < 1:
        raise SystemExit(
            f"--loader-workers must be >= 1, got {args.loader_workers}")
    if args.max_worker_restarts < 0:
        raise SystemExit(f"--max-worker-restarts must be >= 0, got "
                         f"{args.max_worker_restarts}")
    if args.loader_workers > 1 and not imagenet:
        raise SystemExit(
            "--loader-workers parallelizes the record decode stage — "
            "--data-dir ImageNet configs only (this run: "
            f"dataset={cfg['dataset']!r}, data_dir={args.data_dir!r})")
    if cfg["dataset"].startswith("gan"):
        if args.recover or args.faults or args.sentinel:
            raise SystemExit(
                "--recover/--faults/--sentinel ride the Trainer "
                "rollback/drain loop; the GAN fit_gan path has no "
                f"hook yet (this run: {args.model!r})")
        if args.profile_steps or args.profile_dir:
            raise SystemExit(
                "--profile-steps/--profile-dir ride the Trainer step "
                "counter; the GAN fit_gan path has no profiler hook "
                f"yet (this run: {args.model!r}; --trace works)")


def _resilience(args):
    """(recovery policy, fault injector, sentinel monitor) of the flags,
    each None when off; built before the data factories, whose loader
    consults the injector."""
    recovery = injector = sentinel = None
    if args.recover:
        from deepvision_tpu_torch.resilience import RecoveryPolicy

        recovery = RecoveryPolicy(max_rollbacks=args.max_rollbacks,
                                  lr_rewarm=args.lr_rewarm)
    if args.faults:
        from deepvision_tpu_torch.resilience import FaultInjector

        injector = FaultInjector(args.faults, seed=args.fault_seed)
        print(f"fault injection armed: {args.faults!r}", flush=True)
    if args.sentinel:
        from deepvision_tpu_torch.resilience.sentinel import SentinelMonitor

        sentinel = SentinelMonitor(
            z_threshold=args.sentinel_z, warmup=args.sentinel_warmup,
            audit_every=args.audit_every)
        print("[sentinel] armed: in-step invariants + EWMA z-score "
              f"(z={args.sentinel_z:g}, warmup={args.sentinel_warmup})"
              f", state audits every {args.audit_every} steps",
              flush=True)
    return recovery, injector, sentinel


def _maybe_enable_trace(args) -> None:
    if not args.trace:
        return
    from deepvision_tpu_torch.obs.trace import get_tracer

    get_tracer().enable()
    print(f"[obs] span tracing on -> {args.trace}", flush=True)


def _maybe_export_trace(args) -> None:
    if not args.trace:
        return
    from deepvision_tpu_torch.obs.trace import get_tracer

    n = get_tracer().export(args.trace)
    print(f"[obs] wrote {n} spans to {args.trace} (load in "
          "chrome://tracing or Perfetto; summarize with python -m "
          "deepvision_tpu_torch.obs)", flush=True)


def _maybe_publish(args, ckpt_dir: Path) -> None:
    """Publish the newest retained epoch to GCS when asked."""
    if not (args.output_bucket and args.output_dir):
        return
    from deepvision_tpu_torch.train.publish import publish_to_gcs

    epochs = sorted((p for p in Path(ckpt_dir).iterdir()
                     if p.name.isdigit()), key=lambda p: int(p.name))
    publish_to_gcs(epochs[-1] if epochs else ckpt_dir, args.output_bucket,
                   args.output_dir)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.data.device_aug import (
        MPII_FLIP_PERM,
        DeviceAugment,
        augment_step,
    )
    from deepvision_tpu_torch.data.imagenet import (
        PT_JITTER,
        make_imagenet_data,
    )
    from deepvision_tpu_torch.data.detection import (
        make_detection_data,
        synthetic_batches,
        synthetic_detection,
    )
    from deepvision_tpu_torch.data.mnist import (
        batches,
        load_mnist_idx,
        synthetic_mnist,
    )
    from deepvision_tpu_torch.data.pose import (
        make_pose_data,
        synthetic_pose,
        synthetic_pose_batches,
    )
    from deepvision_tpu_torch.data.synthetic import synthetic_classification
    from deepvision_tpu_torch.device import resolve_device, strict_fp32
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.steps import (
        centernet_eval_step,
        centernet_train_step,
        classification_eval_step,
        classification_train_step,
        pose_eval_step,
        pose_train_step,
        yolo_eval_step,
        yolo_train_step,
    )
    from deepvision_tpu_torch.train.trainer import Trainer

    cfg = get_config(args.model)
    if args.batch_size:
        cfg["batch_size"] = args.batch_size
    if args.num_classes:
        cfg["num_classes"] = args.num_classes
    if args.lr:
        cfg["optimizer_params"]["lr"] = args.lr
    if args.num_joints and "num_heatmaps" in cfg:
        cfg["num_heatmaps"] = args.num_joints
    if args.input_size:
        cfg["input_size"] = args.input_size
    policy = get_policy(args.precision or cfg["precision"])
    cfg["precision"] = policy.name
    check_data_flags(args, cfg)
    device = resolve_device(args.device)
    if device.type == "cuda":
        strict_fp32()  # float32 math in full float32, as on the CPU

    _maybe_enable_trace(args)
    if cfg["dataset"].startswith("gan"):
        try:
            return run_gan(args, cfg, policy, device)
        finally:
            _maybe_export_trace(args)
    recovery, injector, sentinel = _resilience(args)
    bs, size = cfg["batch_size"], cfg["input_size"]
    detection = cfg["dataset"] == "detection"
    pose = cfg["dataset"] == "pose"
    if pose and args.data_dir:
        train_data, val_data, steps = make_pose_data(
            args.data_dir, bs, size,
            steps_per_epoch=args.steps_per_epoch or 22245 // bs,
            device_aug=args.device_aug)
    elif pose:
        n = args.synthetic_size
        size = cfg["input_size"] = min(size, 128)
        imgs, kx, ky, v = synthetic_pose(n, size=size,
                                         num_joints=cfg["num_heatmaps"])
        split = max(bs, int(n * 0.1))
        steps = args.steps_per_epoch or (n - split) // bs

        def train_data(epoch):
            return islice(synthetic_pose_batches(
                imgs[split:], kx[split:], ky[split:], v[split:], bs,
                rng=np.random.default_rng(epoch)), steps)

        def val_data():
            return synthetic_pose_batches(imgs[:split], kx[:split],
                                          ky[:split], v[:split], bs,
                                          drop_remainder=False)
    elif detection and args.data_dir:
        train_data, val_data, steps = make_detection_data(
            args.data_dir, bs, size,
            steps_per_epoch=args.steps_per_epoch or 2501 // bs,
            device_aug=args.device_aug)
    elif detection:
        n = args.synthetic_size
        size = cfg["input_size"] = min(size, 128)
        imgs, boxes, labels = synthetic_detection(
            n, size=size, num_classes=cfg["num_classes"])
        split = max(bs, int(n * 0.1))
        steps = args.steps_per_epoch or (n - split) // bs

        def train_data(epoch):
            return islice(synthetic_batches(
                imgs[split:], boxes[split:], labels[split:], bs,
                rng=np.random.default_rng(epoch), augment=True), steps)

        def val_data():
            return synthetic_batches(imgs[:split], boxes[:split],
                                     labels[:split], bs,
                                     drop_remainder=False)
    elif cfg["dataset"] == "mnist":
        if args.data_dir:
            tr_i, tr_l = load_mnist_idx(
                Path(args.data_dir) / "train-images-idx3-ubyte",
                Path(args.data_dir) / "train-labels-idx1-ubyte")
            va_i, va_l = load_mnist_idx(
                Path(args.data_dir) / "t10k-images-idx3-ubyte",
                Path(args.data_dir) / "t10k-labels-idx1-ubyte")
        else:
            n = args.synthetic_size
            imgs, labels = synthetic_mnist(n)
            split = max(bs, int(n * 0.1))
            tr_i, tr_l, va_i, va_l = (imgs[split:], labels[split:],
                                      imgs[:split], labels[:split])
        steps = args.steps_per_epoch or len(tr_l) // bs

        def train_data(epoch):
            return islice(batches(tr_i, tr_l, bs,
                                  rng=np.random.default_rng(epoch)), steps)

        def val_data():
            return batches(va_i, va_l, bs, drop_remainder=False)
    elif args.data_dir:
        train_data, val_data, steps = make_imagenet_data(
            args.data_dir, bs, size, augment=cfg.get("augment", "tf"),
            use_raw=args.use_raw, steps_per_epoch=args.steps_per_epoch,
            device_aug=args.device_aug, loader_workers=args.loader_workers,
            max_worker_restarts=args.max_worker_restarts,
            fault_injector=injector)
    else:
        imgs, labels, split = synthetic_classification(
            args.synthetic_size, size, cfg["channels"], cfg["num_classes"],
            bs)
        steps = args.steps_per_epoch or (args.synthetic_size - split) // bs

        def train_data(epoch):
            return islice(batches(imgs[split:], labels[split:], bs,
                                  rng=np.random.default_rng(epoch)), steps)

        def val_data():
            return batches(imgs[:split], labels[:split], bs,
                           drop_remainder=False)

    kind = "torch" if cfg.get("augment") == "pt" else "imagenet"
    if pose:
        train_step, eval_step = pose_train_step, pose_eval_step
    elif detection and cfg.get("steps") == "centernet":
        train_step, eval_step = centernet_train_step, centernet_eval_step
    elif detection:
        train_step, eval_step = yolo_train_step, yolo_eval_step
    else:
        train_step = partial(classification_train_step, normalize_kind=kind)
        eval_step = partial(classification_eval_step, normalize_kind=kind)
    if args.device_aug and pose:
        # the left/right swap is the MPII joint order's; a reduced joint
        # count has no left and right to swap
        aug = DeviceAugment("pose", flip=True, flip_pairs=(
            MPII_FLIP_PERM if cfg["num_heatmaps"] == 16 else None))
    elif args.device_aug:
        aug = (DeviceAugment("detection", flip=True) if detection
               else DeviceAugment(
                   "classification", flip=True,
                   jitter=PT_JITTER if cfg.get("augment") == "pt" else 0.0,
                   mixup=args.mixup))
    if args.device_aug:
        train_step = augment_step(train_step, aug)
        print(f"[device-aug] {aug} fused into the train step", flush=True)
    model_kwargs = dict(cfg.get("model_kwargs", {}))
    if pose:
        model_kwargs["num_heatmaps"] = cfg["num_heatmaps"]
    module = create_model(args.model, device=device, seed=0,
                          num_classes=cfg["num_classes"], input_size=size,
                          dtype=policy.compute_dtype, **model_kwargs)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + f"  model: {args.model} {size}x{size}x{cfg['channels']} -> "
          + (f"{cfg['num_heatmaps']} joints" if pose
             else f"{cfg['num_classes']} classes")
          + f", batch {bs}, {steps} steps an "
          f"epoch, precision {policy.name}, model_kwargs {model_kwargs}",
          flush=True)
    trainer = Trainer(
        module, cfg, train_data, val_data, device=device,
        workdir=args.workdir, prefetch_depth=args.prefetch_depth,
        steps_per_epoch=steps, train_step=train_step, eval_step=eval_step,
        check_numerics=args.check_numerics,
        async_checkpoint=args.async_checkpoint, keep_best=args.keep_best,
        data_echo=args.data_echo, stall_timeout=args.stall_timeout or None,
        stall_abort=args.stall_abort, rss_limit_gb=args.rss_limit_gb or None,
        recovery=recovery, fault_injector=injector, sentinel=sentinel,
        ckpt_integrity=not args.no_ckpt_integrity,
        profile_steps=args.profile_steps, profile_dir=args.profile_dir)
    if args.resume or args.checkpoint is not None:
        trainer.resume(args.checkpoint)
        print(f"resumed at epoch {trainer.start_epoch}"
              + (f" step {trainer.start_step}" if trainer.start_step
                 else ""), flush=True)
    # SIGTERM -> a mid-epoch checkpoint and exit 143; --resume goes on
    trainer.install_preemption_handler()
    from deepvision_tpu_torch.resilience.sentinel import SentinelTrip

    try:
        trainer.fit(args.epochs)
    except SentinelTrip as e:
        # a silent-corruption verdict: 76 tells a supervisor it was
        # neither a crash nor a preemption
        print(f"[sentinel] FATAL: {e}", flush=True)
        raise SystemExit(76) from e
    finally:
        _maybe_export_trace(args)  # a cut run's trace is worth reading
    if trainer.preempted:
        print(f"[train] {args.model}: preempted; checkpoints "
              f"{trainer.ckpt.saved_epochs()} under {trainer.ckpt.directory};"
              f" kernel launches {_launches()}", file=sys.stderr, flush=True)
        raise SystemExit(143)
    _maybe_publish(args, trainer.ckpt.directory)
    print(f"[train] {args.model}: epochs {trainer.start_epoch}.."
          f"{(args.epochs or cfg['total_epochs']) - 1} done, checkpoints "
          f"{trainer.ckpt.saved_epochs()} under {trainer.ckpt.directory}; "
          f"kernel launches {_launches()}", file=sys.stderr, flush=True)
    return 0


def _launches() -> dict:
    """Every kernel of the port's, launched by this process so far."""
    from deepvision_tpu_torch.ops import kernel_launches

    return kernel_launches()


def run_gan(args, cfg: dict, policy, device) -> int:
    """The GAN path, ``train.py``'s ``run_gan``: the two-network state and
    ``fit_gan``."""
    import torch

    from deepvision_tpu_torch.data.padding import iter_array_batches
    from deepvision_tpu_torch.train import gan
    from deepvision_tpu_torch.train.schedules import linear_decay

    bs = cfg["batch_size"]
    epochs = args.epochs or cfg["total_epochs"]
    dtype = policy.compute_dtype
    if cfg["name"] == "dcgan":
        from deepvision_tpu_torch.data.mnist import (
            load_mnist_idx,
            synthetic_mnist,
        )

        if args.data_dir:
            imgs, _ = load_mnist_idx(
                Path(args.data_dir) / "train-images-idx3-ubyte",
                Path(args.data_dir) / "train-labels-idx1-ubyte",
                pad_to_32=False)
        else:
            imgs, _ = synthetic_mnist(args.synthetic_size)
            imgs = imgs[:, 2:30, 2:30, :]  # 28x28, DCGAN's geometry
        imgs = (imgs * 2.0 - 1.0).astype(np.float32)
        steps = len(imgs) // bs

        def train_data(epoch):
            return iter_array_batches({"image": imgs}, bs,
                                      rng=np.random.default_rng(epoch))

        state = gan.create_dcgan_state(
            noise_dim=cfg["noise_dim"], lr=cfg["optimizer_params"]["lr"],
            policy=policy, dtype=dtype, device=device)
        step = partial(gan.dcgan_train_step, label_smooth=args.label_smooth)
        size = cfg["input_size"]
    else:
        size = cfg["input_size"]
        if args.data_dir:
            from deepvision_tpu_torch.data.gan import make_cyclegan_data

            steps = args.steps_per_epoch or 1000 // bs
            train_data = make_cyclegan_data(
                args.data_dir, bs, size, steps_per_epoch=steps,
                device_aug=args.device_aug)
        else:
            from deepvision_tpu_torch.data.gan import synthetic_unpaired

            size = cfg["input_size"] = min(size, 64)
            a, b = synthetic_unpaired(args.synthetic_size, size=size)
            steps = len(a) // bs

            def train_data(epoch):
                return iter_array_batches({"a": a, "b": b}, bs,
                                          rng=np.random.default_rng(epoch))

        schedule = linear_decay(cfg["optimizer_params"]["lr"],
                                cfg["total_epochs"] * steps,
                                cfg["decay_epochs"] * steps)
        state = gan.create_cyclegan_state(
            image_size=size, lr_schedule=schedule,
            beta1=cfg["optimizer_params"]["beta1"], policy=policy,
            dtype=dtype, device=device)
        step = gan.cyclegan_train_step
        if args.device_aug:
            from deepvision_tpu_torch.data.device_aug import (
                DeviceAugment,
                augment_step,
            )

            aug = DeviceAugment("gan", crop=size, flip=True,
                                normalize="tanh")
            step = augment_step(step, aug)
            print(f"[device-aug] {aug} fused into the train step",
                  flush=True)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + f"  model: {args.model} {size}x{size}x{cfg['channels']}, batch "
          f"{bs}, {steps} steps an epoch, precision {policy.name}",
          flush=True)
    workdir = Path(args.workdir) / cfg["name"]
    from deepvision_tpu_torch.train.trainer import (
        StallWatchdog,
        make_preempt_flag,
        make_rss_limit_flag,
    )

    # SIGTERM -> a save at the epoch's end and exit 143; the RSS limit
    # rides the same poll
    preempted = make_preempt_flag()
    if args.rss_limit_gb:
        rss_exceeded = make_rss_limit_flag(args.rss_limit_gb)
        sigterm = preempted

        def preempted():
            return sigterm() or rss_exceeded()
    watchdog = (StallWatchdog(args.stall_timeout, abort=args.stall_abort)
                if args.stall_timeout else None)
    gan.fit_gan(state, step, train_data, epochs=epochs, workdir=workdir,
                save_every=cfg.get("save_every", 2),
                resume=args.resume or args.checkpoint is not None,
                resume_epoch=args.checkpoint,
                prefetch_depth=args.prefetch_depth, config=cfg,
                async_checkpoint=args.async_checkpoint, preempt=preempted,
                watchdog=watchdog, check_numerics=args.check_numerics)
    from deepvision_tpu_torch.train.checkpoint import CheckpointManager

    if preempted():
        raise SystemExit(143)
    _maybe_publish(args, workdir / "ckpt")
    saved = CheckpointManager(workdir / "ckpt").saved_epochs()
    print(f"[train] {args.model}: epochs up to {epochs - 1} done, "
          f"checkpoints {saved} under {workdir / 'ckpt'}; kernel launches "
          f"{_launches()}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

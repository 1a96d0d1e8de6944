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
builds it. The flags are
``train.py``'s names for what this slice serves, refused where
``train.py`` refuses them; the others are not ported and are absent, so
that no flag is silently ignored.
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
    args = p.parse_args(argv)
    if args.prefetch_depth < 1:
        p.error(f"--prefetch-depth must be >= 1, got {args.prefetch_depth}")
    return args


def check_data_flags(args, cfg: dict) -> None:
    """``train.py``'s refusals of the data flags, with their meaning:
    ``--raw`` needs a ``--data-dir`` ImageNet config, ``--device-aug`` a
    ``--data-dir`` ImageNet, detection, pose or CycleGAN config,
    ``--mixup`` also ``--device-aug`` on ImageNet and a non-negative
    alpha, and ``--label-smooth`` the DCGAN config and a value in [0,
    1)."""
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

    if cfg["dataset"].startswith("gan"):
        return run_gan(args, cfg, policy, device)
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
            device_aug=args.device_aug)
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
        steps_per_epoch=steps, train_step=train_step, eval_step=eval_step)
    if args.resume or args.checkpoint is not None:
        trainer.resume(args.checkpoint)
        print(f"resumed at epoch {trainer.start_epoch}", flush=True)
    trainer.fit(args.epochs)
    print(f"[train] {args.model}: epochs {trainer.start_epoch}.."
          f"{(args.epochs or cfg['total_epochs']) - 1} done, checkpoints "
          f"{trainer.ckpt.saved_epochs()} under {trainer.ckpt.directory}; "
          f"kernel launches {_launches()}", file=sys.stderr, flush=True)
    return 0


def _launches() -> dict:
    """Every kernel of the port's, launched by this process so far."""
    from deepvision_tpu_torch.data.jpeg import ycc_launches
    from deepvision_tpu_torch.ops.lrn_cuda import (
        local_response_norm_backward_cuda,
        local_response_norm_cuda,
    )
    from deepvision_tpu_torch.ops.nms_cuda import nms_sweep_cuda

    return {**local_response_norm_cuda.launches_by_kernel,
            **local_response_norm_backward_cuda.launches_by_kernel,
            "ycc_to_rgb": ycc_launches(),
            "nms_sweep": nms_sweep_cuda.launches}


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
    gan.fit_gan(state, step, train_data, epochs=epochs, workdir=workdir,
                save_every=cfg.get("save_every", 2),
                resume=args.resume or args.checkpoint is not None,
                resume_epoch=args.checkpoint,
                prefetch_depth=args.prefetch_depth, config=cfg)
    from deepvision_tpu_torch.train.checkpoint import CheckpointManager

    saved = CheckpointManager(workdir / "ckpt").saved_epochs()
    print(f"[train] {args.model}: epochs up to {epochs - 1} done, "
          f"checkpoints {saved} under {workdir / 'ckpt'}; kernel launches "
          f"{_launches()}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's copy of the LeNet-5, AlexNet, VGG, Inception V1 and V3,
ResNet, MobileNet V1, ShuffleNet V1, Darknet-53, YOLO v3, DCGAN,
CycleGAN, CenterNet and Hourglass-104 entries of ``train/configs.py``:
every entry of the JAX table.

``alexnet1`` and ``alexnet2`` carry the JAX table's training fields (SGD
0.01 / 0.9 / 5e-4, plateau on validation top-1, bf16, batch 128),
``inception1`` its (SGD 0.01 / 0.9 / 2e-4, the ``inception_poly``
schedule, bf16, batch 128), ``resnet34``, ``resnet50`` and
``resnet50v2`` theirs (SGD 0.1 / 0.9 / 1e-4, plateau, bf16, batch 256;
the V1 pair builds its model with ``model_kwargs`` ``{"s2d_stem":
True}``, and V2 has no ``augment``, so it normalizes as
``"imagenet"``). :func:`get_config` fills the JAX table's defaults and,
as the JAX ``get_config`` does, gives a ``<model>_ref`` variant
(``inception1_ref``, the reference's BN-free architecture) its base
model's entry under its own name. ``resnet152`` carries ``resnet50``'s
fields and ``remat: "block"``; as in the JAX ``get_config``, an entry's
``remat`` (else the registry's ``model_remat``) is folded into
``model_kwargs``, so that the trainer builds the model with it.
``darknet53`` carries the JAX entry of the YOLO backbone's ImageNet
pretraining (SGD 0.1 / 0.9 / 5e-4, a step schedule of 30 epochs at
0.1, bf16, batch 128, 256 px) and ``yolov3`` the detector's (Adam 0.01,
plateau on the negated validation loss with patience 10, bf16, batch
16, 416 px, 20 VOC classes, ``"dataset": "detection"``),
``centernet`` its (Adam 1e-3, the same plateau, bf16, batch 16, 256
px, 80 COCO classes, ``"steps": "centernet"``, which picks the
CenterNet steps over the detection data) and ``hourglass104`` the pose
entry (Adam 1e-4, the same plateau, ``bf16_scaled``, ``remat:
"stack"``, batch 16, 256 px, 16 MPII joints, ``"dataset": "pose"``).
``lenet5`` carries MNIST's (Adam 1e-3, plateau, float32, batch 64, 32x32x1,
10 classes, ``"dataset": "mnist"``), ``dcgan`` DCGAN's (two Adams at
1e-4, bf16, batch 256, 28x28x1, noise 100, a checkpoint every 2 epochs,
50 epochs, ``"dataset": "gan_mnist"``) and ``cyclegan`` CycleGAN's (two
Adams at 2e-4 with β1 0.5 under ``linear_decay`` to 0 from epoch
``decay_epochs`` = 100 to 200, bf16, batch 4, 256 px, a checkpoint every
epoch, ``"dataset": "gan_unpaired"``).
``vgg16`` and ``vgg19`` carry theirs (SGD 0.01 / 0.9 / 5e-4, a step
schedule of 10 epochs at 0.5, bf16, batch 128 and 64), ``mobilenet1``
MobileNet's (RMSprop 0.045 with alpha 0.9 and eps 1.0, a step schedule
of 2 epochs at 0.94, bf16, batch 128), ``shufflenet1`` ShuffleNet's (SGD
0.1 / 0.9 / 4e-5, a step schedule of 30 epochs at 0.1, bf16, batch 256)
and ``inception3`` Inception V3's (MobileNet's RMSprop and schedule,
bf16, batch 128, 299 px, no ``augment``: it normalizes as
``"imagenet"``).
``alexnet2_tf`` has no entry in the JAX table
and stays serving-only here (its pixel convention is ``"tf"``):
:data:`TRAINABLE` lists the models that train.
"""

from __future__ import annotations

import copy

__all__ = ["TRAINING_CONFIG", "TRAINABLE", "get_config"]

_ALEXNET_TRAINING = {
    "precision": "bf16",
    "augment": "pt",
    "batch_size": 128,
    "input_size": 224,
    "optimizer": "sgd",
    "optimizer_params": {"lr": 0.01, "momentum": 0.9, "weight_decay": 5e-4},
    "scheduler": "plateau",
    "scheduler_params": {"factor": 0.1, "mode": "max"},
    "total_epochs": 200,
}

_RESNET_TRAINING = {
    "precision": "bf16",
    "augment": "pt",
    "batch_size": 256,
    "input_size": 224,
    "optimizer": "sgd",
    "optimizer_params": {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-4},
    "scheduler": "plateau",
    "scheduler_params": {"factor": 0.1, "mode": "max"},
    "total_epochs": 200,
    # the JAX package's space-to-depth stem: the same numbers over the
    # same kernel, with flax's stock BatchNorm on the stem
    "model_kwargs": {"s2d_stem": True},
}

TRAINING_CONFIG: dict[str, dict] = {
    # ref: deepvision_tpu/train/configs.py "lenet5"
    "lenet5": {
        "precision": "f32",
        "batch_size": 64,
        "input_size": 32,
        "channels": 1,
        "num_classes": 10,
        "dataset": "mnist",
        "optimizer": "adam",
        "optimizer_params": {"lr": 1e-3},
        "scheduler": "plateau",
        "scheduler_params": {"factor": 0.1, "mode": "max"},
        "total_epochs": 50,
    },
    # ref: deepvision_tpu/train/configs.py "alexnet1"
    "alexnet1": copy.deepcopy(_ALEXNET_TRAINING),
    # ref: deepvision_tpu/train/configs.py "alexnet2"
    "alexnet2": copy.deepcopy(_ALEXNET_TRAINING),
    "alexnet2_tf": {"input_size": 224, "channels": 3, "num_classes": 1000,
                    "augment": "tf"},
    # ref: deepvision_tpu/train/configs.py "vgg16"
    "vgg16": {
        "precision": "bf16",
        "augment": "pt",
        "batch_size": 128,
        "input_size": 224,
        "optimizer": "sgd",
        "optimizer_params": {"lr": 0.01, "momentum": 0.9,
                             "weight_decay": 5e-4},
        "scheduler": "step",
        "scheduler_params": {"step_size": 10, "gamma": 0.5},
        "total_epochs": 200,
    },
    # ref: deepvision_tpu/train/configs.py "vgg19"
    "vgg19": {
        "precision": "bf16",
        "augment": "pt",
        "batch_size": 64,
        "input_size": 224,
        "optimizer": "sgd",
        "optimizer_params": {"lr": 0.01, "momentum": 0.9,
                             "weight_decay": 5e-4},
        "scheduler": "step",
        "scheduler_params": {"step_size": 10, "gamma": 0.5},
        "total_epochs": 200,
    },
    # ref: deepvision_tpu/train/configs.py "inception1"
    "inception1": {
        "precision": "bf16",
        "augment": "pt",
        "batch_size": 128,
        "input_size": 224,
        "optimizer": "sgd",
        "optimizer_params": {"lr": 0.01, "momentum": 0.9,
                             "weight_decay": 2e-4},
        "scheduler": "inception_poly",
        "total_epochs": 200,
    },
    # ref: deepvision_tpu/train/configs.py "resnet34"
    "resnet34": copy.deepcopy(_RESNET_TRAINING),
    # ref: deepvision_tpu/train/configs.py "resnet50", the north star
    "resnet50": copy.deepcopy(_RESNET_TRAINING),
    # ref: deepvision_tpu/train/configs.py "resnet152": every block
    # rematerialized ("block"), trading a recomputed forward for the
    # saved activations of 50 blocks
    "resnet152": {"remat": "block", **copy.deepcopy(_RESNET_TRAINING)},
    # ref: deepvision_tpu/train/configs.py "resnet50v2"
    "resnet50v2": {k: copy.deepcopy(v) for k, v in _RESNET_TRAINING.items()
                   if k not in ("augment", "model_kwargs")},
    # ref: deepvision_tpu/train/configs.py "mobilenet1": optax's
    # RMSprop (eps inside the square root, trap C7)
    "mobilenet1": {
        "precision": "bf16",
        "augment": "pt",
        "batch_size": 128,
        "input_size": 224,
        "optimizer": "rmsprop",
        "optimizer_params": {"lr": 0.045, "alpha": 0.9, "eps": 1.0},
        "scheduler": "step",
        "scheduler_params": {"step_size": 2, "gamma": 0.94},
        "total_epochs": 200,
    },
    # ref: deepvision_tpu/train/configs.py "shufflenet1"
    "shufflenet1": {
        "precision": "bf16",
        "augment": "pt",
        "batch_size": 256,
        "input_size": 224,
        "optimizer": "sgd",
        "optimizer_params": {"lr": 0.1, "momentum": 0.9,
                             "weight_decay": 4e-5},
        "scheduler": "step",
        "scheduler_params": {"step_size": 30, "gamma": 0.1},
        "total_epochs": 120,
    },
    # ref: deepvision_tpu/train/configs.py "inception3"
    "inception3": {
        "precision": "bf16",
        "batch_size": 128,
        "input_size": 299,
        "optimizer": "rmsprop",
        "optimizer_params": {"lr": 0.045, "alpha": 0.9, "eps": 1.0},
        "scheduler": "step",
        "scheduler_params": {"step_size": 2, "gamma": 0.94},
        "total_epochs": 200,
    },
    # ref: deepvision_tpu/train/configs.py "darknet53"
    "darknet53": {
        "precision": "bf16",
        "batch_size": 128,
        "input_size": 256,
        "optimizer": "sgd",
        "optimizer_params": {"lr": 0.1, "momentum": 0.9,
                             "weight_decay": 5e-4},
        "scheduler": "step",
        "scheduler_params": {"step_size": 30, "gamma": 0.1},
        "total_epochs": 120,
    },
    # ref: deepvision_tpu/train/configs.py "yolov3"
    "yolov3": {
        "precision": "bf16",
        "batch_size": 16,
        "input_size": 416,
        "num_classes": 20,
        "dataset": "detection",
        "optimizer": "adam",
        "optimizer_params": {"lr": 0.01},
        "scheduler": "plateau",
        "scheduler_params": {"factor": 0.1, "mode": "max", "patience": 10},
        "total_epochs": 300,
    },
    # ref: deepvision_tpu/train/configs.py "dcgan"
    "dcgan": {
        "precision": "bf16",
        "batch_size": 256,
        "input_size": 28,
        "channels": 1,
        "dataset": "gan_mnist",
        "noise_dim": 100,
        "optimizer": "adam",
        "optimizer_params": {"lr": 1e-4},
        "save_every": 2,
        "total_epochs": 50,
    },
    # ref: deepvision_tpu/train/configs.py "cyclegan"
    "cyclegan": {
        "precision": "bf16",
        "batch_size": 4,
        "input_size": 256,
        "dataset": "gan_unpaired",
        "optimizer": "adam",
        "optimizer_params": {"lr": 2e-4, "beta1": 0.5},
        "decay_epochs": 100,
        "save_every": 1,
        "total_epochs": 200,
    },
    # ref: deepvision_tpu/train/configs.py "centernet"
    "centernet": {
        "precision": "bf16",
        "batch_size": 16,
        "input_size": 256,
        "num_classes": 80,
        "dataset": "detection",
        "steps": "centernet",
        "optimizer": "adam",
        "optimizer_params": {"lr": 1e-3},
        "scheduler": "plateau",
        "scheduler_params": {"factor": 0.1, "mode": "max", "patience": 10},
        "total_epochs": 100,
    },
    # ref: deepvision_tpu/train/configs.py "hourglass104": loss scaling
    # over bf16, the float32 carrier in the model, and per-stack remat
    "hourglass104": {
        "batch_size": 16,
        "input_size": 256,
        "num_heatmaps": 16,
        "dataset": "pose",
        "optimizer": "adam",
        "optimizer_params": {"lr": 1e-4},
        "precision": "bf16_scaled",
        "remat": "stack",
        "scheduler": "plateau",
        "scheduler_params": {"factor": 0.1, "mode": "max", "patience": 10},
        "total_epochs": 100,
    },
}

# reference-exact variants, trained with their base model's entry
_REF_VARIANTS = ("inception1_ref",)

TRAINABLE = tuple(sorted(
    [n for n, c in TRAINING_CONFIG.items() if "optimizer" in c]
    + list(_REF_VARIANTS)))


def get_config(name: str) -> dict:
    """A deep copy of ``name``'s entry (a ``_ref`` variant's base
    model's) with the JAX table's defaults; ``model_kwargs``, where the
    entry has them, are what the trainer builds the model with, the
    remat policy folded in."""
    base = name.removesuffix("_ref") if name in _REF_VARIANTS else name
    try:
        cfg = copy.deepcopy(TRAINING_CONFIG[base])
    except KeyError:
        raise KeyError(
            f"no config for {name!r}; known: "
            f"{sorted([*TRAINING_CONFIG, *_REF_VARIANTS])}") from None
    cfg.setdefault("input_size", 224)
    cfg.setdefault("channels", 3)
    cfg.setdefault("num_classes", 1000)
    cfg.setdefault("dataset", "imagenet")
    cfg.setdefault("precision", "bf16")
    if "remat" not in cfg:
        from deepvision_tpu_torch.models.registry import model_remat

        cfg["remat"] = model_remat(base)
    if cfg["remat"] is not None:
        cfg.setdefault("model_kwargs", {}).setdefault("remat", cfg["remat"])
    cfg["name"] = name
    return cfg

"""Reference PyTorch checkpoints -> the port's state dicts.

The twin of ``deepvision_tpu/convert/torch_import.py``. It reads the
reference's checkpoint dict of everything (``{"epoch", "model",
"optimizer", ...}``) or a bare state dict, with or without
``nn.DataParallel``'s ``module.`` prefix (:func:`strip_module_prefix`,
:func:`load_torch_checkpoint`, which loads with ``weights_only=True``),
and composes two maps, so that no name table is written twice:

1. the JAX package's key rules, copied here: a reference key -> its flax
   path and layout (conv ``(O, I, KH, KW)`` -> ``(KH, KW, I, O)``,
   linear ``(O, I)`` -> ``(I, O)`` with the NCHW flatten turned NHWC at
   the conv-to-linear boundary, BN weight/bias -> ``params`` scale/bias,
   running mean/var -> ``batch_stats``), for the ResNets (stage/block
   naming), the Sequential nets (VGG-16/19, AlexNet V2: modules zipped in
   order), MobileNet V1 (dw/pw separable convs) and the BN-free
   Inception V1 with its aux heads (:func:`torch_to_flax` and the
   ``*_torch_to_flax`` functions);
2. ``convert/from_flax.flax_to_torch``: the flax variables -> the port
   module's state dict, whose names are the flax paths, every leaf
   checked against the module's shapes.

:func:`convert_state_dict` picks the family by model name and returns
the port's state dict. Unmapped keys raise, so no leaf is left at its
fresh value unnoticed.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping

import numpy as np

__all__ = ["strip_module_prefix", "load_torch_checkpoint", "torch_to_flax",
           "resnet_torch_to_flax", "sequential_torch_to_flax",
           "mobilenet_torch_to_flax", "inception_torch_to_flax",
           "VGG16_LAYERS", "VGG19_LAYERS", "ALEXNET2_LAYERS", "SEQUENTIAL",
           "convert_state_dict"]


def strip_module_prefix(state_dict: Mapping) -> dict:
    """Drop DataParallel's ``module.`` prefix (ref: README.md:85-93)."""
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }


def load_torch_checkpoint(path) -> dict:
    """Read a ``.pt`` file → numpy state dict (handles the reference's
    full-checkpoint dict and raw state dicts). Loads with
    ``weights_only=True``: tensors and plain containers, no pickled
    code (a pickled module is refused; save its ``state_dict``)."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj and isinstance(
        obj["model"], dict
    ):
        obj = obj["model"]  # ref: train.py:417-428 schema
    return {
        k: np.asarray(v.detach().cpu().numpy())
        for k, v in strip_module_prefix(obj).items()
    }


def _to_numpy(v):
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _set(tree: dict, path: tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


_BN_FIELDS = {
    "weight": ("params", "scale", lambda v: v),
    "bias": ("params", "bias", lambda v: v),
    "running_mean": ("batch_stats", "mean", lambda v: v),
    "running_var": ("batch_stats", "var", lambda v: v),
}


def _resnet_key(key: str):
    """reference torch key -> (collection, flax path, transform) or None."""
    conv_t = lambda v: v.transpose(2, 3, 1, 0)
    if key == "conv1.weight":
        return "params", ("stem", "conv", "kernel"), conv_t
    m = re.fullmatch(r"bn1\.(\w+)", key)
    if m and m.group(1) in _BN_FIELDS:
        coll, leaf, f = _BN_FIELDS[m.group(1)]
        return coll, ("stem", "bn", leaf), f
    m = re.fullmatch(
        r"conv(\d)x\.(\d+)\.(conv|bn)(\d)\.(\w+)", key
    )
    if m:
        stage, block, kind, k, field = m.groups()
        base = (f"stage{int(stage) - 1}_block{int(block) + 1}", f"conv{k}")
        if kind == "conv":
            return "params", base + ("conv", "kernel"), conv_t
        if field in _BN_FIELDS:
            coll, leaf, f = _BN_FIELDS[field]
            return coll, base + ("bn", leaf), f
        return None  # num_batches_tracked
    m = re.fullmatch(
        r"conv(\d)x\.(\d+)\.projection\.([01])\.(\w+)", key
    )
    if m:
        stage, block, idx, field = m.groups()
        base = (f"stage{int(stage) - 1}_block{int(block) + 1}", "proj")
        if idx == "0":
            return "params", base + ("conv", "kernel"), conv_t
        if field in _BN_FIELDS:
            coll, leaf, f = _BN_FIELDS[field]
            return coll, base + ("bn", leaf), f
        return None
    if key == "linear.weight":
        return "params", ("fc", "kernel"), lambda v: v.T
    if key == "linear.bias":
        return "params", ("fc", "bias"), lambda v: v
    return None


def torch_to_flax(
    state_dict: Mapping, key_fn: Callable[[str], Any] = _resnet_key
) -> dict:
    """state dict -> {'params': ..., 'batch_stats': ...} (f32 numpy).

    Unmapped keys raise so silent coverage gaps can't produce a model with
    randomly-initialized leftovers.
    """
    out: dict[str, dict] = {"params": {}, "batch_stats": {}}
    skipped = []
    for key, value in strip_module_prefix(dict(state_dict)).items():
        spec = key_fn(key)
        if spec is None:
            skipped.append(key)
            continue
        coll, path, transform = spec
        _set(out[coll], path, transform(_to_numpy(value)).astype(np.float32))
    hard_misses = [
        k for k in skipped if not k.endswith("num_batches_tracked")
    ]
    if hard_misses:
        raise KeyError(f"unmapped torch keys: {hard_misses[:10]}")
    return out


def resnet_torch_to_flax(state_dict: Mapping) -> dict:
    """Reference ResNet-34/50/152 torch weights → Flax variables for
    ``models.resnet`` (same mapping covers all three depths)."""
    return torch_to_flax(state_dict, _resnet_key)


def sequential_torch_to_flax(
    state_dict: Mapping,
    layer_names: list[str],
    *,
    flatten_grid: tuple[int, int] | None = None,
) -> dict:
    """Ordered conv/linear torch nets (VGG/AlexNet/LeNet families, whose
    state dicts are ``features.N``/``classifier.N`` Sequential keys —
    ref: VGG/pytorch/models/vgg16.py, AlexNet/pytorch/models/alexnet_v2.py)
    → Flax variables, zipping the torch modules in order with
    ``layer_names``.

    ``flatten_grid``: the (H, W) of the activation entering the first
    linear layer. torch flattens NCHW (C·H·W order) while the Flax models
    flatten NHWC, so that weight's input dimension is permuted
    C,H,W → H,W,C before transposing.
    """
    sd = {
        k: _to_numpy(v)
        for k, v in strip_module_prefix(dict(state_dict)).items()
    }
    prefixes: list[str] = []
    for k in sd:
        p = k.rsplit(".", 1)[0]
        if p not in prefixes:
            prefixes.append(p)
    if len(prefixes) != len(layer_names):
        raise ValueError(
            f"{len(prefixes)} torch layers vs {len(layer_names)} names"
        )
    params: dict = {}
    prev_channels = None
    first_linear = True
    for prefix, name in zip(prefixes, layer_names):
        if f"{prefix}.bias" not in sd:
            raise KeyError(
                f"{prefix}: no bias — sequential mapping covers "
                "conv/linear layers with bias only"
            )
        w = sd[f"{prefix}.weight"].astype(np.float32)
        b = sd[f"{prefix}.bias"].astype(np.float32)
        if w.ndim == 4:  # conv (O, I, KH, KW) -> (KH, KW, I, O)
            kernel = w.transpose(2, 3, 1, 0)
            prev_channels = w.shape[0]
        elif w.ndim == 2:  # linear (O, I) -> (I, O)
            if first_linear and prev_channels is not None:
                # the conv→linear boundary: torch flattened NCHW, the
                # Flax models flatten NHWC — permute or fail LOUDLY
                # (a silent skip would scramble the fc weights)
                if flatten_grid is None:
                    if w.shape[1] != prev_channels:
                        raise ValueError(
                            f"{prefix}: in_features {w.shape[1]} != "
                            f"{prev_channels} conv channels — this net "
                            "flattens a spatial grid; pass flatten_grid"
                        )
                else:
                    h, wd = flatten_grid
                    if w.shape[1] != prev_channels * h * wd:
                        raise ValueError(
                            f"{prefix}: in_features {w.shape[1]} != "
                            f"{prev_channels}·{h}·{wd} — wrong "
                            "flatten_grid for this architecture"
                        )
                    w = (
                        w.reshape(w.shape[0], prev_channels, h, wd)
                        .transpose(0, 2, 3, 1)
                        .reshape(w.shape[0], -1)
                    )
            first_linear = False
            kernel = w.T
        else:
            raise ValueError(
                f"{prefix}: unsupported weight rank {w.ndim} "
                "(BatchNorm-style layers need a per-architecture key_fn, "
                "see torch_to_flax)"
            )
        params[name] = {"kernel": kernel, "bias": b}
    return {"params": params, "batch_stats": {}}


# Layer orders for the reference's Sequential architectures.
VGG16_LAYERS = [
    "conv1_1", "conv1_2", "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3",
    "conv4_1", "conv4_2", "conv4_3",
    "conv5_1", "conv5_2", "conv5_3",
    "fc1", "fc2", "fc3",
]
VGG19_LAYERS = [
    "conv1_1", "conv1_2", "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3", "conv3_4",
    "conv4_1", "conv4_2", "conv4_3", "conv4_4",
    "conv5_1", "conv5_2", "conv5_3", "conv5_4",
    "fc1", "fc2", "fc3",
]
ALEXNET2_LAYERS = [
    "conv1", "conv2", "conv3", "conv4", "conv5", "fc6", "fc7", "fc8",
]


def _mobilenet_key(key: str):
    """Reference MobileNet V1 torch keys → models.mobilenet paths
    (ref: MobileNet/pytorch/models/mobilenet_v1.py:27-87: ``features.0``
    stem conv, ``features.1`` stem BN, ``features.{3..15}`` 13
    DepthwiseSeparableConvs with dw/pw conv+bn children, ``linear`` head).

    Depthwise kernels: torch (C, 1, KH, KW) with ``groups=C`` →
    Flax ``feature_group_count`` layout (KH, KW, 1, C) — the same
    (2, 3, 1, 0) transpose as dense convs.
    """
    conv_t = lambda v: v.transpose(2, 3, 1, 0)
    if key == "features.0.weight":
        return "params", ("stem", "conv", "kernel"), conv_t
    m = re.fullmatch(r"features\.1\.(\w+)", key)
    if m and m.group(1) in _BN_FIELDS:
        coll, leaf, f = _BN_FIELDS[m.group(1)]
        return coll, ("stem", "bn", leaf), f
    m = re.fullmatch(r"features\.(\d+)\.(dw|pw)\.conv\.weight", key)
    if m:
        idx, branch = m.groups()
        return ("params",
                (f"ds{int(idx) - 2}", branch, "conv", "kernel"), conv_t)
    m = re.fullmatch(r"features\.(\d+)\.(dw|pw)\.bn\.(\w+)", key)
    if m:
        idx, branch, field = m.groups()
        if field in _BN_FIELDS:
            coll, leaf, f = _BN_FIELDS[field]
            return coll, (f"ds{int(idx) - 2}", branch, "bn", leaf), f
        return None  # num_batches_tracked
    if key == "linear.weight":
        return "params", ("fc", "kernel"), lambda v: v.T
    if key == "linear.bias":
        return "params", ("fc", "bias"), lambda v: v
    return None


def mobilenet_torch_to_flax(state_dict: Mapping) -> dict:
    """Reference MobileNet V1 torch weights → Flax variables."""
    return torch_to_flax(state_dict, _mobilenet_key)


_INCEPTION_STEM = {"conv7x7": "stem1", "conv1x1": "stem2", "conv3x3": "stem3"}
_INCEPTION_BRANCH = {
    "branch1_conv1x1": "b1",
    "branch2_conv1x1": "b3r", "branch2_conv3x3": "b3",
    "branch3_conv1x1": "b5r", "branch3_conv5x5": "b5",
    "branch4_conv1x1": "bp",
}


def _aux_fc1_weight(v):
    """The reference flattens the aux 4×4×128 activation NCHW (C-major,
    ref: inception_v1.py:185-189) while the Flax model flattens NHWC —
    permute the input dimension C,H,W → H,W,C before transposing."""
    out = v.shape[0]
    return (v.reshape(out, 128, 4, 4).transpose(0, 2, 3, 1)
            .reshape(out, -1).T)


def _inception_key(key: str):
    """Reference Inception V1 torch keys → models.inception paths for the
    ``bn=False`` parity variant (conv+bias blocks — the reference's
    BasicConv2d has NO BatchNorm, ref: inception_v1.py:193-200; aux heads
    ref: inception_v1.py:161-190)."""
    conv_t = lambda v: v.transpose(2, 3, 1, 0)
    m = re.fullmatch(r"(conv7x7|conv1x1|conv3x3)\.conv\.(weight|bias)", key)
    if m:
        name, field = m.groups()
        leaf = ("kernel", conv_t) if field == "weight" else ("bias", lambda v: v)
        return "params", (_INCEPTION_STEM[name], "conv", leaf[0]), leaf[1]
    m = re.fullmatch(
        r"inception_(\d[a-e])\.(branch\d_conv\dx\d)\.conv\.(weight|bias)", key
    )
    if m:
        mod, branch, field = m.groups()
        leaf = ("kernel", conv_t) if field == "weight" else ("bias", lambda v: v)
        return ("params",
                (f"i{mod}", _INCEPTION_BRANCH[branch], "conv", leaf[0]),
                leaf[1])
    m = re.fullmatch(r"aux([12])\.features\.1\.conv\.(weight|bias)", key)
    if m:
        idx, field = m.groups()
        leaf = ("kernel", conv_t) if field == "weight" else ("bias", lambda v: v)
        return "params", (f"aux{idx}", "proj", "conv", leaf[0]), leaf[1]
    m = re.fullmatch(r"aux([12])\.classifier\.([03])\.(weight|bias)", key)
    if m:
        idx, layer, field = m.groups()
        name = "fc1" if layer == "0" else "fc2"
        if field == "bias":
            return "params", (f"aux{idx}", name, "bias"), lambda v: v
        if name == "fc1":
            return "params", (f"aux{idx}", "fc1", "kernel"), _aux_fc1_weight
        return "params", (f"aux{idx}", "fc2", "kernel"), lambda v: v.T
    if key == "linear.weight":
        return "params", ("fc", "kernel"), lambda v: v.T
    if key == "linear.bias":
        return "params", ("fc", "bias"), lambda v: v
    return None


def inception_torch_to_flax(state_dict: Mapping) -> dict:
    """Reference Inception V1 torch weights (incl. aux heads) → Flax
    variables for ``InceptionV1(bn=False)``."""
    return torch_to_flax(state_dict, _inception_key)


# (layer list, flatten grid at the conv -> linear boundary) of each
# Sequential net
SEQUENTIAL = {
    "vgg16": (VGG16_LAYERS, (7, 7)),
    "vgg19": (VGG19_LAYERS, (7, 7)),
    "alexnet2": (ALEXNET2_LAYERS, (6, 6)),
}


def convert_state_dict(model_name: str, state_dict: Mapping,
                       **model_kw) -> dict:
    """A reference torch state dict -> the state dict of the port's
    ``model_name`` (``model_kw``: ``num_classes``, ``input_size``, ... of
    the module the leaves are checked against)."""
    from deepvision_tpu_torch.convert.from_flax import flax_to_torch

    if model_name in ("resnet34", "resnet50", "resnet152"):
        variables = resnet_torch_to_flax(state_dict)
    elif model_name == "inception1":
        raise ValueError(
            "reference Inception V1 weights are BN-free: convert them with "
            "-m inception1_ref (the reference-exact variant)")
    elif model_name == "inception1_ref":
        variables = inception_torch_to_flax(state_dict)
    elif model_name == "mobilenet1":
        variables = mobilenet_torch_to_flax(state_dict)
    elif model_name in SEQUENTIAL:
        layers, grid = SEQUENTIAL[model_name]
        variables = sequential_torch_to_flax(state_dict, layers,
                                             flatten_grid=grid)
    else:
        raise ValueError(f"no converter family map for model {model_name!r}")
    return flax_to_torch(model_name, variables, **model_kw)

"""Keras HDF5 weights -> the port's state dicts, the twin of
``deepvision_tpu/convert/keras_import.py``.

Reads a ``save_weights``-format HDF5 file (the reference's per-epoch
saves, keras-applications files) with h5py, imported on first use (the
card's machine has none; convert there from a ``.pt``). Keras kernels
are already ``(KH, KW, I, O)`` and ``(I, O)``; BN gamma, beta and the
moving mean and variance become scale, bias, mean and var. The name
rules are the keras-applications ResNet50V2 scheme
(``conv{s}_block{j}_{k}_conv`` ...) -> the flax paths of ``resnet50v2``
(:func:`keras_h5_to_flax`), and ``convert/from_flax.flax_to_torch`` takes
them to the port's state dict (:func:`keras_h5_to_port`).
"""

from __future__ import annotations

import re
from typing import Callable

import numpy as np

from deepvision_tpu_torch.convert.torch_import import _set

__all__ = ["keras_h5_to_flax", "keras_h5_to_port"]


def _read_h5_weights(path) -> dict[str, np.ndarray]:
    """save_weights-format HDF5 -> {"layer/weight:0": array}."""
    import h5py

    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = np.asarray(obj)

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        root.visititems(visit)
    return out


_BN_LEAF = {
    "gamma": ("params", "scale"),
    "beta": ("params", "bias"),
    "moving_mean": ("batch_stats", "mean"),
    "moving_variance": ("batch_stats", "var"),
}
_CONV_LEAF = {"kernel": ("params", "kernel"), "bias": ("params", "bias")}


def _resnet50v2_key(name: str):
    """keras dataset path -> (collection, flax path) or None."""
    # dataset paths look like "conv1_conv/conv1_conv/kernel:0"
    parts = name.split("/")
    layer, leaf = parts[0], parts[-1].split(":")[0]
    m = re.fullmatch(r"conv(\d)_block(\d+)_(preact_bn|\d_conv|\d_bn)", layer)
    if m:
        stage, block, rest = m.groups()
        base = f"stage{int(stage) - 1}_block{block}"
        if rest == "preact_bn":
            coll, out_leaf = _BN_LEAF[leaf]
            return coll, (base, "preact_bn", out_leaf)
        idx, kind = rest.split("_")
        if kind == "conv":
            sub = "proj" if idx == "0" else f"conv{idx}"
            coll, out_leaf = _CONV_LEAF[leaf]
            return coll, (base, sub, out_leaf)
        coll, out_leaf = _BN_LEAF[leaf]
        return coll, (base, f"bn{idx}", out_leaf)
    if layer == "conv1_conv":
        coll, out_leaf = _CONV_LEAF[leaf]
        return coll, ("stem", out_leaf)
    if layer == "post_bn":
        coll, out_leaf = _BN_LEAF[leaf]
        return coll, ("post_bn", out_leaf)
    if layer == "predictions":
        coll, out_leaf = _CONV_LEAF[leaf]
        return coll, ("fc", out_leaf)
    return None


def keras_h5_to_flax(
    path, key_fn: Callable = _resnet50v2_key
) -> dict:
    """HDF5 weight file -> {'params': ..., 'batch_stats': ...}."""
    out: dict[str, dict] = {"params": {}, "batch_stats": {}}
    misses = []
    for name, value in _read_h5_weights(path).items():
        spec = key_fn(name)
        if spec is None:
            misses.append(name)
            continue
        coll, flax_path = spec
        _set(out[coll], flax_path, value.astype(np.float32))
    if misses:
        raise KeyError(f"unmapped keras weights: {misses[:10]}")
    return out


def keras_h5_to_port(path, model_name: str = "resnet50v2",
                     key_fn: Callable = _resnet50v2_key, **model_kw) -> dict:
    """HDF5 weight file -> the state dict of the port's ``model_name``
    (``model_kw`` as for ``flax_to_torch``)."""
    from deepvision_tpu_torch.convert.from_flax import flax_to_torch

    return flax_to_torch(model_name, keras_h5_to_flax(path, key_fn),
                         **model_kw)

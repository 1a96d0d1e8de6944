"""Carry the JAX package's weights into the port's modules.

:func:`flax_to_torch` takes flax ``variables`` as nested dicts of numpy
arrays (``{"params": {"conv1": {"kernel": ..., "bias": ...}, ...},
"batch_stats": {...}}``) and returns the ``state_dict`` of the port's
module of the same name:

- a conv kernel ``(KH, KW, I, O)`` becomes ``(O, I, KH, KW)``;
- a Dense kernel ``(in, out)`` is transposed;
- biases and BatchNorm ``scale`` and ``bias`` are copied from
  ``params``, and a module's buffers (BatchNorm ``mean`` and ``var``)
  from ``batch_stats``.

The port's names follow the flax module paths (``conv1.weight`` is
``params/conv1/kernel``, ``i3a.b1.bn.mean`` is
``batch_stats/i3a/b1/bn/mean``), so no name table is needed. A leaf the
port expects and the tree lacks, a leaf the tree has and the port does
not use, or a shape that does not match raises ``ValueError``.

:func:`flax_train_state_to_torch` carries a JAX ``TrainState`` mid
training (params, BN ``batch_stats``, the SGD momentum ``trace`` or
RMSprop's second moment ``nu``, the step, the LR schedule's update
count, the plateau's ``lr_scale`` and the loss scale, as numpy) and
:func:`load_flax_train_state` writes it into the port's train state, so
that a step can start from the same point on both sides.
:func:`rmsprop_parts` finds ``nu`` and the count in an optax
``rmsprop`` state by their field names. A grouped or depthwise kernel
takes the same transpose as any conv kernel: flax's ``(KH, KW, I/g,
O)`` is the port's ``(O, I/g, KH, KW)``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from deepvision_tpu_torch.models import get_model

__all__ = ["flax_to_torch", "flax_param_tree_to_torch",
           "module_state_from_flax",
           "flax_train_state_to_torch", "load_flax_train_state",
           "rmsprop_parts",
           "flax_gan_state_to_torch", "load_flax_gan_state"]

_LEAF = {"weight": "kernel", "bias": "bias"}


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> dict:
    out = {}
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)  # (KH, KW, I, O) -> (O, I, KH, KW)
    if a.ndim == 2:
        return a.T                      # (in, out) -> (out, in)
    return a


def _convert(model_name: str, variables: Mapping[str, Any],
             params_only: bool, model_kw: dict) -> dict[str, torch.Tensor]:
    with torch.device("meta"):
        module = get_model(model_name, **model_kw)
    return _tree_to_state(module, variables, params_only, model_name,
                          torch.float32)


def _tree_to_state(module, variables: Mapping[str, Any], params_only: bool,
                   label: str, dtype=None) -> dict[str, torch.Tensor]:
    """``module``'s state (its parameters alone with ``params_only``) from
    a flax tree, as CPU tensors of ``dtype`` (default: each entry's own
    dtype), checked leaf for leaf against the module's names and
    shapes."""
    buffers = {name for name, _ in module.named_buffers()}
    expected = (dict(module.named_parameters()) if params_only
                else module.state_dict())
    leaves = _flatten(variables)
    out: dict[str, torch.Tensor] = {}
    for name, ref in expected.items():
        *modules, leaf = name.split(".")
        collection = "batch_stats" if name in buffers else "params"
        path = (collection, *modules, _LEAF.get(leaf, leaf))
        if path not in leaves:
            raise ValueError(
                f"{label}: flax variables lack {'/'.join(path)} "
                f"(for {name})")
        a = _to_torch_layout(np.asarray(leaves.pop(path)))
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(
                f"{label}: {'/'.join(path)} has shape {a.shape} after "
                f"the layout change, the port's {name} needs "
                f"{tuple(ref.shape)}")
        out[name] = torch.tensor(a, dtype=dtype or ref.dtype)  # a copy
    if leaves:
        extra = sorted("/".join(p) for p in leaves)
        raise ValueError(
            f"{label}: flax variables carry leaves the port does not "
            f"use: {extra}")
    return out


def module_state_from_flax(module, variables: Mapping[str, Any]
                           ) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of ``module`` itself (any module whose names
    are flax paths, a registry model or not) from flax ``variables``,
    each entry in the module's dtype: the inverse of
    ``resilience/sentinel.state_tree``, which a hot swap's new weights
    come in."""
    return _tree_to_state(module, variables, False,
                          type(module).__name__)


def flax_to_torch(model_name: str, variables: Mapping[str, Any],
                  **model_kw) -> dict[str, torch.Tensor]:
    """The port module's ``state_dict`` (CPU float tensors) from flax
    ``variables`` (``params``, and ``batch_stats`` for a model with
    BatchNorm). ``model_kw`` (``num_classes``, ``input_size``, ...)
    builds the module whose shapes the leaves are checked against."""
    return _convert(model_name, variables, False, model_kw)


def flax_param_tree_to_torch(model_name: str, tree: Mapping[str, Any],
                             **model_kw) -> dict[str, torch.Tensor]:
    """A tree of the flax parameters' structure (an optimizer's moments,
    such as Adam's ``mu`` and ``nu``) as ``{parameter name: tensor}`` in
    the port's layout."""
    return _convert(model_name, {"params": tree}, True, model_kw)


def flax_train_state_to_torch(model_name: str, *, params: Mapping[str, Any],
                              step: int,
                              trace: Mapping[str, Any] | None = None,
                              nu: Mapping[str, Any] | None = None,
                              batch_stats: Mapping[str, Any] | None = None,
                              count: int | None = None,
                              lr_scale: float = 1.0,
                              loss_scale: Mapping[str, Any] | None = None,
                              **model_kw) -> dict:
    """A JAX train state, as numpy, in the port's terms:
    ``{"model": state_dict, "momentum" or "nu": {param name: tensor},
    "step", "count", "lr_scale", "loss_scale"}``. ``params`` is the flax
    parameter tree and one of ``trace`` (optax's SGD momentum trace) and
    ``nu`` (RMSprop's ``ScaleByRmsState.nu``) a tree of the same
    structure, which takes the parameters' layout change;
    ``batch_stats`` the BN statistics (for a model with BN); ``count`` is
    the update count of a step-count LR schedule (optax's
    ``ScaleByScheduleState``; None without one); ``loss_scale`` holds
    ``scale`` and ``good_steps`` (None without scaling)."""
    if (trace is None) == (nu is None):
        raise ValueError("pass one of trace (SGD) and nu (RMSprop)")
    variables = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    slot, tree = ("momentum", trace) if nu is None else ("nu", nu)
    return {
        "model": flax_to_torch(model_name, variables, **model_kw),
        slot: flax_param_tree_to_torch(model_name, tree, **model_kw),
        "step": int(step),
        "count": None if count is None else int(count),
        "lr_scale": float(lr_scale),
        "loss_scale": None if loss_scale is None else {
            k: np.asarray(loss_scale[k]) for k in ("scale", "good_steps")},
    }


@torch.no_grad()
def load_flax_train_state(state, carried: dict) -> None:
    """Write :func:`flax_train_state_to_torch`'s output into the port's
    ``TrainState`` (its module with its BN statistics, SGD momentum
    buffers or RMSprop's ``nu``, step, schedule count, LR scale and loss
    scale), on the state's device."""
    from deepvision_tpu_torch.train.optimizers import (
        set_lr_scale,
        set_update_count,
    )

    state.module.load_state_dict(carried["model"])
    slot = "nu" if "nu" in carried else "momentum"
    key = "nu" if slot == "nu" else "momentum_buffer"
    for name, p in state.module.named_parameters():
        state.optimizer.state[p][key] = (
            torch.empty_like(p).copy_(carried[slot][name]))
    state.step = carried["step"]
    if carried["count"] is not None:
        set_update_count(state.optimizer, carried["count"])
    set_lr_scale(state.optimizer, carried["lr_scale"])
    ls = carried["loss_scale"]
    if (ls is None) != (state.loss_scale is None):
        raise ValueError("the carried state and the port's disagree on "
                         "loss scaling")
    if ls is not None:
        dev = state.loss_scale.scale.device
        state.loss_scale.scale = torch.tensor(float(ls["scale"]),
                                              device=dev)
        state.loss_scale.good_steps = torch.tensor(
            int(ls["good_steps"]), dtype=torch.int32, device=dev)


def _named_parts(opt_state) -> list:
    """The named-tuple states inside an optax state, chains and
    ``inject_hyperparams``' inner state flattened."""
    if hasattr(opt_state, "inner_state"):
        return _named_parts(opt_state.inner_state)
    if hasattr(opt_state, "_fields"):
        return [opt_state]
    if isinstance(opt_state, (tuple, list)):
        return [p for part in opt_state for p in _named_parts(part)]
    return []


def _find_parts(opt_state, main) -> tuple:
    """(the part whose fields satisfy ``main``, the
    ``ScaleByScheduleState`` or None) of an optax state."""
    parts = _named_parts(opt_state)
    fields = [set(p._fields) for p in parts]
    found = next(p for p, f in zip(parts, fields) if main(f))
    sched = next((p for p, f in zip(parts, fields) if f == {"count"}), None)
    return found, sched


def _adam_parts(opt_state) -> tuple:
    """(Adam's ``ScaleByAdamState``, the ``ScaleByScheduleState`` or
    None) of an optax ``adam`` state, found by their named fields."""
    return _find_parts(opt_state, lambda f: "mu" in f)


def rmsprop_parts(opt_state) -> tuple:
    """(RMSprop's ``nu`` tree, the schedule's update count or None) of an
    optax ``rmsprop`` state (its chain with ``add_decayed_weights``
    included), found by their named fields: ``ScaleByRmsState.nu`` and
    ``ScaleByScheduleState.count``."""
    rms, sched = _find_parts(opt_state, lambda f: f == {"nu"})
    return rms.nu, None if sched is None else int(np.asarray(sched.count))


def flax_gan_state_to_torch(nets: Mapping[str, str], roles: Mapping[str, tuple],
                            *, params: Mapping[str, Any],
                            batch_stats: Mapping[str, Any],
                            opt_state: Mapping[str, Any], step: int,
                            pools: Mapping[str, Any] | None = None,
                            loss_scale: Mapping[str, Any] | None = None,
                            model_kw: Mapping[str, dict] | None = None
                            ) -> dict:
    """A JAX ``GANState``, as numpy, in the port's terms. ``nets`` maps
    each net's role name to its registry model (``{"gen_a2b":
    "cyclegan_generator", ...}``), ``roles`` each optimizer to its nets
    (``train/gan.CYCLEGAN_ROLES``), ``model_kw`` a net to its model
    keywords; ``params``, ``batch_stats`` and ``opt_state`` are the
    state's trees by net and by optimizer, ``pools`` its ``extra_vars``.
    -> ``{"modules": {net: state_dict}, "adam": {optimizer:
    {"exp_avg": {net: {param: tensor}}, "exp_avg_sq": ..., "step",
    "count"}}, "pools", "step", "loss_scale"}``."""
    model_kw = model_kw or {}
    modules = {}
    for net, model in nets.items():
        variables = {"params": params[net]}
        if batch_stats.get(net):
            variables["batch_stats"] = batch_stats[net]
        modules[net] = flax_to_torch(model, variables,
                                     **model_kw.get(net, {}))
    adam = {}
    for opt, names in roles.items():
        state, sched = _adam_parts(opt_state[opt])
        moments = {}
        for key, tree in (("exp_avg", state.mu), ("exp_avg_sq", state.nu)):
            by_net = {names[0]: tree} if len(names) == 1 else tree
            moments[key] = {
                net: flax_param_tree_to_torch(nets[net], by_net[net],
                                              **model_kw.get(net, {}))
                for net in names}
        adam[opt] = {**moments, "step": int(np.asarray(state.count)),
                     "count": (None if sched is None
                               else int(np.asarray(sched.count)))}
    return {
        "modules": modules, "adam": adam, "step": int(step),
        "pools": {k: {"images": torch.tensor(np.asarray(v["images"])),
                      "count": torch.tensor(np.asarray(v["count"]),
                                            dtype=torch.int32)}
                  for k, v in (pools or {}).items()},
        "loss_scale": None if loss_scale is None else {
            k: np.asarray(loss_scale[k]) for k in ("scale", "good_steps")},
    }


@torch.no_grad()
def load_flax_gan_state(state, carried: dict) -> None:
    """Write :func:`flax_gan_state_to_torch`'s output into the port's
    ``GANState`` on its device: every net with its BN statistics, both
    Adams' moments and counts (and a scheduled Adam's update count), the
    pools, the step and the loss scale."""
    from deepvision_tpu_torch.train.optimizers import set_update_count

    dev = state.device
    for net, module in state.modules.items():
        module.load_state_dict(carried["modules"][net])
    for opt_name, opt in state.optimizers.items():
        c = carried["adam"][opt_name]
        for net in state.roles[opt_name]:
            for name, p in state.modules[net].named_parameters():
                opt.state[p] = {
                    "step": torch.tensor(float(c["step"]), device=dev),
                    "exp_avg": torch.empty_like(p).copy_(
                        c["exp_avg"][net][name]),
                    "exp_avg_sq": torch.empty_like(p).copy_(
                        c["exp_avg_sq"][net][name])}
        if c["count"] is not None:
            set_update_count(opt, c["count"])
    state.pools = {k: {leaf: t.to(dev) for leaf, t in v.items()}
                   for k, v in carried["pools"].items()}
    state.step = carried["step"]
    ls = carried["loss_scale"]
    if (ls is None) != (state.loss_scale is None):
        raise ValueError("the carried state and the port's disagree on "
                         "loss scaling")
    if ls is not None:
        state.loss_scale.scale = torch.tensor(float(ls["scale"]), device=dev)
        state.loss_scale.good_steps = torch.tensor(
            int(ls["good_steps"]), dtype=torch.int32, device=dev)

"""Model registry: name -> ``nn.Module`` factory.

The twin of ``deepvision_tpu/models/registry.py``, with the same
``register`` / ``get_model`` / ``model_remat`` names. Factories take
keyword arguments (``num_classes``, ``input_size``, ...) and return an
``nn.Module``. A registration may declare the model's rematerialization
policy (``resnet152``: ``"block"``); the registry only declares it, and
the training config folds it into ``model_kwargs``
(``train/configs.get_config``), so that serving builds the model
without it.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from deepvision_tpu_torch.models.layers import init_weights

__all__ = ["register", "get_model", "model_remat", "create_model"]

_REGISTRY: dict[str, Callable] = {}
_REMAT: dict[str, str] = {}


def register(name: str, *, remat: str | None = None):
    """Register a model factory under ``name``; ``remat`` declares the
    model's default rematerialization policy (a value its module takes
    as ``remat``)."""

    def deco(factory):
        if name in _REGISTRY:
            raise ValueError(f"duplicate model name {name!r}")
        _REGISTRY[name] = factory
        if remat is not None:
            _REMAT[name] = remat
        return factory

    return deco


def model_remat(name: str) -> str | None:
    """The remat policy the registry declares for ``name`` (None for
    none, or for an unknown name)."""
    return _REMAT.get(name)


def get_model(name: str, **kwargs):
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(_REGISTRY)}") from None
    return factory(**kwargs)


def create_model(name: str, *, device: torch.device, seed: int = 0,
                 **kwargs) -> nn.Module:
    """Registry model ``name`` built straight on ``device``, with fresh
    weights by the model's own init from a ``torch.Generator`` seeded
    with ``seed``, in ``channels_last`` memory (cuDNN then reads and
    writes the NHWC activations the models keep without a transpose)."""
    with torch.device("meta"):
        module = get_model(name, **kwargs)
    module = module.to_empty(device=device)
    init_weights(module, torch.Generator(device=device).manual_seed(seed))
    return module.to(memory_format=torch.channels_last)

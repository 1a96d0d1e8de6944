"""Model registry: name -> ``nn.Module`` factory.

The twin of ``deepvision_tpu/models/registry.py``, with the same
``register`` / ``get_model`` names. Factories take keyword arguments
(``num_classes``, ``input_size``, ...) and return an ``nn.Module``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from deepvision_tpu_torch.models.layers import init_weights

__all__ = ["register", "get_model", "create_model"]

_REGISTRY: dict[str, Callable] = {}


def register(name: str):
    """Register a model factory under ``name``."""

    def deco(factory):
        if name in _REGISTRY:
            raise ValueError(f"duplicate model name {name!r}")
        _REGISTRY[name] = factory
        return factory

    return deco


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

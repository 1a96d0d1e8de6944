"""Model registry: name -> ``nn.Module`` factory.

The twin of ``deepvision_tpu/models/registry.py``, with the same
``register`` / ``get_model`` names. Factories take keyword arguments
(``num_classes``, ``input_size``, ...) and return an ``nn.Module``.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["register", "get_model"]

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

"""Model registry: name -> ``nn.Module`` factory (the JAX package's
``models/registry.py``; every family but Llama is ported)."""

from __future__ import annotations

import importlib
from typing import Callable, Dict

from torch import nn

MODELS: Dict[str, Callable[..., nn.Module]] = {}

_FAMILY_MODULES = ("mlmodel", "resnet", "vit", "bert", "gpt2")


def register_model(name: str):
    def deco(factory):
        MODELS[name] = factory
        return factory

    return deco


def _load_families() -> None:
    for mod in _FAMILY_MODULES:
        importlib.import_module(f"ml_trainer_tpu_torch.models.{mod}")


def get_model(name: str, **kwargs) -> nn.Module:
    """Build a registered model; ``device=`` defaults to the CUDA card."""
    _load_families()
    try:
        factory = MODELS[name]
    except KeyError:
        raise ValueError(
            f"Unknown model {name!r}; expected one of {sorted(MODELS)}"
        ) from None
    return factory(**kwargs)


def available_models():
    _load_families()
    return sorted(MODELS)

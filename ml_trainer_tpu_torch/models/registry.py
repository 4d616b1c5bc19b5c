"""Model registry: name -> ``nn.Module`` factory (the JAX package's
``models/registry.py``; every family is ported, the MoE and pipeline
GPT-2 variants not yet)."""

from __future__ import annotations

import importlib
from typing import Callable, Dict

from torch import nn

MODELS: Dict[str, Callable[..., nn.Module]] = {}

_FAMILY_MODULES = ("mlmodel", "resnet", "vit", "bert", "gpt2", "llama")


def register_model(name: str):
    def deco(factory):
        MODELS[name] = factory
        return factory

    return deco


def _load_families() -> None:
    for mod in _FAMILY_MODULES:
        importlib.import_module(f"ml_trainer_tpu_torch.models.{mod}")


def get_model(name: str, **kwargs) -> nn.Module:
    """Build a registered model; ``device=`` defaults to the CUDA card.

    ``precision=`` (a policy name like ``'bf16'`` or a
    ``precision.Precision``) maps an active policy's compute dtype onto
    the family's ``dtype`` knob (activations in ``dtype``, parameters
    fp32); a family without that knob (MLModel) drops it and relies on
    the Trainer's cast.  The model remembers its registry name and
    arguments (``registry_config``), so the Trainer can rebuild it at
    another compute dtype."""
    _load_families()
    precision = kwargs.pop("precision", None)
    threaded = False
    if precision is not None and "dtype" not in kwargs:
        from ml_trainer_tpu_torch.precision import resolve_precision

        policy = resolve_precision(precision)
        if policy.active:
            kwargs["dtype"] = policy.compute
            threaded = True
    try:
        factory = MODELS[name]
    except KeyError:
        raise ValueError(
            f"Unknown model {name!r}; expected one of {sorted(MODELS)}"
        ) from None
    try:
        model = factory(**kwargs)
    except TypeError:
        if not threaded:
            raise
        # Family without a dtype knob: drop the threaded compute dtype
        # (the Trainer-level cast covers these models).
        kwargs.pop("dtype")
        model = factory(**kwargs)
    model.registry_config = (name, dict(kwargs))
    return model


def available_models():
    _load_families()
    return sorted(MODELS)

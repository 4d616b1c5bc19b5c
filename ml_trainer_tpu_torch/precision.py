"""Mixed-precision policy: bf16 compute against fp32 master params (the
JAX package's ``precision.py``, in torch dtypes).

A policy is three dtypes:

* ``compute``: forward and backward activations and matmuls (bf16);
* ``params``: the master copy the optimizer updates (fp32, the model's
  own parameters; cast to ``compute`` once per step at the top of the
  loss function, so gradients come back fp32 through the cast's
  backward);
* ``output``: logits and loss as the criterion and metrics read them
  (fp32).

``LossScaleConfig`` is the standard dynamic scheme: scale the loss up,
unscale the gradients, halve on overflow WITHOUT advancing the rollback
streak, grow back after ``growth_interval`` healthy steps.
``Trainer(precision="bf16")`` turns it on; ``Trainer(precision="bf16",
loss_scale=None)`` keeps bare bf16.

Threading: ``models/registry.get_model(name, precision=...)`` maps the
policy's compute dtype onto a family's ``dtype`` knob;
``train_state.TrainState`` carries ``loss_scale`` / ``good_steps`` as
device scalars; ``trainer.py`` casts params and floating inputs to
``compute`` inside the loss function, the output back to fp32 before the
criterion, and folds the scale arithmetic into the non-finite guard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

# Dynamic loss-scaling defaults (the JAX package's constants).
DEFAULT_INIT_SCALE = 2.0 ** 15
MIN_SCALE = 1.0
MAX_SCALE = 2.0 ** 24
GROWTH_FACTOR = 2.0
BACKOFF_FACTOR = 0.5
GROWTH_INTERVAL = 2000  # consecutive finite steps before the scale doubles


def _name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


@dataclasses.dataclass(frozen=True)
class Precision:
    """The (compute, params, output) dtype triple of one training run."""

    compute: Any = torch.float32
    params: Any = torch.float32
    output: Any = torch.float32

    @property
    def active(self) -> bool:
        """True when compute differs from the fp32 master dtype: the only
        case the trainer's cast machinery engages (fp32 stays the exact
        pre-policy program, bit-identical)."""
        return self.compute != self.params

    def label(self) -> str:
        return _name(self.compute)


# Named policies: the strings Trainer(precision=...) and
# get_model(precision=...) accept.
POLICIES = {
    "fp32": Precision(),
    "float32": Precision(),
    "bf16": Precision(compute=torch.bfloat16),
    "bfloat16": Precision(compute=torch.bfloat16),
    "mixed_bf16": Precision(compute=torch.bfloat16),
}


def resolve_precision(policy: Union[str, Precision, None]) -> Precision:
    """A policy name / Precision / None as a Precision.  fp32 params are
    a hard invariant (the master copy is the model's parameters), so
    only compute/output vary."""
    if policy is None:
        return POLICIES["fp32"]
    if isinstance(policy, Precision):
        if policy.params != torch.float32:
            raise ValueError(
                "Precision.params must be float32 (the TrainState master "
                f"copy); got {_name(policy.params)}"
            )
        return policy
    try:
        return POLICIES[str(policy).lower()]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {policy!r}; expected one of "
            f"{sorted(set(POLICIES))} or a Precision instance"
        ) from None


@dataclasses.dataclass(frozen=True)
class LossScaleConfig:
    """Dynamic loss-scaling knobs."""

    init_scale: float = DEFAULT_INIT_SCALE
    growth_factor: float = GROWTH_FACTOR
    backoff_factor: float = BACKOFF_FACTOR
    growth_interval: int = GROWTH_INTERVAL
    min_scale: float = MIN_SCALE
    max_scale: float = MAX_SCALE


def resolve_loss_scale(
    loss_scale: Union[str, float, LossScaleConfig, None],
    precision: Precision,
) -> Optional[LossScaleConfig]:
    """Normalize the Trainer's ``loss_scale`` knob.

    ``'dynamic'`` (the default) -> the standard dynamic config; a float ->
    a STATIC scale (growth/backoff disabled by pinning min == max ==
    init); ``None`` -> no scaling.  An inactive (fp32) policy always
    resolves to None: the scale arithmetic must not enter the fp32
    program."""
    if not precision.active or loss_scale is None:
        return None
    if isinstance(loss_scale, LossScaleConfig):
        return loss_scale
    if isinstance(loss_scale, str):
        if loss_scale.lower() != "dynamic":
            raise ValueError(
                f"loss_scale must be 'dynamic', a positive number, a "
                f"LossScaleConfig, or None; got {loss_scale!r}"
            )
        return LossScaleConfig()
    scale = float(loss_scale)
    if scale <= 0:
        raise ValueError(f"loss_scale must be positive, got {scale}")
    return LossScaleConfig(
        init_scale=scale, min_scale=scale, max_scale=scale,
        growth_factor=1.0, backoff_factor=1.0,
    )


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def cast_floating(tree, dtype: torch.dtype):
    """Cast every floating tensor of ``tree`` (a tensor, or dicts, lists
    and tuples of them) to ``dtype``; integer leaves (token ids, masks)
    pass through untouched."""
    def cast(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            return leaf.to(dtype)
        return leaf

    return _map(tree, cast)


def cast_like(tree, ref):
    """Cast each tensor of ``tree`` back to the dtype of the matching
    tensor of ``ref`` (same structure): state leaves mutated in bf16 come
    home at their own dtype."""
    if isinstance(tree, dict):
        return {k: cast_like(v, ref[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_like(v, r) for v, r in zip(tree, ref))
    if isinstance(tree, torch.Tensor) and isinstance(ref, torch.Tensor):
        return tree.to(ref.dtype)
    return tree

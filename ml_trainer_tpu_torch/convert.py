"""Weights for the port's GPT-2: converted from the JAX package's flax
params, or drawn from a seed.

``params_from_jax`` takes the flax param tree of the JAX package's
``GPT2`` as a nested dict of numpy arrays (no JAX needed to call it)
and returns a ``state_dict`` for the port's ``GPT2``:

* Dense ``kernel`` [in, out] -> ``nn.Linear.weight`` [out, in];
* LayerNorm ``scale`` -> ``weight``;
* ``tok_embed.embedding`` -> ``tok_embed.weight`` (the tied head reads
  it too), ``pos_embed`` as it is;
* ``block{i}`` -> ``blocks.{i}``.

``adam_state_from_jax`` carries the JAX trainer's optax Adam state
(count, moments, schedule count) into the port's optimizer state, the
moments through the same layout rules.

``quant_from_jax`` takes the JAX package's int8 "quant" collection
(``ops/kernels/int8_matmul.quantize_tree``: ``block{i}/attn/{qkv,proj}_*``,
``block{i}/mlp/{fc_in,fc_out}_*``) as numpy and returns the port's, with
the same [K, N] int8 layout: ``{"blocks": {"{i}": {"attn": ..., "mlp":
...}}}``.

``init_gpt2`` builds a registered GPT-2 with weights drawn from a seeded
CPU ``torch.Generator`` (the same numbers on every device): normal(0.02)
for the projections and the token embedding, normal(0.01) for the
positions (the reference's initializer), zero biases, unit LayerNorm
scales.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ml_trainer_tpu_torch.models.registry import get_model


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def _linear(prefix: str, tree: Mapping, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _f32(tree["kernel"]).T.contiguous()
    out[f"{prefix}.bias"] = _f32(tree["bias"])


def _layernorm(prefix: str, tree: Mapping,
               out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _f32(tree["scale"])
    out[f"{prefix}.bias"] = _f32(tree["bias"])


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax GPT2 params (nested dict of numpy arrays; a ``{"params": ...}``
    wrapper is accepted) -> the port's GPT2 ``state_dict`` (CPU tensors)."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    out["tok_embed.weight"] = _f32(params["tok_embed"]["embedding"])
    out["pos_embed"] = _f32(params["pos_embed"])
    depth = sum(1 for k in params if k.startswith("block"))
    for i in range(depth):
        blk = params[f"block{i}"]
        pre = f"blocks.{i}"
        _layernorm(f"{pre}.ln1", blk["ln1"], out)
        _layernorm(f"{pre}.ln2", blk["ln2"], out)
        _linear(f"{pre}.attn.qkv", blk["attn"]["qkv"], out)
        _linear(f"{pre}.attn.proj", blk["attn"]["proj"], out)
        _linear(f"{pre}.mlp.fc_in", blk["mlp"]["fc_in"], out)
        _linear(f"{pre}.mlp.fc_out", blk["mlp"]["fc_out"], out)
    _layernorm("ln_final", params["ln_final"], out)
    return out


def _opt_part(state, device):
    """One optax state (a NamedTuple) of a chain -> the port's dict."""
    fields = tuple(state._fields)

    def count(c) -> torch.Tensor:
        return torch.tensor(np.asarray(c, np.int32)).to(device)

    def moments(tree) -> Dict[str, torch.Tensor]:
        return {k: v.to(device) for k, v in params_from_jax(tree).items()}

    if not fields:  # EmptyState: identity, clip, add_decayed_weights
        return {}
    if {"count", "mu", "nu"} <= set(fields):  # ScaleByAdamState
        return {"count": count(state.count), "mu": moments(state.mu),
                "nu": moments(state.nu)}
    if fields == ("count",):  # ScaleByScheduleState
        return {"count": count(state.count)}
    raise ValueError(f"no port counterpart for optimizer state fields "
                     f"{fields}")


def _is_chain(state) -> bool:
    return isinstance(state, tuple) and not hasattr(state, "_fields")


def adam_state_from_jax(opt_state, device=None):
    """The JAX trainer's optax state of a GPT-2 (``chain(clip|identity,
    adam(schedule))``, or adamw's ``(adam, add_decayed_weights,
    schedule)`` inner chain) as numpy -> the port's optimizer state:
    ``ScaleByAdamState`` to ``{"count", "mu", "nu"}`` with the moments
    laid out as ``params_from_jax`` lays out the params (Dense kernels
    transposed), ``ScaleByScheduleState`` to ``{"count"}``, empty states
    to ``{}``, each chain a tuple; tensors on ``device`` (the CPU by
    default)."""
    def convert(state):
        if _is_chain(state):
            return tuple(convert(s) for s in state)
        return _opt_part(state, device)

    return convert(opt_state)


def quant_from_jax(quant: Mapping, device=None) -> dict:
    """The JAX "quant" collection (nested dict of numpy arrays; a
    ``{"quant": ...}`` wrapper is accepted) -> the port's (tensors on
    ``device``, the CPU by default)."""
    if "quant" in quant:
        quant = quant["quant"]

    def leaf(name: str, x) -> torch.Tensor:
        dtype = np.int8 if name.endswith("_w") else np.float32
        return torch.from_numpy(np.array(x, dtype)).to(device)

    def walk(tree: Mapping) -> dict:
        return {k: walk(v) if isinstance(v, Mapping) else leaf(k, v)
                for k, v in tree.items()}

    depth = sum(1 for k in quant if k.startswith("block"))
    return {"blocks": {str(i): walk(quant[f"block{i}"])
                       for i in range(depth)}}


@torch.no_grad()
def init_gpt2(config="gpt2", seed: int = 0, device=None, **kwargs):
    """A registered GPT-2 (``config``: registry name, or a dict with
    ``name`` plus constructor kwargs) with weights drawn from
    ``torch.Generator().manual_seed(seed)``."""
    if isinstance(config, Mapping):
        kwargs = {**{k: v for k, v in config.items() if k != "name"},
                  **kwargs}
        config = config.get("name", "gpt2")
    model = get_model(config, device=device, **kwargs)
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            vals = torch.zeros(p.shape)
        elif ".ln" in name or name.startswith("ln_"):
            vals = torch.ones(p.shape)
        else:
            std = 0.01 if name == "pos_embed" else 0.02
            vals = torch.randn(p.shape, generator=gen) * std
        p.copy_(vals)
    return model

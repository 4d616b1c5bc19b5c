"""Weights for the port's models: converted from the JAX package's flax
variables, or drawn from a seed.

``params_from_jax`` takes the flax variables of any ported family (the
``{"params": ..., "batch_stats": ...}`` tree, or bare params) as nested
dicts of numpy arrays (no JAX needed to call it) and returns the port's
``state_dict``, buffers included.  The layout rules are those of the JAX
package's ``checkpoint/torch_export.py``, copied:

* Dense ``kernel`` [in, out] -> ``weight`` [out, in];
* Conv ``kernel`` HWIO -> ``weight`` OIHW;
* ``embedding`` -> ``weight``; LayerNorm/RMSNorm/BatchNorm ``scale`` ->
  ``weight``;
* ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``;
* ``block{i}`` -> ``blocks.{i}``, ``layer{i}`` -> ``layers.{i}``; every
  other module keeps its flax name (``stage1_block1``, ``tok_embed``),
  and bare params (``pos_embed``, ``cls_token``, Llama's [E, V]
  ``lm_head``) keep their names and layouts.

MLModel's ``fc1`` needs no permutation: the port flattens in H, W, C
order, as the JAX package does.

``adam_state_from_jax`` carries the JAX trainer's optax state (counts,
moments, schedule count; any of the five optimizers) into the port's
optimizer state, the moments through the same layout rules, and
``state_from_jax`` a whole JAX ``TrainState`` into the port's state tree
(what a port checkpoint holds).

``quant_from_jax`` takes the JAX package's int8 "quant" collection
(``ops/kernels/int8_matmul.quantize_tree``: ``block{i}/attn/{qkv,proj}_*``,
``block{i}/mlp/{fc_in,fc_out}_*``) as numpy and returns the port's, with
the same [K, N] int8 layout: ``{"blocks": {"{i}": {"attn": ..., "mlp":
...}}}``.

``variables_to_jax`` is the inverse of ``params_from_jax``: the port's
model (or other tensors by its parameters' names, such as the EMA's) as
flax variables of numpy arrays, the flax layouts and names restored
(``blocks.{i}`` -> ``block{i}``; ``weight`` -> ``kernel`` transposed,
``embedding`` or ``scale`` by its module's kind).  The LoRA fingerprint
and ``export_torch`` read it.

``init_model`` builds a registered model with weights drawn from a seeded
CPU ``torch.Generator`` (the same numbers on every device).  The GPT-2
family (``init_gpt2``) draws normal(0.02) for the projections and the
token embedding, normal(0.01) for the positions, zero biases and unit
LayerNorm scales.  Every other family draws flax's defaults, as its JAX
module does: lecun normal (truncated at two deviations) for Dense and
Conv kernels, normal(1/sqrt(features)) for embeddings, zero biases, unit
norm scales (LayerNorm, RMSNorm, BatchNorm), BatchNorm statistics 0 and
1; ViT's ``cls_token`` is zero, its ``pos_embed`` normal(0.02), and
Llama's untied ``lm_head`` normal(0.02).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ml_trainer_tpu_torch.models.gpt2 import GPT2
from ml_trainer_tpu_torch.models.layers import BatchNorm, Conv, RMSNorm
from ml_trainer_tpu_torch.models.registry import get_model
from ml_trainer_tpu_torch.train_state import as_tree

# flax module lists: ``block{i}`` / ``layer{i}`` -> ``blocks.{i}`` /
# ``layers.{i}``.
_LIST_MODULE = re.compile(r"^(block|layer)(\d+)$")


def _module_name(key: str) -> str:
    m = _LIST_MODULE.match(key)
    return f"{m[1]}s.{m[2]}" if m else key


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _leaf(prefix: str, name: str, value, out: Dict[str, torch.Tensor]):
    arr = np.asarray(value, np.float32)
    if name == "kernel":
        if arr.ndim == 2:  # Dense [in, out] -> [out, in]
            arr = arr.T
        elif arr.ndim == 4:  # Conv HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(
                f"{prefix}/kernel has rank {arr.ndim}; only Dense (2-D) and "
                "Conv (4-D HWIO) kernels have a torch layout")
        name = "weight"
    else:
        name = {"scale": "weight", "embedding": "weight",
                "mean": "running_mean", "var": "running_var"}.get(name, name)
    out[_join(prefix, name)] = torch.tensor(np.ascontiguousarray(arr))


def _walk(tree: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, _join(prefix, _module_name(key)), out)
        else:
            _leaf(prefix, key, value, out)


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables (``{"params": ..., "batch_stats": ...}`` or bare
    params; nested dicts of numpy arrays) -> the port's ``state_dict``
    (CPU tensors).  ``model.load_state_dict`` refuses a key or shape
    that is not the model's own, such as the ``pos_embed`` of a ViT
    built for another ``image_size``."""
    out: Dict[str, torch.Tensor] = {}
    if "params" in variables:
        _walk(variables["params"], "", out)
        _walk(variables.get("batch_stats") or {}, "", out)
    else:
        _walk(variables, "", out)
    return out


_FLAX_LIST = re.compile(r"^(block|layer)s\.(\d+)$")


def flax_path(module_name: str) -> list:
    """``blocks.0.attn.qkv`` -> ``["block0", "attn", "qkv"]``."""
    parts = module_name.split(".") if module_name else []
    out: list = []
    for part in parts:
        if out and part.isdigit() and _FLAX_LIST.match(f"{out[-1]}.{part}"):
            out[-1] = f"{out[-1][:-1]}{part}"
        else:
            out.append(part)
    return out


def _put(tree: dict, path: list, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def variables_to_jax(model: nn.Module,
                     params: Mapping[str, torch.Tensor] = None) -> dict:
    """``{"params": ..., "batch_stats": ...}`` of numpy arrays in flax's
    names and layouts from ``model`` (``params``: tensors by parameter
    name in place of the model's own).  Non-persistent buffers (the
    serving stacks) are left out."""
    modules = dict(model.named_modules())
    out = {"params": {}, "batch_stats": {}}
    for name, p in model.named_parameters():
        t = (p if params is None else params[name]).detach()
        arr = t.cpu().numpy()
        prefix, _, leaf = name.rpartition(".")
        mod = modules[prefix]
        if leaf == "weight":
            if isinstance(mod, (nn.Linear, Conv)):
                arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
                leaf = "kernel"
            elif isinstance(mod, nn.Embedding):
                leaf = "embedding"
            else:  # LayerNorm, RMSNorm, BatchNorm
                leaf = "scale"
        _put(out["params"], flax_path(prefix) + [leaf],
             np.ascontiguousarray(arr))
    persistent = set(model.state_dict())
    for name, b in model.named_buffers():
        if name not in persistent:
            continue
        prefix, _, leaf = name.rpartition(".")
        leaf = {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
        _put(out["batch_stats"], flax_path(prefix) + [leaf],
             np.ascontiguousarray(b.detach().cpu().numpy()))
    return _sorted(out)


def _sorted(tree):
    """Keys sorted at every level, the order of a tree that went through
    ``jax.tree`` (the JAX package's host copies)."""
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def _unmasked(tree):
    """A moments tree without optax's ``MaskedNode`` leaves (the leaves
    a masked transform keeps no state for) and the dicts they emptied."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            v = _unmasked(v)
            if v:
                out[k] = v
        elif type(v).__name__ != "MaskedNode":
            out[k] = v
    return out


def _opt_part(state, device):
    """One optax state (a NamedTuple) of a chain -> the port's dict."""
    fields = tuple(state._fields)

    def count(c) -> torch.Tensor:
        return torch.tensor(np.asarray(c, np.int32)).to(device)

    def moments(tree) -> Dict[str, torch.Tensor]:
        return {k: v.to(device)
                for k, v in params_from_jax(_unmasked(tree)).items()}

    if not fields:  # EmptyState: identity, clip, constant learning rate
        return {}
    if fields == ("inner_state",):
        # MaskedState (add_decayed_weights' mask, a multi_transform
        # branch): the port keeps no wrapper.
        return _opt_state(state.inner_state, device)
    if fields == ("inner_states",):  # multi_transform (PartitionState)
        return {"inner_states": {
            label: _opt_state(inner, device)
            for label, inner in sorted(state.inner_states.items())}}
    if {"count", "mu", "nu"} <= set(fields):  # scale_by_adam / _adamax
        return {"count": count(state.count), "mu": moments(state.mu),
                "nu": moments(state.nu)}
    if fields == ("count",):  # ScaleByScheduleState
        return {"count": count(state.count)}
    if fields in (("trace",), ("sum_of_squares",)):  # momentum, adagrad
        return {fields[0]: moments(getattr(state, fields[0]))}
    raise ValueError(f"no port counterpart for optimizer state fields "
                     f"{fields}")


def _is_chain(state) -> bool:
    return isinstance(state, tuple) and not hasattr(state, "_fields")


def _opt_state(state, device):
    if _is_chain(state):
        return tuple(_opt_state(s, device) for s in state)
    return _opt_part(state, device)


def adam_state_from_jax(opt_state, device=None):
    """The JAX trainer's optax state (its ``chain(clip|identity, inner)``
    of any of the five optimizers) as numpy -> the port's optimizer
    state: ``ScaleByAdamState`` (adam, adamw, adamax) to ``{"count",
    "mu", "nu"}``, ``TraceState`` to ``{"trace"}``, ``ScaleByRssState``
    to ``{"sum_of_squares"}``, each tree of moments laid out as
    ``params_from_jax`` lays out the params (Dense kernels transposed),
    ``ScaleByScheduleState`` to ``{"count"}``, empty and masked-empty
    states to ``{}``, each chain a tuple, and LoRA's ``multi_transform``
    state to ``{"inner_states": {label: ...}}`` (the masked moments hold
    the adapters' leaves only); tensors on ``device`` (the CPU by
    default)."""
    return _opt_state(opt_state, device)


def state_from_jax(jax_state) -> dict:
    """A JAX ``TrainState`` whose leaves are numpy arrays (``params``,
    ``batch_stats``, ``opt_state``, ``step``, the guard's counters and
    the loss scale's, ``ema_params``) -> the port's state tree
    (``train_state.state_tree``'s layout, CPU tensors), ready for
    ``checkpoint.save_checkpoint`` or ``train_state.load_state_tree``;
    ``ema_params`` laid out as the params (None stays None).  The JAX
    ``rng`` has no counterpart."""
    def tensor(x):
        return None if x is None else torch.from_numpy(np.array(x))

    tree = {
        "params": params_from_jax({"params": jax_state.params}),
        "batch_stats": (params_from_jax(jax_state.batch_stats)
                        if jax_state.batch_stats else {}),
        "opt_state": as_tree(adam_state_from_jax(jax_state.opt_state)),
        "step": np.asarray(jax_state.step, np.int32),
        "ema_params": (None if getattr(jax_state, "ema_params", None) is None
                       else params_from_jax({"params":
                                             jax_state.ema_params})),
    }
    for key in ("skipped_steps", "bad_streak", "loss_scale", "good_steps"):
        tree[key] = tensor(getattr(jax_state, key, None))
    return tree


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


def _draw_gpt2(model: GPT2, gen: torch.Generator) -> None:
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            vals = torch.zeros(p.shape)
        elif ".ln" in name or name.startswith("ln_"):
            vals = torch.ones(p.shape)
        else:
            std = 0.01 if name == "pos_embed" else 0.02
            vals = torch.randn(p.shape, generator=gen) * std
        p.copy_(vals)


# Bare parameters of the flax families and their normal init's deviation
# (0: zeros): ViT's class token and positions, Llama's untied head.
_BARE_STD = {"cls_token": 0.0, "pos_embed": 0.02, "lm_head": 0.02}


def _draw_flax_defaults(model: nn.Module, gen: torch.Generator) -> None:
    for mod in model.modules():
        own = dict(mod.named_parameters(recurse=False))
        if isinstance(mod, (nn.Linear, Conv)):
            w = mod.weight
            # flax's lecun_normal: truncated at +-2, rescaled to unit
            # variance; fan_in = in (* kh * kw).
            std = math.sqrt(1.0 / w[0].numel()) / .87962566103423978
            w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), 0.0, std,
                                          -2 * std, 2 * std, generator=gen))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            w = mod.weight
            w.copy_(torch.randn(w.shape, generator=gen)
                    * math.sqrt(1.0 / w.shape[1]))
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)
        elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        else:
            for name, p in own.items():
                if name not in _BARE_STD:
                    raise ValueError(
                        f"no flax initializer known for {name!r} of "
                        f"{type(mod).__name__}")
                std = _BARE_STD[name]
                p.copy_(torch.randn(p.shape, generator=gen) * std if std
                        else torch.zeros(p.shape))


@torch.no_grad()
def init_model(config="gpt2", seed: int = 0, device=None, **kwargs):
    """A registered model (``config``: registry name, or a dict with
    ``name`` plus constructor kwargs) with weights drawn from
    ``torch.Generator().manual_seed(seed)``: GPT-2's draws for the GPT-2
    family, flax's default initializers for the others."""
    if isinstance(config, Mapping):
        kwargs = {**{k: v for k, v in config.items() if k != "name"},
                  **kwargs}
        config = config.get("name", "gpt2")
    model = get_model(config, device=device, **kwargs)
    gen = torch.Generator().manual_seed(int(seed))
    if isinstance(model, GPT2):
        _draw_gpt2(model, gen)
    else:
        _draw_flax_defaults(model, gen)
    return model


def init_gpt2(config="gpt2", seed: int = 0, device=None, **kwargs):
    """``init_model`` for the GPT-2 family (its former name)."""
    return init_model(config, seed=seed, device=device, **kwargs)

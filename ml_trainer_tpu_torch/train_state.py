"""TrainState: what a training run carries besides the model's
parameters (the JAX package's ``train_state.py``).

The parameters live in the ``nn.Module``; this holds the rest.  ``step``
is a host int that always advances (a skipped step still consumed its
batch); ``opt_state`` is the optimizer's functional state, counts
included; ``skipped_steps`` and ``bad_streak`` are int32 tensors on the
device, maintained by the non-finite guard without a host sync and read
once per epoch.  With loss scaling (``precision.py``), ``loss_scale``
(float32) and ``good_steps`` (int32, the finite steps since the scale
last moved) are device scalars too; None whenever scaling is off, so an
fp32 run's state is the pre-policy one.  With ``ema_decay``,
``ema_params`` holds the float32 moving average of the parameters, by
their module names; None otherwise.

``state_tree`` gives the whole state, the model's parameters and buffers
included, as one tree with the JAX package's ``TrainState`` names (what
a checkpoint holds), and ``load_state_tree`` writes a restored tree back
into the tensors that hold the state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass
class TrainState:
    step: int
    opt_state: Any
    skipped_steps: torch.Tensor
    bad_streak: torch.Tensor
    loss_scale: Optional[torch.Tensor] = None
    good_steps: Optional[torch.Tensor] = None
    ema_params: Optional[dict] = None

    @classmethod
    def create(cls, opt_state, device,
               init_scale: Optional[float] = None) -> "TrainState":
        """``init_scale``: the loss scale to start from, or None for no
        scaling."""
        zero = torch.zeros((), dtype=torch.int32, device=device)
        state = cls(step=0, opt_state=opt_state, skipped_steps=zero,
                    bad_streak=zero.clone())
        if init_scale is not None:
            state.loss_scale = torch.full((), float(init_scale),
                                          dtype=torch.float32, device=device)
            state.good_steps = zero.clone()
        return state


# The top-level names of the state as one tree: the JAX package's
# ``TrainState`` fields that have a counterpart here (its ``rng`` has
# none).
_COUNTERS = ("skipped_steps", "bad_streak", "loss_scale", "good_steps")
TREE_KEYS = ("params", "batch_stats", "opt_state", "step", *_COUNTERS,
             "ema_params")


def as_tree(opt_state):
    """An optimizer state with its tuples as ``{"0": ..., "1": ...}``
    levels, as flax's ``to_state_dict`` writes a tuple."""
    if isinstance(opt_state, (tuple, list)):
        return {str(i): as_tree(v) for i, v in enumerate(opt_state)}
    if isinstance(opt_state, dict):
        return {k: as_tree(v) for k, v in opt_state.items()}
    return opt_state


def state_tree(state: TrainState, model: torch.nn.Module) -> dict:
    """The whole training state as nested dicts of the tensors that hold
    it now: ``params`` and ``batch_stats`` are the model's parameters and
    buffers by their module names, ``opt_state`` the optimizer's state,
    then ``step``, the guard's counters, the loss scale's (None when
    scaling is off) and ``ema_params`` (by the parameters' names; None
    without an EMA)."""
    tree = {
        "params": {k: p.detach() for k, p in model.named_parameters()},
        "batch_stats": dict(model.named_buffers()),
        "opt_state": as_tree(state.opt_state),
        "step": np.asarray(state.step, np.int32),
        "ema_params": (None if state.ema_params is None
                       else dict(state.ema_params)),
    }
    tree.update({key: getattr(state, key) for key in _COUNTERS})
    return tree


def _match(path, live, saved, plan: list) -> None:
    """Pair every tensor of ``live`` with its array in ``saved`` into
    ``plan``, checking keys, shapes and dtypes; the first path that
    differs is named in the error."""
    where = "/".join(path)
    if isinstance(live, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"checkpoint does not fit the state at {where}: "
                             f"a leaf where the state has {sorted(live)}")
        odd = sorted(set(live) ^ set(saved))
        if odd:
            side = "state" if odd[0] in live else "checkpoint"
            raise ValueError(
                f"checkpoint does not fit the state at "
                f"{'/'.join(path + (odd[0],))}: only the {side} has it")
        for key in sorted(live):
            _match(path + (key,), live[key], saved[key], plan)
        return
    if saved is None or isinstance(saved, dict):
        raise ValueError(f"checkpoint does not fit the state at {where}: "
                         "no array where the state has a tensor")
    arr = np.asarray(saved)
    if tuple(arr.shape) != tuple(live.shape):
        raise ValueError(f"checkpoint does not fit the state at {where}: "
                         f"shape {arr.shape} vs {tuple(live.shape)}")
    src = torch.from_numpy(np.asarray(arr, order="C"))
    if src.dtype != live.dtype:
        raise ValueError(f"checkpoint does not fit the state at {where}: "
                         f"dtype {src.dtype} vs {live.dtype}")
    plan.append((live, src))


@torch.no_grad()
def load_state_tree(state: TrainState, model: torch.nn.Module,
                    tree: dict) -> None:
    """Write a restored ``tree`` (``state_tree``'s layout, numpy leaves)
    into the tensors that hold the state now (``copy_``): a CUDA graph
    captured over them keeps reading the right addresses.  Every path,
    shape and dtype is checked before anything is written.

    Counters (the JAX package's ``_reconcile_guard_counters``): one the
    checkpoint lacks starts at 0 (a zero ``loss_scale`` is re-seeded by
    the trainer), and one this run does not keep is dropped.  The EMA
    (its ``_reconcile_ema``): a run with one restores the saved
    ``ema_params``, or, from a checkpoint without them, starts them at
    the restored parameters; a run without one drops them."""
    odd = sorted(set(tree) - set(TREE_KEYS))
    if odd:
        raise ValueError(f"checkpoint does not fit the state at {odd[0]}: "
                         "the state has no such field")
    plan: list = []
    _match(("params",), {k: p for k, p in model.named_parameters()},
           tree["params"], plan)
    _match(("batch_stats",), dict(model.named_buffers()),
           tree.get("batch_stats") or {}, plan)
    _match(("opt_state",), as_tree(state.opt_state), tree["opt_state"],
           plan)
    for key in _COUNTERS:
        live = getattr(state, key)
        if live is None:
            continue
        saved = tree.get(key)
        if saved is None:
            saved = torch.zeros((), dtype=live.dtype).numpy()
        _match((key,), live, saved, plan)
    if state.ema_params is not None:
        saved = tree.get("ema_params")
        _match(("ema_params",), state.ema_params,
               tree["params"] if saved is None else saved, plan)
    for live, src in plan:
        live.copy_(src)
    state.step = int(tree["step"])

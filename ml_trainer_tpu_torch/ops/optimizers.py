"""Optimizers (the JAX package's ``ops/optimizers.py``), written out as
tensor code that reproduces its optax chains.

An optimizer is a pair of pure functions, as in optax: ``init(params)``
returns the state, ``update(grads, state, params)`` returns the updates
and the NEW state, leaving the old one untouched.  Params, grads and
updates are ``{name: tensor}`` dicts (``dict(model.named_parameters())``);
a state is a tuple of dicts of tensors.  Keeping the state functional is
what lets the trainer's non-finite guard keep the old state, counts
included, with device-side selects and no host sync.  ``torch.optim``
is not used: its defaults and arithmetic differ from optax's (Adagrad's
initial accumulator 0.1 and eps 1e-7 here; AdamW's decay placement).

The reference's five names:

* ``sgd``: coupled decay, then momentum ``trace`` (``g + m * t``), then
  the learning rate;
* ``adam`` / ``adagrad`` / ``adamax``: coupled decay
  (``add_decayed_weights`` before the inner transform);
* ``adamw``: ``scale_by_adam`` -> ``add_decayed_weights(mask)`` ->
  ``scale_by_learning_rate`` (decoupled decay).

The decay mask is always present (default: decay everything;
``decay_mask_matrices_only`` skips 1-D leaves).

``multi_transform(transforms, labels)`` and ``set_to_zero()`` are
optax's (LoRA's frozen base): each leaf goes through the transform its
label names, the others' leaves masked out, so a ``set_to_zero`` leaf
gets a zero update and NO optimizer state, and a transform's global
norm (clipping) covers its own leaves only.  The state is
``{"inner_states": {label: state}}``, optax's ``MultiTransformState``
without the ``MaskedState`` wrappers (``convert.adam_state_from_jax``
drops them).  A leaf that ``update`` is not given (a parameter that
takes no gradient) is treated as masked: it gets no update at all.  ``lamb``, ``lion`` and
``adafactor`` are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Union

import torch

Params = Dict[str, torch.Tensor]
ScalarOrSchedule = Union[float, Callable]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the tensors of nested dicts/tuples/lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of nested dicts/tuples/lists, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def _count(params: Params) -> torch.Tensor:
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def _bias_correction(moment: Params, decay: float,
                     count: torch.Tensor) -> Params:
    bc = 1.0 - torch.pow(decay, count.to(torch.float32))
    return {k: t / bc for k, t in moment.items()}


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: {},
                                  lambda g, state, params=None: (g, state))


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float,
                        mask: Optional[Callable] = None
                        ) -> GradientTransformation:
    """``g + wd * p`` on the leaves the mask keeps (all without one)."""
    def update(updates, state, params=None):
        keep = mask(params) if mask is not None else None
        return {k: g + weight_decay * params[k]
                if keep is None or keep[k] else g
                for k, g in updates.items()}, state

    return GradientTransformation(lambda params: {}, update)


def trace(decay: float) -> GradientTransformation:
    """Momentum: ``t = g + decay * t``, the update is ``t``."""
    def init(params):
        return {"trace": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(updates, state, params=None):
        new = {k: g + decay * state["trace"][k] for k, g in updates.items()}
        return new, {"trace": new}

    return GradientTransformation(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    def init(params):
        return {"count": _count(params),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(updates, state, params=None):
        mu = {k: (1 - b1) * g + b1 * state["mu"][k]
              for k, g in updates.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state["nu"][k]
              for k, g in updates.items()}
        count = state["count"] + 1
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        out = {k: mu_hat[k] / (torch.sqrt(nu_hat[k] + eps_root) + eps)
               for k in updates}
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> GradientTransformation:
    """Adagrad's root of the summed squares (optax's constants)."""
    def init(params):
        return {"sum_of_squares": {
            k: torch.full_like(p, initial_accumulator_value)
            for k, p in params.items()}}

    def update(updates, state, params=None):
        sos = {k: g * g + state["sum_of_squares"][k]
               for k, g in updates.items()}
        out = {}
        for k, g in updates.items():
            t = sos[k]
            inv = torch.where(t > 0, torch.rsqrt(t + eps),
                              torch.zeros_like(t))
            out[k] = inv * g
        return out, {"sum_of_squares": sos}

    return GradientTransformation(init, update)


def scale_by_adamax(b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return {"count": _count(params),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(updates, state, params=None):
        count = state["count"] + 1
        mu = {k: (1 - b1) * g + b1 * state["mu"][k]
              for k, g in updates.items()}
        nu = {k: torch.maximum(torch.abs(g) + eps, b2 * state["nu"][k])
              for k, g in updates.items()}
        mu_hat = _bias_correction(mu, b1, count)
        return ({k: mu_hat[k] / nu[k] for k in updates},
                {"count": count, "mu": mu, "nu": nu})

    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate: ScalarOrSchedule
                           ) -> GradientTransformation:
    """Multiply by ``-lr(count)``; the schedule's count is state."""
    if not callable(learning_rate):
        lr = float(learning_rate)
        return GradientTransformation(
            lambda params: {},
            lambda g, state, params=None: (
                {k: -lr * u for k, u in g.items()}, state))

    def init(params):
        return {"count": _count(params)}

    def update(updates, state, params=None):
        step_size = -learning_rate(state["count"])
        return ({k: step_size.to(u.dtype) * u for k, u in updates.items()},
                {"count": state["count"] + 1})

    return GradientTransformation(init, update)


def global_norm(tree: Params) -> torch.Tensor:
    total = None
    for t in tree.values():
        sq = torch.sum(t * t)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's arithmetic exactly: ``g`` if ``norm < max_norm``, else
    ``g / norm * max_norm`` (no epsilon, unlike torch's
    ``clip_grad_norm_``)."""
    def update(updates, state, params=None):
        norm = global_norm(updates)
        trigger = norm < max_norm
        return {k: torch.where(trigger, t, (t / norm) * max_norm)
                for k, t in updates.items()}, state

    return GradientTransformation(lambda params: {}, update)


def set_to_zero() -> GradientTransformation:
    """Zero updates and no state."""
    return GradientTransformation(
        lambda params: {},
        lambda g, state, params=None: (
            {k: torch.zeros_like(u) for k, u in g.items()}, state))


def multi_transform(transforms: Dict[str, GradientTransformation],
                    labels: Dict[str, str]) -> GradientTransformation:
    """Route each leaf (by name) to ``transforms[labels[name]]``; every
    transform sees only its own leaves (optax's ``masked``)."""
    bad = sorted(set(labels.values()) - set(transforms))
    if bad:
        raise ValueError(f"labels {bad} name no transform")

    def part(tree, label):
        return {k: v for k, v in tree.items() if labels[k] == label}

    def init(params):
        return {"inner_states": {label: tx.init(part(params, label))
                                 for label, tx in transforms.items()}}

    def update(updates, state, params=None):
        out, new = {}, {}
        for label, tx in transforms.items():
            u, new[label] = tx.update(
                part(updates, label), state["inner_states"][label],
                None if params is None else
                {k: params[k] for k in part(updates, label)})
            out.update(u)
        return {k: out[k] for k in updates}, {"inner_states": new}

    return GradientTransformation(init, update)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: p + updates[k] for k, p in params.items()}


def _with_coupled_decay(tx, weight_decay, mask):
    if weight_decay:
        return chain(add_decayed_weights(weight_decay, mask), tx)
    return tx


def _sgd(lr, momentum, weight_decay, mask):
    inner = chain(trace(momentum), scale_by_learning_rate(lr)) if momentum \
        else scale_by_learning_rate(lr)
    return _with_coupled_decay(inner, weight_decay, mask)


def _adam(lr, momentum, weight_decay, mask):
    return _with_coupled_decay(
        chain(scale_by_adam(), scale_by_learning_rate(lr)), weight_decay,
        mask)


def _adagrad(lr, momentum, weight_decay, mask):
    return _with_coupled_decay(
        chain(scale_by_rss(), scale_by_learning_rate(lr)), weight_decay,
        mask)


def _adamax(lr, momentum, weight_decay, mask):
    return _with_coupled_decay(
        chain(scale_by_adamax(), scale_by_learning_rate(lr)), weight_decay,
        mask)


def _adamw(lr, momentum, weight_decay, mask):
    return chain(scale_by_adam(), add_decayed_weights(weight_decay, mask),
                 scale_by_learning_rate(lr))


OPTIMIZERS = {
    "sgd": _sgd,
    "adam": _adam,
    "adagrad": _adagrad,
    "adamax": _adamax,
    "adamw": _adamw,
}
_UNPORTED = ("lamb", "lion", "adafactor")


def decay_mask_matrices_only(params: Params) -> Dict[str, bool]:
    """Decay matrices (ndim >= 2: projections, embeddings); skip biases
    and LayerNorm scales."""
    return {k: p.ndim >= 2 for k, p in params.items()}


def _decay_all(params: Params) -> Dict[str, bool]:
    return {k: True for k in params}


def get_optimizer(name: str, learning_rate: ScalarOrSchedule,
                  momentum: float = 0.9, weight_decay: float = 0.0,
                  decay_mask: Optional[Callable] = None
                  ) -> GradientTransformation:
    """Map an optimizer name to its transformation (unknown names raise
    ``ValueError``)."""
    if name in _UNPORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet; see ROADMAP.md Queue A"
        )
    try:
        factory = OPTIMIZERS[name]
    except KeyError:
        raise ValueError(
            f"Unknown optimizer {name!r}; expected one of "
            f"{sorted(OPTIMIZERS) + list(_UNPORTED)}"
        ) from None
    return factory(learning_rate, momentum, weight_decay,
                   decay_mask or _decay_all)

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

and the JAX package's three more, optax 0.2.6's chains copied:

* ``lamb``: ``scale_by_adam(eps=1e-6)`` -> ``add_decayed_weights(mask)``
  -> ``scale_by_trust_ratio`` -> ``scale_by_learning_rate``;
* ``lion``: ``scale_by_lion`` (b1 0.9, b2 0.99, one moment ``mu``) ->
  ``add_decayed_weights(mask)`` (the factory's ``weight_decay``) ->
  ``scale_by_learning_rate``;
* ``adafactor``: coupled decay, then ``scale_by_factored_rms`` (decay
  0.8, ``min_dim_size_to_factor`` 128, eps 1e-30) ->
  ``clip_by_block_rms(1.0)`` -> ``scale_by_learning_rate(flip_sign=
  False)`` -> ``scale(-1)``; no parameter scale, no momentum.

The decay mask is always present (default: decay everything;
``decay_mask_matrices_only`` skips 1-D leaves).

Two of them are not elementwise, and their arithmetic reads a leaf's
axes: adafactor factors a leaf's second moment over its two largest
axes (optax's ``np.argsort`` of the shape, ties to the later axis), and
``v_row`` alone is normalised by its mean.  The port holds Dense kernels
as [out, in] and convolutions as OIHW, the JAX package as [in, out] and
HWIO, so a square kernel would factor the other way round.
``flax_axes`` (``convert.flax_axes(model)``: a parameter name -> the
permutation that views the port's tensor in the flax layout) makes
``scale_by_factored_rms`` work on the flax view of every leaf: its state
(``v_row``, ``v_col``, ``v``) is the JAX state vector for vector, in
the flax layout.  ``sharded_replicas=n`` gives lamb the trust ratio the
JAX package's ``dp_update="sharded"`` step computes: that step runs the
chain on each replica's dim-0 block of the flax-layout leaf, so the
norms are per block (``scale_by_trust_ratio(replicas=n)``).

``multi_transform(transforms, labels)`` and ``set_to_zero()`` are
optax's (LoRA's frozen base): each leaf goes through the transform its
label names, the others' leaves masked out, so a ``set_to_zero`` leaf
gets a zero update and NO optimizer state, and a transform's global
norm (clipping) covers its own leaves only.  The state is
``{"inner_states": {label: state}}``, optax's ``MultiTransformState``
without the ``MaskedState`` wrappers (``convert.adam_state_from_jax``
drops them).  A leaf that ``update`` is not given (a parameter that
takes no gradient) is treated as masked: it gets no update at all.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
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


def scale_by_learning_rate(learning_rate: ScalarOrSchedule,
                           flip_sign: bool = True
                           ) -> GradientTransformation:
    """Multiply by ``-lr(count)`` (``lr(count)`` without ``flip_sign``);
    the schedule's count is state."""
    m = -1 if flip_sign else 1
    if not callable(learning_rate):
        return scale(m * float(learning_rate))

    def init(params):
        return {"count": _count(params)}

    def update(updates, state, params=None):
        step_size = m * learning_rate(state["count"])
        return ({k: step_size.to(u.dtype) * u for k, u in updates.items()},
                {"count": state["count"] + 1})

    return GradientTransformation(init, update)


def scale(step_size: float) -> GradientTransformation:
    """Multiply every update by a constant."""
    return GradientTransformation(
        lambda params: {},
        lambda g, state, params=None: (
            {k: step_size * u for k, u in g.items()}, state))


def scale_by_lion(b1: float = 0.9, b2: float = 0.99
                  ) -> GradientTransformation:
    """``sign((1 - b1) g + b1 mu)``; ``mu = (1 - b2) g + b2 mu``."""
    def init(params):
        return {"count": _count(params),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(updates, state, params=None):
        mu = state["mu"]
        out = {k: torch.sign((1 - b1) * g + b1 * mu[k])
               for k, g in updates.items()}
        new_mu = {k: (1 - b2) * g + b2 * mu[k] for k, g in updates.items()}
        return out, {"count": state["count"] + 1, "mu": new_mu}

    return GradientTransformation(init, update)


def _blockwise(t: torch.Tensor, block: Optional[tuple]) -> torch.Tensor:
    """``t`` as rows of its blocks: ``block = (axis, n)`` splits ``axis``
    into ``n`` equal blocks ([n, rest]); None is one block ([1, all])."""
    if block is None:
        return t.reshape(1, -1)
    axis, n = block
    return t.movedim(axis, 0).reshape(n, -1)


def scale_by_trust_ratio(replicas: int = 1,
                         flax_axes: Optional[Dict[str, tuple]] = None
                         ) -> GradientTransformation:
    """``u * |p| / |u|`` (1 where either norm is 0), optax's defaults
    (no minimum norm, coefficient 1, eps 0).  ``replicas = n > 1``: the
    norms and the ratio per block of the leaf's flax dim 0 split in
    ``n``, where it divides (the JAX package's sharded step's shards,
    its ``plan_grad_buckets`` rule)."""
    flax_axes = flax_axes or {}

    def block_of(k, t):
        if replicas < 2 or t.ndim == 0:
            return None
        axis = flax_axes.get(k, (0,))[0]
        return (axis, replicas) if t.shape[axis] % replicas == 0 else None

    def update(updates, state, params=None):
        out = {}
        for k, u in updates.items():
            block = block_of(k, u)
            pb, ub = _blockwise(params[k], block), _blockwise(u, block)
            p_norm = torch.sqrt(torch.sum(pb * pb, dim=1, keepdim=True))
            u_norm = torch.sqrt(torch.sum(ub * ub, dim=1, keepdim=True))
            ratio = torch.where((p_norm == 0.0) | (u_norm == 0.0),
                                torch.ones_like(p_norm), p_norm / u_norm)
            scaled = ub * ratio
            if block is None:
                out[k] = scaled.reshape(u.shape)
            else:
                moved = u.movedim(block[0], 0)
                out[k] = scaled.reshape(moved.shape).movedim(0, block[0])
        return out, state

    return GradientTransformation(lambda params: {}, update)


def factored_dims(shape: Sequence[int], min_dim_size_to_factor: int = 128
                  ) -> Optional[tuple]:
    """optax's ``_factored_dims``: (d1, d0), the second largest and the
    largest axis by ``np.argsort``, or None below two axes or when the
    second largest is under ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _inverse(perm: Sequence[int]) -> tuple:
    return tuple(int(i) for i in np.argsort(perm))


def scale_by_factored_rms(decay_rate: float = 0.8,
                          min_dim_size_to_factor: int = 128,
                          epsilon: float = 1e-30,
                          flax_axes: Optional[Dict[str, tuple]] = None
                          ) -> GradientTransformation:
    """Adafactor's factored second moment (optax's
    ``scale_by_factored_rms``, step offset 0), on each leaf's flax view
    (``flax_axes``); the state ``{"count", "v_row", "v_col", "v"}`` in
    the flax layout, with optax's [1] placeholders where a leaf keeps
    the other kind."""
    flax_axes = flax_axes or {}

    def view(k, t):
        perm = flax_axes.get(k)
        return t if perm is None else t.permute(perm)

    def init(params):
        v_row, v_col, v = {}, {}, {}
        for k, p in params.items():
            shape = tuple(view(k, p).shape)
            one = p.new_zeros((1,))
            dims = factored_dims(shape, min_dim_size_to_factor)
            if dims is None:
                v_row[k], v_col[k] = one, one.clone()
                v[k] = p.new_zeros(shape)
            else:
                d1, d0 = dims
                v_row[k] = p.new_zeros(tuple(np.delete(shape, d0)))
                v_col[k] = p.new_zeros(tuple(np.delete(shape, d1)))
                v[k] = one
        return {"count": _count(params), "v_row": v_row, "v_col": v_col,
                "v": v}

    def update(updates, state, params=None):
        t = (state["count"] + 1).to(torch.float32)
        decay_t = 1.0 - torch.pow(t, -decay_rate)
        out, v_row, v_col, v = {}, {}, {}, {}
        for k, g in updates.items():
            gf = view(k, g)
            dims = factored_dims(tuple(gf.shape), min_dim_size_to_factor)
            grad_sqr = gf * gf + epsilon
            if dims is None:
                v_row[k], v_col[k] = state["v_row"][k], state["v_col"][k]
                new_v = decay_t * state["v"][k] + (1.0 - decay_t) * grad_sqr
                v[k] = new_v
                uf = gf * new_v ** -0.5
            else:
                d1, d0 = dims
                new_row = (decay_t * state["v_row"][k]
                           + (1.0 - decay_t) * torch.mean(grad_sqr, dim=d0))
                new_col = (decay_t * state["v_col"][k]
                           + (1.0 - decay_t) * torch.mean(grad_sqr, dim=d1))
                v_row[k], v_col[k], v[k] = new_row, new_col, state["v"][k]
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = torch.mean(new_row, dim=reduced_d1,
                                          keepdim=True)
                row_factor = (new_row / row_col_mean) ** -0.5
                col_factor = new_col ** -0.5
                uf = (gf * row_factor.unsqueeze(d0)
                      * col_factor.unsqueeze(d1))
            perm = flax_axes.get(k)
            out[k] = uf if perm is None else uf.permute(_inverse(perm))
        return out, {"count": state["count"] + 1, "v_row": v_row,
                     "v_col": v_col, "v": v}

    return GradientTransformation(init, update)


def clip_by_block_rms(threshold: float) -> GradientTransformation:
    """Each leaf divided by ``max(1, rms(leaf) / threshold)``."""
    def update(updates, state, params=None):
        return {k: u / torch.clamp(torch.sqrt(torch.mean(u * u))
                                   / threshold, min=1.0)
                for k, u in updates.items()}, state

    return GradientTransformation(lambda params: {}, update)


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


def _lamb(lr, momentum, weight_decay, mask, flax_axes=None,
          sharded_replicas=1):
    return chain(scale_by_adam(eps=1e-6),
                 add_decayed_weights(weight_decay, mask),
                 scale_by_trust_ratio(sharded_replicas, flax_axes),
                 scale_by_learning_rate(lr))


def _lion(lr, momentum, weight_decay, mask, flax_axes=None,
          sharded_replicas=1):
    return chain(scale_by_lion(), add_decayed_weights(weight_decay, mask),
                 scale_by_learning_rate(lr))


def _adafactor(lr, momentum, weight_decay, mask, flax_axes=None,
               sharded_replicas=1):
    return _with_coupled_decay(
        chain(scale_by_factored_rms(flax_axes=flax_axes),
              clip_by_block_rms(1.0),
              scale_by_learning_rate(lr, flip_sign=False), scale(-1)),
        weight_decay, mask)


OPTIMIZERS = {
    "sgd": _sgd,
    "adam": _adam,
    "adagrad": _adagrad,
    "adamax": _adamax,
    "adamw": _adamw,
    "lamb": _lamb,
    "lion": _lion,
    "adafactor": _adafactor,
}
# The names whose arithmetic reads a leaf's axes (``flax_axes``).
_LAYOUT_AWARE = ("lamb", "lion", "adafactor")


def decay_mask_matrices_only(params: Params) -> Dict[str, bool]:
    """Decay matrices (ndim >= 2: projections, embeddings); skip biases
    and LayerNorm scales."""
    return {k: p.ndim >= 2 for k, p in params.items()}


def _decay_all(params: Params) -> Dict[str, bool]:
    return {k: True for k in params}


def get_optimizer(name: str, learning_rate: ScalarOrSchedule,
                  momentum: float = 0.9, weight_decay: float = 0.0,
                  decay_mask: Optional[Callable] = None,
                  flax_axes: Optional[Dict[str, tuple]] = None,
                  sharded_replicas: int = 1) -> GradientTransformation:
    """Map an optimizer name to its transformation (unknown names raise
    ``ValueError``).  ``flax_axes`` and ``sharded_replicas``: see the
    module's docstring (adafactor and lamb read them)."""
    try:
        factory = OPTIMIZERS[name]
    except KeyError:
        raise ValueError(
            f"Unknown optimizer {name!r}; expected one of {sorted(OPTIMIZERS)}"
        ) from None
    extra = {}
    if name in _LAYOUT_AWARE:
        extra = dict(flax_axes=flax_axes, sharded_replicas=sharded_replicas)
    return factory(learning_rate, momentum, weight_decay,
                   decay_mask or _decay_all, **extra)

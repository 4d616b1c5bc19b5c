"""Port parity: K4 (``unscale_sqsum``) and K5 (``fused_adam_update``) of
``ml_trainer_tpu_torch.ops.kernels.fused_adam`` against the JAX
package's on the CPU.

The JAX side runs its Pallas kernels as its own tests run them
(``implementation="pallas", interpret=True`` under ``jax.jit``); the port
runs its plain versions (a CPU tensor).  Inputs are made with numpy from
a seed.  Bars:

* K4: the quotient bitwise (an IEEE division on both sides; the denoms
  are powers of two, which the JAX side may also compute as a multiply),
  the squared sum rtol 1e-6 (float32 sums in another order; observed
  <= 1.2e-7);
* K5: p', mu', nu', u rtol 1e-6, with 1e-6 of the output's largest
  entry as the absolute bar for entries near zero: XLA's CPU jit
  contracts multiply-adds into FMAs where PyTorch rounds each op, and
  ``mu' = 0.1 g + 0.9 mu`` cancels (observed: p' within 1.2e-7
  relative; mu' and u up to 5.9e-6 relative on near-zero entries, at
  most 2.4e-7 absolute on mu' of magnitude ~2);
* ``adam_scalars`` against the JAX one under ``jax.jit`` (as the step
  runs it): the counts equal, bc1/bc2/step_size rtol 1e-6 (observed:
  bitwise; run eagerly, JAX's ``1 - 0.999 ** 8`` differs by 7.5e-6
  relative, the cancellation magnifying one rounding of the power);
* one update of GPT-2 tiny's leaves from a mid-run optax state carried
  by ``adam_state_from_jax``: K5's bar on every output;
* within the port, 8 steps of the fused tail against the unfused
  ``chain(identity(), adam(sched))``: params and state bitwise equal at
  every step.

``test_fused_adam_kernels_match_plain_on_card`` needs an NVIDIA card and
nvcc (marker ``cuda``) and skips here.  The list entry points have their
own CPU tests in ``tests/test_torch_fused_adam_list.py``.
"""

import importlib
import importlib.util

import numpy as np
import pytest
import torch

import ml_trainer_tpu_torch as mt
from ml_trainer_tpu_torch.ops import optimizers as topt
from ml_trainer_tpu_torch.ops.kernels import (
    adam_scalars,
    fused_adam_update,
    fused_adam_update_list,
    unscale_sqsum,
    unscale_sqsum_list,
)
from ml_trainer_tpu_torch.ops.schedules import make_lr_schedule

SHAPES = [(7,), (128,), (3, 5), (64, 16), (2, 3, 4)]

# The JAX side is imported lazily: the card's machine has no jax, and the
# cuda test of this file runs there (pytest --noconftest).
jax = importlib.import_module("jax") if importlib.util.find_spec(
    "jax") else None


def _jx():
    """(jax.numpy, optax, the JAX package's fused_adam module, its
    make_lr_schedule, its get_model)."""
    return (importlib.import_module("jax.numpy"),
            importlib.import_module("optax"),
            importlib.import_module("ml_trainer_tpu.ops.kernels.fused_adam"),
            importlib.import_module(
                "ml_trainer_tpu.ops.schedules").make_lr_schedule,
            importlib.import_module("ml_trainer_tpu.models").get_model)


def _jrun(fn, *args, **kw):
    return jax.jit(lambda *a: fn(*a, **kw))(*args)


def _bits(t) -> bytes:
    return np.ascontiguousarray(np.asarray(t)).tobytes()


def _close(got, want, what):
    """K5's bar: rtol 1e-6, and 1e-6 of the output's largest entry for
    entries near zero (see the module docstring)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("shape", SHAPES)
def test_unscale_sqsum_matches_jax_interpret(shape):
    jnp, _, jfa, _, _ = _jx()
    rng = np.random.default_rng(2)
    g = rng.normal(size=shape).astype(np.float32)
    for denom in (2.0, np.float32(8.0)):
        j_denom = denom if isinstance(denom, float) else jnp.float32(denom)
        t_denom = denom if isinstance(denom, float) else torch.tensor(denom)
        for compute_sq in (True, False):
            want = _jrun(jfa.unscale_sqsum, jnp.asarray(g), j_denom,
                         compute_sq=compute_sq, implementation="pallas",
                         interpret=True)
            got = unscale_sqsum(torch.tensor(g), t_denom,
                                compute_sq=compute_sq)
            assert got[0].shape == shape
            assert _bits(got[0]) == _bits(want[0])
            assert (got[1] is None) == (want[1] is None) == (not compute_sq)
            if compute_sq:
                np.testing.assert_allclose(got[1].item(), float(want[1]),
                                           rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_adam_update_matches_jax_interpret(shape):
    jnp, _, jfa, _, _ = _jx()
    rng = np.random.default_rng(3)
    g, p, mu = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    nu = np.abs(rng.normal(size=shape)).astype(np.float32) * 1e-2
    scal = dict(bc1=np.float32(0.271), bc2=np.float32(0.002997),
                step_size=np.float32(-3e-4), lr_scale=np.float32(0.5))
    for factor in (None, np.float32(0.37)):
        want = _jrun(
            jfa.fused_adam_update, *map(jnp.asarray, (g, p, mu, nu)),
            **{k: jnp.asarray(v) for k, v in scal.items()},
            factor=None if factor is None else jnp.asarray(factor),
            implementation="pallas", interpret=True)
        got = fused_adam_update(
            *map(torch.tensor, (g, p, mu, nu)),
            **{k: torch.tensor(v) for k, v in scal.items()},
            factor=None if factor is None else torch.tensor(factor))
        for name, a, b in zip(("p", "mu", "nu", "u"), got, want):
            assert a.shape == shape
            _close(a, b, name)


def test_adam_scalars_match_jax():
    jnp, _, jfa, j_schedule, _ = _jx()
    j_sched = j_schedule("CosineAnnealingWarmRestarts", 3e-4, 4)
    t_sched = make_lr_schedule("CosineAnnealingWarmRestarts", 3e-4, 4)
    for count, sched_count in ((0, 0), (1, 1), (7, 5), (123, 123)):
        want = jax.jit(lambda c, s: jfa.adam_scalars(c, s, j_sched))(
            jnp.int32(count), jnp.int32(sched_count))
        got = adam_scalars(torch.tensor(count, dtype=torch.int32),
                           torch.tensor(sched_count, dtype=torch.int32),
                           t_sched)
        assert int(got[0]) == int(want[0]) == count + 1
        assert int(got[4]) == int(want[4]) == sched_count + 1
        assert got[0].dtype == got[4].dtype == torch.int32
        for a, b in zip(got[1:4], want[1:4]):
            assert a.dtype == torch.float32 and a.shape == ()
            np.testing.assert_allclose(a.item(), float(b), rtol=1e-6)
    # Saturating increment, as optax's safe_int32_increment.
    top = torch.tensor(2 ** 31 - 1, dtype=torch.int32)
    assert int(adam_scalars(top, top, 1e-3)[0]) == 2 ** 31 - 1


def test_one_update_from_a_mid_run_jax_state():
    jnp, optax, jfa, j_schedule, jget_model = _jx()
    model = jget_model("gpt2_tiny", vocab_size=256)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    sched = j_schedule("CosineAnnealingWarmRestarts", 1e-2, 3)
    tx = optax.chain(optax.identity(), optax.adam(sched))
    state = tx.init(params)
    rng = np.random.default_rng(5)

    def grads_like(tree):
        return jax.tree.map(
            lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32),
            tree)

    for _ in range(3):  # a mid-run state: counts 3, moments non-zero
        updates, state = tx.update(grads_like(params), state, params)
        params = optax.apply_updates(params, updates)
    grads = grads_like(params)
    _, (adam_st, sched_st) = state
    count_inc, bc1, bc2, step, _ = jfa.adam_scalars(adam_st.count,
                                                    sched_st.count, sched)
    outs = jax.tree.map(
        lambda g, p, m, v: _jrun(jfa.fused_adam_update, g, p, m, v, bc1=bc1,
                                 bc2=bc2,
                                 step_size=step, lr_scale=1.0,
                                 factor=jnp.float32(0.5),
                                 implementation="pallas", interpret=True),
        grads, params, adam_st.mu, adam_st.nu)
    want = [mt.params_from_jax(jax.tree.map(
        lambda o, i=i: np.asarray(o[i]), outs,
        is_leaf=lambda o: isinstance(o, tuple))) for i in range(4)]

    host = jax.tree.map(np.asarray, state)
    t_state = mt.adam_state_from_jax(host)
    assert t_state[0] == {} and int(t_state[1][1]["count"]) == 3
    t_adam = t_state[1][0]
    t_params = mt.params_from_jax(jax.tree.map(np.asarray, params))
    t_grads = mt.params_from_jax(jax.tree.map(np.asarray, grads))
    scalars = adam_scalars(t_adam["count"], t_state[1][1]["count"],
                           make_lr_schedule("CosineAnnealingWarmRestarts",
                                            1e-2, 3))
    assert int(scalars[0]) == int(count_inc) == 4
    for name, g in t_grads.items():
        got = fused_adam_update(
            g, t_params[name], t_adam["mu"][name], t_adam["nu"][name],
            bc1=scalars[1], bc2=scalars[2], step_size=scalars[3],
            lr_scale=1.0, factor=torch.tensor(0.5))
        for i, out in enumerate(got):
            _close(out, want[i][name], f"{name} output {i}")


def test_fused_tail_trajectory_matches_unfused_chain():
    """8 steps of the fused tail (unscale -> global clip -> adam_scalars ->
    fused_adam_update -> state rebuild) against the unfused chain: params
    AND state bitwise equal at every step, so the two are
    interchangeable mid-run."""
    shapes = {"w": (32, 16), "b": (16,), "emb": (64, 8)}
    rng = np.random.default_rng(4)
    params = {n: torch.tensor(rng.normal(size=s).astype(np.float32) * 0.02)
              for n, s in shapes.items()}
    lr, clip, denom = 1e-2, 1.0, 4.0

    def sched(count):
        return torch.full((), lr, dtype=torch.float32)

    tx = topt.chain(topt.identity(), topt.get_optimizer("adam", sched))
    clip_t = torch.tensor(clip)

    def ref_tail(g, p, st):
        g = {k: torch.div(t, torch.tensor(denom)) for k, t in g.items()}
        sq = sum(torch.sum(torch.square(t)) for t in g.values())
        factor = torch.div(clip_t, torch.maximum(torch.sqrt(sq), clip_t))
        g = {k: t * factor for k, t in g.items()}
        updates, new_st = tx.update(g, st, p)
        return {k: p[k] + u * 1.0 for k, u in updates.items()}, new_st

    def fused_tail(g, p, st):
        _e, (adam, sch) = st
        gs, sq = {}, 0.0
        for k, t in g.items():
            gs[k], s = unscale_sqsum(t, denom, compute_sq=True)
            sq = sq + s
        factor = torch.div(clip_t, torch.maximum(torch.sqrt(sq), clip_t))
        count, bc1, bc2, step, sched_count = adam_scalars(
            adam["count"], sch["count"], sched)
        outs = {k: fused_adam_update(t, p[k], adam["mu"][k], adam["nu"][k],
                                     bc1=bc1, bc2=bc2, step_size=step,
                                     lr_scale=1.0, factor=factor)
                for k, t in gs.items()}
        return {k: o[0] for k, o in outs.items()}, ({}, (
            {"count": count, "mu": {k: o[1] for k, o in outs.items()},
             "nu": {k: o[2] for k, o in outs.items()}},
            {"count": sched_count}))

    p_ref = p_fused = params
    st_ref = st_fused = tx.init(params)
    for step in range(8):
        grads = {n: torch.tensor(rng.normal(size=s).astype(np.float32))
                 for n, s in shapes.items()}
        p_ref, st_ref = ref_tail(grads, p_ref, st_ref)
        p_fused, st_fused = fused_tail(grads, p_fused, st_fused)
        for k in shapes:
            assert torch.equal(p_ref[k], p_fused[k]), (step, k)
        flat_ref, flat_fused = [], []
        topt.tree_map(flat_ref.append, st_ref)
        topt.tree_map(flat_fused.append, st_fused)
        assert len(flat_ref) == len(flat_fused) == 2 + 2 * len(shapes)
        for a, b in zip(flat_ref, flat_fused):
            assert a.dtype == b.dtype and torch.equal(a, b), step


def test_fused_adam_dispatch_and_refusals():
    g = torch.ones(4)
    with pytest.raises(ValueError, match="Unknown unscale_sqsum"):
        unscale_sqsum(g, 2.0, implementation="pallas")
    with pytest.raises(ValueError, match="Unknown fused_adam_update"):
        fused_adam_update(g, g, g, g, bc1=1.0, bc2=1.0, step_size=-1.0,
                          lr_scale=1.0, implementation="triton")
    mt.reset_launch_counts()
    out, sq = unscale_sqsum(g * 3, 3.0)
    assert torch.equal(out, g) and sq.item() == 4.0
    assert mt.launch_counts()["unscale_sqsum"] == 0


@pytest.mark.cuda
def test_fused_adam_kernels_match_plain_on_card():
    """K4 and K5 against their plain versions on the card, per leaf and
    over a list of leaves: K4's quotient bitwise and its sums within 1e-5
    relative, K5 bitwise (float32); the list calls also bitwise across
    two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA) and nvcc")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    mt.reset_launch_counts()
    for shape in ((7,), (4097,), (3, 5, 7), (1152, 768), (384,)):
        g, p, mu = (torch.randn(shape, generator=gen).to(dev)
                    for _ in range(3))
        nu = torch.rand(shape, generator=gen).to(dev) * 1e-3
        for denom in (4.0, torch.tensor(6.0, device=dev)):
            got = unscale_sqsum(g, denom)
            want = unscale_sqsum(g, denom, implementation="reference")
            assert torch.equal(got[0], want[0])
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
        for factor in (None, torch.tensor(0.3, device=dev)):
            kw = dict(bc1=torch.tensor(0.19, device=dev),
                      bc2=torch.tensor(0.002, device=dev),
                      step_size=torch.tensor(-3e-4, device=dev),
                      lr_scale=0.5, factor=factor)
            got = fused_adam_update(g, p, mu, nu, **kw)
            want = fused_adam_update(g, p, mu, nu, implementation="reference",
                                     **kw)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    counts = mt.launch_counts()
    assert counts["unscale_sqsum"] == counts["fused_adam"] == 10
    # The list entry points over ragged leaves, an empty one and a view at
    # an odd element offset, one launch each: bitwise the plain versions,
    # and two calls bitwise equal.
    shapes = ((7,), (4097,), (0,), (3, 5, 7), (1152, 768), (384,))
    gs, ps, mus = ([torch.randn(s, generator=gen).to(dev) for s in shapes]
                   for _ in range(3))
    nus = [torch.rand(s, generator=gen).to(dev) * 1e-3 for s in shapes]
    gs.append(torch.randn(2 * 16384 + 3, generator=gen).to(dev)[1:])
    for kind in (ps, mus, nus):
        kind.append(torch.rand(gs[-1].shape, generator=gen).to(dev))
    sharded = [i % 3 != 1 for i in range(len(gs))]
    mt.reset_launch_counts()
    runs = [unscale_sqsum_list(gs, 4.0, sharded=sharded) for _ in range(2)]
    want = unscale_sqsum_list(gs, 4.0, sharded=sharded,
                              implementation="reference")
    for a, b, c in zip(runs[0][0], runs[1][0], want[0]):
        assert torch.equal(a, c) and torch.equal(a, b)
    for a, b, c in zip(runs[0][1], runs[1][1], want[1]):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=0)
    for a, b, c in zip(runs[0][2], runs[1][2], want[2]):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=0)
    kw = dict(bc1=torch.tensor(0.19, device=dev),
              bc2=torch.tensor(0.002, device=dev),
              step_size=torch.tensor(-3e-4, device=dev), lr_scale=0.5,
              factor=torch.tensor(0.3, device=dev))
    runs = [fused_adam_update_list(gs, ps, mus, nus, **kw) for _ in range(2)]
    want = fused_adam_update_list(gs, ps, mus, nus,
                                  implementation="reference", **kw)
    for kind in range(4):
        for a, b, c in zip(runs[0][kind], runs[1][kind], want[kind]):
            assert torch.equal(a, c) and torch.equal(a, b)
    counts = mt.launch_counts()
    assert counts["unscale_sqsum"] == counts["fused_adam"] == 2

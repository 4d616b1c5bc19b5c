"""Per-block rematerialisation in the port (``remat``, ``remat_policy``;
``models/layers.py`` ``remat_call``) on the CPU.

Against JAX (the shapes of ``tests/test_models.py``'s remat tests, one
layer: gpt2_tiny at vocab 256, 32 wide, 2 heads, [2, 32]): the port's
gradients under ``remat=True`` with policy 'none' and 'dots' against the
JAX package's under the same settings, at atol 1e-5 + rtol 1e-5 (the
JAX tests' own bar between policies; float32 sums in another order).

Within the port the recompute runs the same ops on the same inputs, so
the gradients with remat on, under either policy, are bitwise those
with it off, for gpt2, bert, vit and llama, with dropout too; an
unknown policy raises ``ValueError`` naming ``remat_policy``, as the
JAX helper does (and, as there, only when ``remat`` is on); eval and
decode run no checkpoint; a fit with ``remat`` is bitwise one without.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import ml_trainer_tpu_torch as mt
from ml_trainer_tpu.models import get_model as jget_model

JKW = dict(vocab_size=256, embed_dim=32, depth=1, num_heads=2, max_len=32)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_remat():
    """The JAX gradients under remat 'none' and 'dots' (one program)."""
    ids = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)
    targets = np.roll(ids, -1, axis=1)
    models = {p: jget_model("gpt2_tiny", remat=True, remat_policy=p, **JKW)
              for p in ("none", "dots")}

    @jax.jit
    def run(key):
        v = models["none"].init({"params": key}, ids, train=False)
        grads = {}
        for p, m in models.items():
            def loss(params, m=m):
                out = m.apply({"params": params}, ids, train=True)
                return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
                    out, targets))
            grads[p] = jax.grad(loss)(v["params"])
        return v, grads

    v, grads = _host(run(jax.random.PRNGKey(0)))
    return ids, targets, mt.params_from_jax(v), {
        p: mt.params_from_jax(g) for p, g in grads.items()}


def _grads(model, ids, targets):
    out = model(torch.as_tensor(ids))
    loss = F.cross_entropy(out.reshape(-1, out.shape[-1]),
                           torch.as_tensor(targets).reshape(-1).long())
    names = [k for k, _ in model.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss,
                                               list(model.parameters()))))


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_remat_gradients_match_jax(jax_remat, policy):
    ids, targets, state, want = jax_remat
    model = mt.get_model("gpt2_tiny", remat=True, remat_policy=policy,
                         device="cpu", **JKW)
    model.load_state_dict(state)
    got = _grads(model, ids, targets)
    assert set(got) == set(want[policy])
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[policy][k].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def _family_batch(name):
    rng = np.random.default_rng(1)
    if name.startswith("vit"):
        return (torch.as_tensor(rng.normal(size=(2, 32, 32, 3)),
                                dtype=torch.float32),
                torch.as_tensor(rng.integers(0, 10, 2)))
    ids = torch.as_tensor(rng.integers(1, 128, (2, 16)))
    if name.startswith("bert"):
        return ids, torch.as_tensor(rng.integers(0, 2, 2))
    return ids, torch.roll(ids, -1, 1)


def _family_grads(name, **kw):
    model = mt.init_model(name, seed=3, device="cpu", **kw).train()
    x, y = _family_batch(name)
    out = model(x)
    loss = F.cross_entropy(out.reshape(-1, out.shape[-1]), y.reshape(-1))
    return torch.autograd.grad(loss, list(model.parameters()))


FAMILIES = [("gpt2_tiny", {}), ("bert_tiny", {}), ("vit_tiny", {}),
            ("llama_tiny", {}), ("gpt2_tiny", {"dropout_rate": 0.1}),
            ("bert_tiny", {"dropout_rate": 0.1})]


@pytest.mark.parametrize("name,kw", FAMILIES,
                         ids=[f"{n}{'-dropout' if k else ''}"
                              for n, k in FAMILIES])
def test_remat_on_is_bitwise_remat_off(name, kw):
    want = _family_grads(name, **kw)
    for policy in ("none", "dots"):
        got = _family_grads(name, remat=True, remat_policy=policy, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b), policy


@pytest.mark.parametrize("name", ["gpt2_tiny", "bert_tiny", "vit_tiny",
                                  "llama_tiny"])
def test_unknown_policy_raises_only_with_remat(name):
    with pytest.raises(ValueError, match="remat_policy"):
        mt.get_model(name, remat=True, remat_policy="everything",
                     device="cpu")
    mt.get_model(name, remat_policy="everything", device="cpu")


def test_eval_and_decode_run_no_checkpoint(monkeypatch):
    from ml_trainer_tpu_torch.models import layers

    calls = []
    real = layers._checkpoint.checkpoint
    monkeypatch.setattr(layers._checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = mt.init_model("gpt2_tiny", remat=True, max_len=32, device="cpu")
    ids = torch.arange(8)[None]
    with torch.no_grad():
        model(ids)
    mt.generate(model, ids.numpy(), 2, device="cpu")
    assert calls == []
    model(ids).sum().backward()
    assert len(calls) == model.depth


def test_a_fit_with_remat_is_bitwise_one_without(tmp_path):
    sets = (mt.SyntheticTokens(size=8, seq_len=16, vocab_size=128),
            mt.SyntheticTokens(size=4, seq_len=16, vocab_size=128, seed=1))
    runs = []
    for kw in ({}, dict(remat=True, remat_policy="dots")):
        model = mt.init_model("gpt2_tiny", vocab_size=128, max_len=16,
                              embed_dim=32, depth=1, device="cpu", **kw)
        tr = mt.Trainer(model, datasets=sets, epochs=1, batch_size=4,
                        grad_accum_steps=2, metric=None, optimizer="adam",
                        device="cpu", model_dir=str(tmp_path / str(len(runs))))
        tr.fit()
        runs.append(tr)
    a, b = runs
    assert a.history["train_loss"] == b.history["train_loss"]
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)

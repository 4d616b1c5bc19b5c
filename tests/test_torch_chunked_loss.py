"""Port parity: the chunked LM loss (``ops/losses.py``
``chunked_lm_cross_entropy``), GPT-2's ``loss_chunk`` and the Trainer's
model-computed-loss path, against the JAX package on the CPU.

Tolerances (float32 logits throughout; the two packages add the same
terms in another order):

* the function against JAX's: loss rtol 1e-5; d(hidden) and
  d(embedding) within 1e-5 of each array's largest entry.  With bf16
  ``hidden`` (the gradient comes back in bf16, each package rounding its
  own float32 sum once): within one bf16 ulp of JAX's, 2^-7 of each
  element plus 1e-6 of the largest;
* chunked against dense within the port: loss rtol 1e-6, gradients 1e-5
  of their largest entry;
* ``gpt2_tiny`` with targets against the JAX model from the same weights
  (``params_from_jax``): loss rtol 1e-5, every parameter gradient within
  1e-4 of its largest entry;
* a ``fit()`` with ``loss_chunk`` and ``grad_accum_steps=2`` against the
  JAX trainer's: epoch losses rtol 1e-4, final parameters atol 1e-4 (the
  attention key bias 1e-3, as in ``test_torch_trainer.py``); the port at
  ``steps_per_execution=2`` bitwise its K = 1 run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ml_trainer_tpu as J
import ml_trainer_tpu_torch as mt
from ml_trainer_tpu.data import SyntheticTokens as JTokens
from ml_trainer_tpu.models import get_model as jget_model
from ml_trainer_tpu.ops.losses import chunked_lm_cross_entropy as jchunked
from ml_trainer_tpu_torch.ops.losses import chunked_lm_cross_entropy


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: small ops otherwise wait on all cores'
    threads, which the suite's other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(b=2, s=64, d=16, v=50, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, d)).astype(np.float32),
            (0.5 * rng.standard_normal((v, d))).astype(np.float32),
            rng.integers(0, v, (b, s)).astype(np.int32))


def _port(h, e, t, chunk, dtype=torch.float32):
    h_t = torch.tensor(h, dtype=dtype, requires_grad=True)
    e_t = torch.tensor(e, requires_grad=True)
    loss = chunked_lm_cross_entropy(h_t, e_t, torch.tensor(t), chunk)
    loss.backward()
    return loss.detach(), h_t.grad, e_t.grad


def _jax(h, e, t, chunk, dtype=jnp.float32):
    fn = jax.value_and_grad(
        lambda hh, ee: jchunked(hh, ee, jnp.asarray(t), chunk), (0, 1))
    loss, (dh, de) = fn(jnp.asarray(h, dtype), jnp.asarray(e))
    return (float(loss), np.asarray(dh.astype(jnp.float32)),
            np.asarray(de))


def _close_to_max(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("chunk", [8, 32, 64])
def test_fp32_loss_and_gradients_match_jax(chunk):
    h, e, t = _inputs()
    loss, dh, de = _port(h, e, t, chunk)
    jloss, jdh, jde = _jax(h, e, t, chunk)
    assert loss.dtype == dh.dtype == de.dtype == torch.float32
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _close_to_max(dh, jdh, 1e-5)
    _close_to_max(de, jde, 1e-5)


def test_bf16_hidden_matches_jax_within_one_bf16_ulp():
    h, e, t = _inputs(seed=1)
    h = np.asarray(torch.tensor(h).bfloat16().float())
    loss, dh, de = _port(h, e, t, 16, dtype=torch.bfloat16)
    jloss, jdh, jde = _jax(h, e, t, 16, dtype=jnp.bfloat16)
    assert dh.dtype == torch.bfloat16 and de.dtype == torch.float32
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    got = dh.float().numpy()
    assert (np.abs(got - jdh) <= 2.0 ** -7 * np.abs(jdh)
            + 1e-6 * np.abs(jdh).max()).all()
    _close_to_max(de, jde, 1e-5)


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_chunked_equals_dense_within_the_port(chunk):
    h, e, t = _inputs(b=3, s=64, seed=2)
    loss, dh, de = _port(h, e, t, chunk)
    h_t = torch.tensor(h, requires_grad=True)
    e_t = torch.tensor(e, requires_grad=True)
    dense = torch.nn.functional.cross_entropy(
        (h_t @ e_t.T).reshape(-1, e.shape[0]), torch.tensor(t).reshape(-1)
        .long())
    dense.backward()
    np.testing.assert_allclose(float(loss), dense.item(), rtol=1e-6)
    _close_to_max(dh, h_t.grad, 1e-5)
    _close_to_max(de, e_t.grad, 1e-5)


def test_shape_errors_match_jax():
    h, e, t = _inputs(s=48)
    for fn, arrays in ((jchunked, (jnp.asarray(h), jnp.asarray(e),
                                   jnp.asarray(t))),
                       (chunked_lm_cross_entropy,
                        (torch.tensor(h), torch.tensor(e), torch.tensor(t)))):
        with pytest.raises(ValueError, match="sequence length 48 not "
                                             "divisible by chunk_size 32"):
            fn(*arrays, 32)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def test_gpt2_tiny_targets_match_the_jax_model():
    seq = 64
    jmodel = jget_model("gpt2_tiny", loss_chunk=16)
    x = np.random.default_rng(3).integers(0, 1024, (2, seq)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jnp.asarray(x),
                               targets=jnp.asarray(y)))(variables["params"])
    model = mt.get_model("gpt2_tiny", loss_chunk=16, device="cpu")
    model.load_state_dict(mt.params_from_jax(_host(variables)))
    loss = model(torch.tensor(x), targets=torch.tensor(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = mt.params_from_jax(_host({"params": jgrads}))
    for name, p in model.named_parameters():
        _close_to_max(p.grad, want[name], 1e-4)
    # The dense head of the same weights gives the same loss.
    with torch.no_grad():
        logits = model(torch.tensor(x))
    dense = torch.nn.functional.cross_entropy(logits.reshape(-1, 1024),
                                              torch.tensor(y).reshape(-1)
                                              .long())
    np.testing.assert_allclose(float(dense), loss.item(), rtol=1e-6)
    with pytest.raises(ValueError, match="targets requires loss_chunk > 0"):
        mt.get_model("gpt2_tiny", device="cpu")(torch.tensor(x),
                                                targets=torch.tensor(y))


FIT_KW = dict(epochs=2, batch_size=8, grad_accum_steps=2, optimizer="adamw",
              lr=3e-4, weight_decay=0.01, grad_clip_norm=1.0, metric=None)


def _port_fit(tmp_path, params, name, **kw):
    seq = 64
    sets = (mt.SyntheticTokens(size=32, seq_len=seq, vocab_size=1024),
            mt.SyntheticTokens(size=16, seq_len=seq, vocab_size=1024,
                               seed=1))
    model = mt.get_model("gpt2_tiny", loss_chunk=16, device="cpu")
    model.load_state_dict(params)
    tr = mt.Trainer(model, datasets=sets, device="cpu",
                    model_dir=str(tmp_path / name), **dict(FIT_KW, **kw))
    tr.fit()
    return tr


@pytest.fixture(scope="module")
def chunked_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chunked")
    seq = 64
    j_sets = (JTokens(size=32, seq_len=seq, vocab_size=1024),
              JTokens(size=16, seq_len=seq, vocab_size=1024, seed=1))
    jtr = J.Trainer(jget_model("gpt2_tiny", loss_chunk=16), datasets=j_sets,
                    backend="cpu", loader="python",
                    model_dir=str(tmp / "j"), **FIT_KW)
    params = mt.params_from_jax(_host({"params": jtr.state.params}))
    jtr.fit()
    return (jtr, _port_fit(tmp, params, "k1"),
            _port_fit(tmp, params, "k2", steps_per_execution=2))


def test_fit_with_loss_chunk_matches_the_jax_trainer(chunked_runs):
    jtr, ttr, _ = chunked_runs
    assert ttr._takes_targets
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(ttr.history[key], jtr.history[key],
                                   rtol=1e-4, err_msg=key)
    assert ttr.history["train_metric"] == jtr.history["train_metric"] == []
    assert ttr.state.step == int(jtr.state.step) == 8
    want = mt.params_from_jax(_host({"params": jtr.state.params}))
    e = 128  # embed dim: the key bias is qkv.bias[e:2e]
    for name, w in want.items():
        g = ttr.model.state_dict()[name]
        if name.endswith("attn.qkv.bias"):
            torch.testing.assert_close(g[e:2 * e], w[e:2 * e], atol=1e-3,
                                       rtol=0, msg=name)
            g, w = torch.cat([g[:e], g[2 * e:]]), torch.cat([w[:e],
                                                             w[2 * e:]])
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0, msg=name)


def test_loss_chunk_at_k2_is_bitwise_the_k1_run(chunked_runs):
    _, k1, k2 = chunked_runs
    for name, w in k1.model.state_dict().items():
        assert k2.model.state_dict()[name].equal(w), name
    np.testing.assert_allclose(k2.history["train_loss"],
                               k1.history["train_loss"], rtol=1e-6)


def test_test_of_the_trained_model_equals_its_validation(chunked_runs):
    _, ttr, _ = chunked_runs
    loader = mt.Loader(mt.SyntheticTokens(size=16, seq_len=64,
                                          vocab_size=1024, seed=1),
                       batch_size=8)
    loss = ttr.test(test_loader=loader)
    assert isinstance(loss, float) and np.isfinite(loss)


def test_guards_match_the_jax_messages(tmp_path):
    sets = (mt.SyntheticTokens(size=16, seq_len=32, vocab_size=1024),) * 2
    j_sets = (JTokens(size=16, seq_len=32, vocab_size=1024),) * 2
    for kw in (dict(metric="accuracy"),
               dict(metric=None, label_smoothing=0.1)):
        with pytest.raises(ValueError) as want:
            J.Trainer(jget_model("gpt2_tiny", loss_chunk=16),
                      datasets=j_sets, backend="cpu", batch_size=8,
                      epochs=1, model_dir=str(tmp_path / "j"), **kw)
        with pytest.raises(ValueError) as got:
            mt.Trainer(mt.get_model("gpt2_tiny", loss_chunk=16,
                                    device="cpu"),
                       datasets=sets, device="cpu", batch_size=8, epochs=1,
                       model_dir=str(tmp_path / "t"), **kw)
        assert str(got.value) == str(want.value)
    # test() of a foreign model that computes its own loss, with a metric.
    dense = mt.Trainer(mt.get_model("gpt2_tiny", device="cpu"),
                       datasets=sets, device="cpu", batch_size=8, epochs=1,
                       model_dir=str(tmp_path / "d"))
    loader = mt.Loader(sets[0], batch_size=8)
    with pytest.raises(ValueError, match="metric must be None when "
                                         "evaluating a model that computes"):
        dense.test(mt.get_model("gpt2_tiny", loss_chunk=16, device="cpu"),
                   loader)
    # A model whose loss_chunk is 0 keeps the criterion path.
    assert not dense._takes_targets


def test_loss_chunk_through_the_sharded_step_and_a_resume(tmp_path):
    """The labels go through the forward in the sharded 2-replica step
    (K4/K5's plain versions here) as in the fused one, and a run
    preempted at step 3 resumes bit for bit."""
    from ml_trainer_tpu_torch.resilience import faults

    sets = (mt.SyntheticTokens(size=32, seq_len=32, vocab_size=1024),
            mt.SyntheticTokens(size=16, seq_len=32, vocab_size=1024,
                               seed=1))

    def make(name, **kw):
        return mt.Trainer(
            mt.init_model("gpt2_tiny", seed=0, device="cpu", loss_chunk=8),
            datasets=sets, epochs=2, batch_size=8, optimizer="adam",
            lr=3e-4, grad_clip_norm=1.0, metric=None,
            model_dir=str(tmp_path / name), **kw)

    sharded = dict(is_parallel=True, device=["cpu"] * 2,
                   dp_update="sharded", save_every_steps=1)
    ref = make("ref", **sharded)
    ref.fit()
    assert ref.fused_adam and ref._takes_targets
    fused = make("fused", device="cpu")
    fused.fit()
    np.testing.assert_allclose(ref.history["train_loss"],
                               fused.history["train_loss"], rtol=1e-5)
    with faults.injected("preempt@step=3"):
        first = make("run", **sharded)
        first.fit()
    assert first.preempted
    resumed = make("run", **sharded)
    resumed.fit(resume=True)
    assert resumed.history == ref.history
    for name, w in ref.model.state_dict().items():
        assert resumed.model.state_dict()[name].equal(w), name

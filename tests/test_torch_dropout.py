"""Dropout in the port (``models/layers.py`` ``Dropout``/``DropoutStream``)
against the JAX package, and the port's mask stream, on the CPU.

Against JAX (gpt2_tiny, bert_tiny, vit_tiny at ``dropout_rate=0.1``,
float32): each flax ``nn.Dropout``'s output is recorded with
``flax.linen.intercept_methods`` during a train-mode forward, so its
mask is ``out != 0``; the masks go into the port in call order through
the stream's ``forced`` hook (the port numbers its sites in the same
order).  Then train-mode logits agree at rtol 1e-4 / atol 1e-5, the
loss (cross entropy against fixed labels) at rtol 1e-5, and the
gradients at atol 1e-5 + rtol 1e-4 (the families' bars,
``tests/test_torch_models.py``: float32 sums in another order).  Eval
mode with ``dropout_rate`` set is the dropout-free model at the same
bars, and in the port bitwise the ``dropout_rate=0`` model; so are
``generate()`` and the serving engine, whose decode cache turns dropout
off even in training mode.

Within the port: the hash is pinned (its first words for one key); the
same key gives the same mask and another step, site or seed another
one; the kept fraction is within 4 sigma of 0.9; the masks of a step do
not depend on ``grad_accum_steps``, the replicas or K (one step's
gradient, read as plain SGD's move at lr 1, within 3e-7 of the
single-microbatch step's: float sums in another order and the params'
rounding, where one wrong mask moves it by ~1e-2; K = 3 bitwise K = 1);
a fit preempted mid-epoch and resumed is
bitwise the uninterrupted one, ``ema_params`` included.
"""

import flax.linen as fnn
import jax
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import ml_trainer_tpu_torch as mt
from ml_trainer_tpu.models import get_model as jget_model
from ml_trainer_tpu_torch.models.layers import (
    DropoutStream,
    _mix32,
    dropout_stream,
)
from ml_trainer_tpu_torch.resilience import faults

RATE = 0.1
DEPTH = 1  # an embedding site and a block's two: every kind of site
TOL = dict(rtol=1e-4, atol=1e-5)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "vit_tiny":
        x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
        return x, rng.integers(0, 10, 2)
    x = rng.integers(1, 1024, (2, 16)).astype(np.int32)
    if name == "bert_tiny":
        return x, rng.integers(0, 2, 2)
    return x, rng.integers(0, 1024, (2, 16))


def _jax_loss(logits, y):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1)).mean()


@pytest.fixture(scope="module", params=["gpt2_tiny", "bert_tiny",
                                        "vit_tiny"])
def family(request):
    """The JAX model's train-mode logits, masks, loss and gradients and
    its eval logits, for one family (one jitted program), and the port
    model with its weights."""
    name = request.param
    x, y = _inputs(name)
    jm = jget_model(name, dropout_rate=RATE, depth=DEPTH)
    rngs = {"dropout": jax.random.PRNGKey(7)}

    def train_loss(params):
        masks = []

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.Dropout):
                masks.append(out != 0)
            return out

        with fnn.intercept_methods(record):
            logits = jm.apply({"params": params}, x, train=True, rngs=rngs)
        return _jax_loss(logits, y), (logits, masks)

    @jax.jit
    def run(key):
        v = jm.init({"params": key}, x, train=False)
        (loss, (logits, masks)), grads = jax.value_and_grad(
            train_loss, has_aux=True)(v["params"])
        return v, loss, logits, masks, grads, jm.apply(v, x, train=False)

    v, loss, logits, masks, grads, eval_logits = _host(
        run(jax.random.PRNGKey(0)))
    model = mt.get_model(name, dropout_rate=RATE, depth=DEPTH, device="cpu")
    model.load_state_dict(mt.params_from_jax(v))
    return dict(name=name, x=x, y=y, masks=masks, logits=logits,
                loss=float(loss), grads=mt.params_from_jax(grads),
                eval_logits=eval_logits, model=model,
                state=mt.params_from_jax(v))


def _port_loss(logits, y):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           torch.as_tensor(y).reshape(-1).long())


def test_port_numbers_one_site_per_jax_dropout(family):
    stream = dropout_stream(family["model"])
    assert len(family["masks"]) == stream.sites == 1 + 2 * DEPTH


def test_train_mode_matches_jax_with_injected_masks(family):
    model = family["model"].train()
    stream = dropout_stream(model)
    stream.forced = {i: torch.tensor(m)
                     for i, m in enumerate(family["masks"])}
    logits = model(torch.as_tensor(family["x"]))
    np.testing.assert_allclose(logits.detach().numpy(), family["logits"],
                               **TOL)
    loss = _port_loss(logits, family["y"])
    np.testing.assert_allclose(float(loss.detach()), family["loss"],
                               rtol=1e-5)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert set(names) == set(family["grads"])
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), family["grads"][k].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    stream.forced = {}


def test_eval_mode_matches_jax_and_the_dropout_free_model(family):
    model = family["model"].eval()
    x = torch.as_tensor(family["x"])
    with torch.no_grad():
        got = model(x)
        plain = mt.get_model(family["name"], depth=DEPTH, device="cpu")
        plain.load_state_dict(family["state"])
        want = plain.eval()(x)
    np.testing.assert_allclose(got.numpy(), family["eval_logits"], **TOL)
    assert torch.equal(got, want)


def test_decoding_never_drops():
    """generate() and the serving engine of a dropout model, left in
    training mode, give the dropout-free model's tokens: a decode cache
    turns dropout off."""
    kw = dict(max_len=64, device="cpu")
    dropped = mt.init_model("gpt2_tiny", dropout_rate=0.5, **kw).train()
    plain = mt.init_model("gpt2_tiny", **kw)
    prompts = np.arange(12).reshape(2, 6)
    assert np.array_equal(mt.generate(dropped, prompts, 5, device="cpu"),
                          mt.generate(plain, prompts, 5, device="cpu"))
    outs = []
    for model in (dropped, plain):
        with mt.Server(model, device="cpu") as server:
            outs.append(server.complete(np.arange(9), 4, timeout=60))
    assert np.array_equal(*outs)


# ------------------------------------------------------ the mask stream
def test_the_hash_is_pinned():
    # Fixed words: a change to the hash changes every mask of every run.
    got = [_mix32(v) for v in (0, 1, 2, 0xFFFFFFFF)]
    assert got == [0, 4293290225, 4291678691, 3846949589]
    words = _mix32(torch.arange(4, dtype=torch.int64))
    assert words.tolist() == [_mix32(v) for v in range(4)]


def test_same_key_same_mask_and_other_keys_differ():
    def mask(seed=5, step=3, site=1, row0=0, shape=(4, 8, 16)):
        s = DropoutStream(sites=3, seed=seed)
        s.row0 = row0
        s.begin_step(torch.tensor(step))
        return s.keep(site, shape, RATE, "cpu")

    a = mask()
    assert torch.equal(a, mask())
    for other in (mask(seed=6), mask(step=4), mask(site=2)):
        assert not torch.equal(a, other)
    # Rows 2-3 of a batch are the rows 0-1 of a microbatch at row0 = 2.
    assert torch.equal(a[2:], mask(row0=2, shape=(2, 8, 16)))


def test_kept_fraction_is_within_four_sigma():
    s = DropoutStream(sites=1, seed=32)
    s.begin_step(torch.tensor(11))
    n = 8 * 1024 * 96
    kept = float(s.keep(0, (8, 1024, 96), RATE, "cpu").float().mean())
    sigma = (RATE * (1 - RATE) / n) ** 0.5
    assert abs(kept - (1 - RATE)) < 4 * sigma


SEQ, VOCAB = 32, 256
FIT_KW = dict(epochs=1, batch_size=4, metric=None, optimizer="adamw",
              lr=1e-3, device="cpu")


def _sets():
    return (mt.SyntheticTokens(size=16, seq_len=SEQ, vocab_size=VOCAB),
            mt.SyntheticTokens(size=4, seq_len=SEQ, vocab_size=VOCAB, seed=1))


def _trainer(tmp_path, **kw):
    model = mt.init_model("gpt2_tiny", dropout_rate=RATE, max_len=SEQ,
                          vocab_size=VOCAB, embed_dim=64, device="cpu")
    return mt.Trainer(model, datasets=_sets(), model_dir=str(tmp_path),
                      **{**FIT_KW, **kw})


def _one_step(tr):
    """One step's gradient: plain SGD at lr 1 moves the params by it."""
    x, y = next(iter(tr.train_loader))
    before = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    tr._train_step(torch.as_tensor(x), torch.as_tensor(y), 1.0)
    return {k: before[k] - p.detach()
            for k, p in tr.model.named_parameters()}


@pytest.mark.parametrize("kw", [dict(grad_accum_steps=2),
                                dict(is_parallel=True, device=["cpu"] * 2),
                                dict(is_parallel=True, device=["cpu"] * 2,
                                     dp_update="sharded")],
                         ids=["accum", "replicas", "sharded"])
def test_masks_do_not_depend_on_the_split_of_the_batch(tmp_path, kw):
    sgd = dict(optimizer="sgd", momentum=0.0, lr=1.0)
    want = _one_step(_trainer(tmp_path / "a", **sgd))
    got = _one_step(_trainer(tmp_path / "b", **sgd, **kw))
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=3e-7, rtol=0,
                                   msg=k)


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    """The uninterrupted K = 1 fit with an EMA."""
    tr = _trainer(tmp_path_factory.mktemp("whole"), ema_decay=0.9)
    tr.fit()
    return tr


def _assert_same_state(a, b):
    assert a.history["train_loss"] == b.history["train_loss"]
    assert a.state.step == b.state.step
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
    for k, e in a.state.ema_params.items():
        assert torch.equal(e, b.state.ema_params[k]), k


def test_k_steps_are_bitwise_one_step(whole, tmp_path):
    k3 = _trainer(tmp_path, ema_decay=0.9, steps_per_execution=3)
    k3.fit()
    _assert_same_state(whole, k3)


def test_resumed_fit_is_bitwise_the_uninterrupted_one(whole, tmp_path):
    with faults.injected("preempt@step=3"):
        cut = _trainer(tmp_path, ema_decay=0.9)
        cut.fit()
    assert cut.preempted
    resumed = _trainer(tmp_path, ema_decay=0.9)
    resumed.fit(resume=True)
    assert resumed.state.step == 4
    _assert_same_state(whole, resumed)

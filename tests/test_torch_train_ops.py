"""Port parity: the training ops of ``ml_trainer_tpu_torch`` against the
JAX package's on the CPU.

* Each optimizer, with ``clip_by_global_norm(1.0)`` in front and the
  cosine-restart schedule, against its optax chain over 5 steps, with
  coupled and decoupled decay and the bias/norm mask: params within
  rtol 1e-6 (atol 1e-8 for entries near zero), float32 both sides.
* Every schedule against ``make_lr_schedule`` over 3 epochs of steps:
  rtol 1e-6 (both compute in float32).
* Losses, metrics and predictions on random logits: rtol 1e-5 (float32
  reductions in another order); integer-valued results exactly.
Inputs are made with numpy from a seed and cross as numpy arrays.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

jopt = importlib.import_module("ml_trainer_tpu.ops.optimizers")
jsch = importlib.import_module("ml_trainer_tpu.ops.schedules")
jloss = importlib.import_module("ml_trainer_tpu.ops.losses")
jmet = importlib.import_module("ml_trainer_tpu.ops.metrics")
jpred = importlib.import_module("ml_trainer_tpu.ops.predictions")
topt = importlib.import_module("ml_trainer_tpu_torch.ops.optimizers")
tsch = importlib.import_module("ml_trainer_tpu_torch.ops.schedules")
tloss = importlib.import_module("ml_trainer_tpu_torch.ops.losses")
tmet = importlib.import_module("ml_trainer_tpu_torch.ops.metrics")
tpred = importlib.import_module("ml_trainer_tpu_torch.ops.predictions")

SHAPES = {"a.weight": (4, 3), "a.bias": (3,), "ln.scale": (5,),
          "emb": (2, 4, 3)}


@pytest.mark.parametrize("name", ["sgd", "adam", "adagrad", "adamax",
                                  "adamw"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("masked", [False, True])
def test_optimizer_matches_optax_chain(name, weight_decay, masked):
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (3 * rng.normal(size=s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(5)]
    j_tx = optax.chain(optax.clip_by_global_norm(1.0), jopt.get_optimizer(
        name, jsch.make_lr_schedule("CosineAnnealingWarmRestarts", 1e-2, 2),
        0.9, weight_decay,
        decay_mask=jopt.decay_mask_matrices_only if masked else None))
    t_tx = topt.chain(topt.clip_by_global_norm(1.0), topt.get_optimizer(
        name, tsch.make_lr_schedule("CosineAnnealingWarmRestarts", 1e-2, 2),
        0.9, weight_decay,
        decay_mask=topt.decay_mask_matrices_only if masked else None))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    j_state, t_state = j_tx.init(jp), t_tx.init(tp)
    for g in grads:
        u, j_state = j_tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 j_state, jp)
        jp = optax.apply_updates(jp, u)
        u, t_state = t_tx.update({k: torch.tensor(v) for k, v in g.items()},
                                 t_state, tp)
        tp = topt.apply_updates(tp, u)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-8, err_msg=k)


def test_optimizer_update_leaves_the_old_state_alone():
    """The functional contract the non-finite guard relies on."""
    p = {"w": torch.ones(3)}
    tx = topt.get_optimizer("adam", 0.1)
    state = tx.init(p)
    before = topt.tree_map(torch.clone, state)
    _, new = tx.update({"w": torch.ones(3)}, state, p)
    topt.tree_map(lambda a, b: torch.testing.assert_close(a, b), state,
                  before)
    assert int(new[0]["count"]) == 1 and int(state[0]["count"]) == 0


@pytest.mark.parametrize("name", ["lamb", "lion", "adafactor"])
def test_unported_optimizers_name_the_roadmap(name):
    """The three names the port once refused (naming ROADMAP.md) are
    ported: each builds, takes a step that moves every leaf, and is one
    of the names an unknown optimizer's error lists
    (``test_torch_optimizers.py`` holds them to optax)."""
    tx = topt.get_optimizer(name, 1e-3)
    params = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
    grads = {k: torch.full_like(p, 0.5) for k, p in params.items()}
    updates, _ = tx.update(grads, tx.init(params), params)
    assert all(bool(torch.isfinite(u).all()) and bool((u != 0).all())
               for u in updates.values())
    with pytest.raises(ValueError, match=f"'{name}'"):
        topt.get_optimizer("rmsprop", 1e-3)


def test_unknown_optimizer_raises_value_error():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        topt.get_optimizer("rmsprop", 1e-3)


@pytest.mark.parametrize("name", [None, *jsch.SCHEDULERS])
@pytest.mark.parametrize("total_steps", [None, 30])
def test_schedule_matches_make_lr_schedule(name, total_steps):
    steps_per_epoch = 10
    want = jsch.make_lr_schedule(name, 3e-4, steps_per_epoch, total_steps)
    got = tsch.make_lr_schedule(name, 3e-4, steps_per_epoch, total_steps)
    for step in range(3 * steps_per_epoch):
        np.testing.assert_allclose(
            float(got(torch.tensor(step, dtype=torch.int32))),
            float(want(jnp.asarray(step, jnp.int32))), rtol=1e-6,
            err_msg=f"step {step}")
        np.testing.assert_allclose(float(got(step)),
                                   float(want(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="Unknown scheduler"):
        tsch.make_lr_schedule("OneCycle", 1e-3, 10)


def test_plateau_controller_matches():
    vals = [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95,
            0.95, 0.95, 0.95, 0.8, 0.85] + [0.85] * 24
    j = jsch.PlateauController(1e-3, patience=2)
    t = tsch.PlateauController(1e-3, patience=2)
    assert [t.update(v) for v in vals] == [j.update(v) for v in vals]


def _logits(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32)


def _labels(seed, shape, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, size=shape).astype(np.int32)


@pytest.mark.parametrize("shape", [(16, 10), (4, 8, 50)])
@pytest.mark.parametrize("name,smoothing", [
    ("cross_entropy", 0.0), ("cross_entropy", 0.1), ("cross_entropy", 1.0),
    ("neg-loss", 0.0),
])
def test_classification_losses_match(shape, name, smoothing):
    x = _logits(1, shape)
    if name == "neg-loss":
        x = np.asarray(jnp.asarray(x) - jnp.log(jnp.sum(
            jnp.exp(jnp.asarray(x)), -1, keepdims=True)))
    y = _labels(2, shape[:-1], shape[-1])
    want = jloss.get_criterion(name, smoothing)(jnp.asarray(x),
                                                jnp.asarray(y))
    got = tloss.get_criterion(name, smoothing)(torch.tensor(x),
                                               torch.tensor(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("name", ["l1", "l2", "custom"])
def test_regression_losses_match(name):
    x, y = _logits(3, (8, 3)), _logits(4, (8, 3))
    want = jloss.get_criterion(name)(jnp.asarray(x), jnp.asarray(y))
    got = tloss.get_criterion(name)(torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_loss_factory_errors_match_the_reference():
    with pytest.raises(ValueError, match="Unknown criterion"):
        tloss.get_criterion("hinge")
    with pytest.raises(ValueError, match="label_smoothing only applies"):
        tloss.get_criterion("l2", 0.1)
    # The chunked LM loss: S must divide by the chunk, as in the JAX
    # package; a GPT-2 without loss_chunk refuses targets.
    with pytest.raises(ValueError, match="not divisible by chunk_size 128"):
        tloss.chunked_lm_cross_entropy(torch.zeros(1, 100, 4),
                                       torch.zeros(8, 4),
                                       torch.zeros(1, 100, dtype=torch.long))
    mt = importlib.import_module("ml_trainer_tpu_torch")
    assert mt.get_model("gpt2_tiny", loss_chunk=128,
                        device="cpu").loss_chunk == 128
    with pytest.raises(ValueError, match="targets requires loss_chunk > 0"):
        mt.get_model("gpt2_tiny", device="cpu")(
            torch.zeros(1, 8, dtype=torch.long),
            targets=torch.zeros(1, 8, dtype=torch.long))


@pytest.mark.parametrize("metric", ["accuracy", "top5_accuracy", "f1",
                                    "perplexity"])
@pytest.mark.parametrize("pred", ["softmax", "logsoftmax", None])
def test_classification_metrics_match(metric, pred):
    n_cls = 2 if metric == "f1" else 12
    shape = (6, 5, n_cls) if metric == "perplexity" else (32, n_cls)
    x = _logits(5, shape)
    y = _labels(6, shape[:-1], n_cls)
    # Plant exact hits so the metric is not trivially 0.
    flat_x, flat_y = x.reshape(-1, n_cls), y.reshape(-1)
    flat_y[::3] = np.argmax(flat_x[::3], -1)
    y = flat_y.reshape(shape[:-1])
    j_fn = jmet.get_metric(metric, jpred.get_prediction_function(pred))
    t_fn = tmet.get_metric(metric, tpred.get_prediction_function(pred))
    want = float(j_fn(jnp.asarray(x), jnp.asarray(y)))
    got = float(t_fn(torch.tensor(x), torch.tensor(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if metric == "perplexity":
        np.testing.assert_allclose(float(t_fn.finalize(torch.tensor(got))),
                                   float(j_fn.finalize(want)), rtol=1e-5)
    else:
        assert getattr(t_fn, "finalize", None) is None


def test_f1_without_positives_is_zero():
    x = np.zeros((4, 2), np.float32)
    x[:, 0] = 1.0
    y = np.zeros(4, np.int32)
    fn = tmet.get_metric("f1")
    assert float(fn(torch.tensor(x), torch.tensor(y))) == 0.0


def test_mcrmse_matches():
    x, y = _logits(7, (16, 3)), _logits(8, (16, 3))
    want = jmet.get_metric("mcrmse")(jnp.asarray(x), jnp.asarray(y))
    got = tmet.get_metric("mcrmse")(torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("pred", ["softmax", "logsoftmax", None])
def test_predictions_match(pred):
    x = _logits(9, (16, 7))
    want = jpred.get_predictions(jnp.asarray(x),
                                 jpred.get_prediction_function(pred))
    got = tpred.get_predictions(torch.tensor(x),
                                tpred.get_prediction_function(pred))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fn = tpred.get_prediction_function(pred)
    if fn is not None:
        np.testing.assert_allclose(
            fn(torch.tensor(x)).numpy(),
            np.asarray(jpred.get_prediction_function(pred)(jnp.asarray(x))),
            rtol=1e-5, atol=1e-6)


def test_unknown_metric_raises():
    assert tmet.get_metric(None) is None
    with pytest.raises(ValueError, match="Unknown metric"):
        tmet.get_metric("bleu")

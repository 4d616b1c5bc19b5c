"""Port parity: ``ml_trainer_tpu_torch.Trainer`` against the JAX
package's ``Trainer`` on the CPU.

The GPT-2 run: ``gpt2_tiny`` (2 layers, 128 wide, 4 heads, vocab 1024)
at seq 128, global batch 8 in 2 microbatches, adamw (lr 3e-4, wd 0.01),
cosine restarts, clip 1.0, 2 epochs of 4 steps, with the JAX trainer's
initial params injected into the port through ``params_from_jax``.  The
port's model runs ``attention_impl="flash"`` (its autograd Function,
through the padding wrapper at head_dim 32); the JAX model runs its
plain path, which is what the JAX package picks off a TPU.

Tolerances:

* per-epoch train/val loss and metric: rtol 1e-4 (float32 throughout;
  observed ~1e-7);
* final params: atol 1e-4, except the attention's key bias at 1e-3.
  Softmax ignores a per-row shift, so the key bias's gradient is zero
  up to rounding in both packages, and Adam's normalised update turns
  that rounding noise into a step of up to ~lr in either direction: 8
  steps at lr <= 3e-4 allow a few 1e-4 of drift there (observed ~1e-4).
  Every other parameter follows a real gradient (observed < 3e-5).

The guard run: a small MLP (flax ``Dense``/``relu`` against
``nn.Linear``/``ReLU`` with the same weights) on float features with one
NaN sample, so the batch that holds it is skipped by both trainers:
losses rtol 1e-5, skipped-step counts and Adam's step count equal,
params atol 1e-5.
"""

import logging

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from torch import nn

import ml_trainer_tpu as J
import ml_trainer_tpu_torch as mt
from ml_trainer_tpu.data import ArrayDataset as JArray
from ml_trainer_tpu.data import SyntheticTokens as JTokens
from ml_trainer_tpu.models import get_model as jget_model
from ml_trainer_tpu_torch.data import ArrayDataset as TArray

GPT_KW = dict(epochs=2, batch_size=8, grad_accum_steps=2, optimizer="adamw",
              lr=3e-4, weight_decay=0.01,
              scheduler="CosineAnnealingWarmRestarts", grad_clip_norm=1.0)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def gpt_runs(tmp_path_factory):
    seq, vocab = 128, 1024
    j_sets = (JTokens(size=32, seq_len=seq, vocab_size=vocab),
              JTokens(size=16, seq_len=seq, vocab_size=vocab, seed=1))
    t_sets = (mt.SyntheticTokens(size=32, seq_len=seq, vocab_size=vocab),
              mt.SyntheticTokens(size=16, seq_len=seq, vocab_size=vocab,
                                 seed=1))
    j_dir = str(tmp_path_factory.mktemp("jax_run"))
    t_dir = str(tmp_path_factory.mktemp("port_run"))
    jtr = J.Trainer(jget_model("gpt2_tiny"), datasets=j_sets, backend="cpu",
                    loader="python", model_dir=j_dir, **GPT_KW)
    model = mt.get_model("gpt2_tiny", device="cpu", attention_impl="flash")
    model.load_state_dict(mt.params_from_jax(_host(jtr.state.params)))
    ttr = mt.Trainer(model, datasets=t_sets, device="cpu", model_dir=t_dir,
                     save_history=True, **GPT_KW)
    jtr.fit()
    ttr.fit()
    return jtr, ttr, t_dir


@pytest.mark.parametrize("key", ["train_loss", "val_loss", "train_metric",
                                 "val_metric"])
def test_gpt2_epoch_history_matches_jax(gpt_runs, key):
    jtr, ttr, _ = gpt_runs
    assert len(ttr.history[key]) == 2
    np.testing.assert_allclose(ttr.history[key], jtr.history[key],
                               rtol=1e-4, atol=1e-7)


def test_gpt2_history_keys_and_counters_match(gpt_runs):
    jtr, ttr, _ = gpt_runs
    assert set(ttr.history) == set(jtr.history)
    for key in ("epochs", "metric_type", "skipped_steps", "rollbacks",
                "reshapes"):
        assert ttr.history[key] == jtr.history[key], key
    assert ttr.state.step == int(jtr.state.step) == 8


def test_gpt2_final_params_match_jax(gpt_runs):
    jtr, ttr, _ = gpt_runs
    want = mt.params_from_jax(_host(jtr.state.params))
    got = ttr.model.state_dict()
    assert set(want) == set(got)
    e = 128  # embed dim: the key bias is qkv.bias[e:2e]
    for name, w in want.items():
        g = got[name]
        if name.endswith("attn.qkv.bias"):
            torch.testing.assert_close(g[e:2 * e], w[e:2 * e], atol=1e-3,
                                       rtol=0, msg=name)
            g = torch.cat([g[:e], g[2 * e:]])
            w = torch.cat([w[:e], w[2 * e:]])
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0, msg=name)


def test_gpt2_trainer_went_through_the_flash_function(gpt_runs):
    _, ttr, _ = gpt_runs
    x = torch.zeros(1, 128, dtype=torch.long)
    out = ttr.model(x)
    seen, stack = set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    names = {type(fn).__name__ for fn in seen}
    assert "_FlashAttentionBackward" in names


def test_save_load_and_history_round_trip(gpt_runs):
    _, ttr, t_dir = gpt_runs
    history = mt.load_history(t_dir)
    assert history["train_loss"] == ttr.history["train_loss"]
    assert history["skipped_steps"] == [0, 0]
    fresh = mt.get_model("gpt2_tiny", device="cpu")
    loaded = mt.load_model(fresh, t_dir)
    for name, p in ttr.model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict[name], p, atol=0, rtol=0)
    want = ttr.test(None, ttr.val_loader)
    assert ttr.test(loaded, ttr.val_loader) == want
    assert ttr.test(loaded.state_dict, ttr.val_loader) == want
    # A testing-only trainer scores the loaded model the same way.
    tester = mt.Trainer(mt.get_model("gpt2_tiny", device="cpu"),
                        device="cpu")
    assert tester.test(loaded, ttr.val_loader) == want
    logits = loaded(torch.zeros(1, 4, dtype=torch.long))
    assert logits.shape == (1, 4, 1024)


class _JaxMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        hidden = fnn.relu(fnn.Dense(8)(x))  # Dense_0
        return fnn.Dense(2)(hidden)  # Dense_1


def _port_mlp(params) -> nn.Module:
    model = nn.Sequential(nn.Linear(5, 8), nn.ReLU(), nn.Linear(8, 2))
    with torch.no_grad():
        for layer, name in ((model[0], "Dense_0"), (model[2], "Dense_1")):
            layer.weight.copy_(torch.tensor(params[name]["kernel"]).T)
            layer.bias.copy_(torch.tensor(params[name]["bias"]))
    return model


def test_poisoned_batch_is_skipped_alike(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(24, 5)).astype(np.float32)
    y = rng.normal(size=(24, 2)).astype(np.float32)
    x[7, 2] = np.nan  # one poisoned sample: its batch is skipped
    xv = rng.normal(size=(8, 5)).astype(np.float32)
    yv = rng.normal(size=(8, 2)).astype(np.float32)
    kw = dict(epochs=2, batch_size=4, optimizer="adam", lr=1e-2,
              criterion="l2", metric="mcrmse", pred_function=None,
              grad_clip_norm=5.0)
    jtr = J.Trainer(_JaxMLP(), datasets=(JArray(x, y), JArray(xv, yv)),
                    backend="cpu", loader="python",
                    model_dir=str(tmp_path / "j"), **kw)
    ttr = mt.Trainer(_port_mlp(_host(jtr.state.params)),
                     datasets=(TArray(x, y), TArray(xv, yv)), device="cpu",
                     model_dir=str(tmp_path / "t"), **kw)
    jtr.fit()
    ttr.fit()
    assert jtr.history["skipped_steps"] == [1, 1]
    assert ttr.history["skipped_steps"] == [1, 1]
    for key in ("train_loss", "val_loss", "train_metric", "val_metric"):
        np.testing.assert_allclose(ttr.history[key], jtr.history[key],
                                   rtol=1e-5, err_msg=key)
    # Only `step` advanced over the skipped batches; Adam's count and the
    # schedule's count stayed behind with the params.
    assert ttr.state.step == int(jtr.state.step) == 12
    adam_t, lr_t = ttr.state.opt_state[1][0], ttr.state.opt_state[1][1]
    assert int(adam_t["count"]) == int(lr_t["count"]) == 10
    assert int(jtr.state.opt_state[1][0].count) == 10
    assert np.all(np.isfinite([p.detach().numpy()
                               for p in ttr.model.parameters()][0]))
    jp = _host(jtr.state.params)
    torch.testing.assert_close(
        ttr.model[0].weight, torch.tensor(jp["Dense_0"]["kernel"]).T,
        atol=1e-5, rtol=0)
    torch.testing.assert_close(
        ttr.model[2].bias, torch.tensor(jp["Dense_1"]["bias"]),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("knob,value", [
    ("mesh_shape", {"expert": 2}), ("mesh_shape", {"data": 1, "tensor": 2}),
    ("sharding_rules", [("x", None)]),
    ("mesh_shape", {"fsdp": 2}), ("mesh_shape", {"tensor": 2}),
    ("telemetry", True), ("elastic", 2), ("pipeline_schedule", "gpipe"),
    ("pipeline_schedule", "1f1b"), ("mesh_shape", {"sequence": 2}),
    ("mesh_shape", {"stage": 2}), ("sharded_checkpoint", True),
])
def test_unported_knobs_name_the_roadmap(knob, value):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        mt.Trainer("gpt2_tiny", device="cpu", **{knob: value})


def test_inert_knobs_log_one_warning_per_process(monkeypatch, caplog):
    """A set ``desync_every_steps`` is accepted and ignored: the first
    Trainer of a process that sets it logs one warning naming it and
    ROADMAP.md; later ones log nothing.  ``handle_preemption=True`` (the
    default) installs real signal handlers now and is not named."""
    import ml_trainer_tpu_torch.trainer as trainer_mod

    name = "ml_trainer_tpu_torch.trainer"
    monkeypatch.setattr(trainer_mod, "_INERT_WARNED", False)
    with caplog.at_level(logging.WARNING, logger=name):
        mt.Trainer("gpt2_tiny", device="cpu", handle_preemption=True)
        assert not [r for r in caplog.records if "no effect" in r.message]
        mt.Trainer("gpt2_tiny", device="cpu", desync_every_steps=5,
                   straggler_factor=3.0, moe_aux_weight=0.5)
        mt.Trainer("gpt2_tiny", device="cpu", desync_every_steps=5)
    warned = [r for r in caplog.records if "no effect" in r.message]
    assert len(warned) == 1 and warned[0].name == name
    msg = warned[0].message
    assert "desync_every_steps=5" in msg and "ROADMAP.md" in msg
    assert "handle_preemption" not in msg
    assert "straggler_factor" not in msg and "moe_aux_weight" not in msg


def test_resume_and_unported_optimizer_name_the_roadmap(tmp_path):
    """``fit(resume=True)`` with no checkpoint trains from epoch 1; a
    sharded (format 3) checkpoint of the JAX package is refused with an
    error naming ROADMAP.md, and left in place."""
    import json

    sets = (mt.SyntheticTokens(size=8, seq_len=16, vocab_size=64),
            mt.SyntheticTokens(size=8, seq_len=16, vocab_size=64, seed=1))
    model = mt.get_model("gpt2_tiny", vocab_size=64, max_len=16,
                         device="cpu")
    tr = mt.Trainer(model, datasets=sets, epochs=1, batch_size=4,
                    device="cpu", model_dir=str(tmp_path / "fresh"))
    tr.fit(resume=True)
    assert tr.history["epochs"] == [1]
    sharded = tmp_path / "v3" / "checkpoints" / "checkpoint_1"
    sharded.mkdir(parents=True)
    (sharded / "manifest.json").write_text(json.dumps(
        {"format": 3, "epoch": 1, "history": {}}))
    tr = mt.Trainer(model, datasets=sets, epochs=2, batch_size=4,
                    device="cpu", model_dir=str(tmp_path / "v3"))
    with pytest.raises(ValueError, match="ROADMAP.md"):
        tr.fit(resume=True)
    assert (sharded / "manifest.json").exists()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        mt.Trainer(model, datasets=sets, epochs=1, batch_size=4,
                   device="cpu", optimizer="lion")


def test_config_surface_matches_the_reference():
    with pytest.raises(TypeError) as err:
        mt.Trainer("gpt2_tiny", device="cpu", learning_rate=0.1)
    assert err.value.args == ("Keyword argument not understood:",
                              "learning_rate")
    tr = mt.Trainer("gpt2_tiny", backend="gloo")
    assert tr.device.type == "cpu"
    with pytest.raises(ValueError, match="runs on the CPU"):
        mt.Trainer("gpt2_tiny", backend="cpu", device="cuda")
    with pytest.raises(TypeError):
        tr.validate_kwargs({"bogus": 1}, {"lr"})
    assert tr.state is None and tr.lr == 0.001 and tr.metric == "accuracy"


def test_early_stop_and_save_best(tmp_path):
    sets = (mt.SyntheticTokens(size=8, seq_len=16, vocab_size=64),
            mt.SyntheticTokens(size=8, seq_len=16, vocab_size=64, seed=1))
    model = mt.get_model("gpt2_tiny", vocab_size=64, max_len=16,
                         device="cpu")
    # lr 0 never improves after the first epoch: patience 1 stops at 2.
    tr = mt.Trainer(model, datasets=sets, epochs=5, batch_size=4,
                    device="cpu", lr=0.0, early_stop_patience=1,
                    save_best=True, model_dir=str(tmp_path))
    tr.fit()
    assert tr.history["epochs"] == [1, 2]
    assert (tmp_path / "model.pth").exists()
    assert (tmp_path / "best" / "model.pth").exists()

"""``Trainer(ema_decay=...)`` and ``Trainer.predict`` in the port against
the JAX package's, on the CPU.

Against JAX: a 5 -> 8 -> 2 MLP classifier (flax ``Dense_0``/``Dense_1``,
the port's modules of the same names with the JAX trainer's initial
weights) trains an epoch of 6 steps with SGD momentum, ``ema_decay=0.9``
and one poisoned sample, whose batch both trainers skip.  The EMA, the
params and the history (validation on the EMA weights) agree at rtol
1e-5 / atol 1e-6 (float32 sums in another order); ``predict()`` (the
EMA weights, softmax or raw) at the same bar.  A JAX checkpoint with
``ema_params`` reads into the port, and a port checkpoint with them
passes the JAX package's ``verify_checkpoint`` with the leaves in its
manifest.

Within the port: the EMA is ``d e + (1 - d) p`` after every update
against a float64 recompute from the recorded params (atol 1e-6); a
skipped step keeps it, on the fused and the sharded step; eval,
``test()``, ``predict()`` and ``model.pth`` use it; 2 sharded replicas
keep it within 1e-6 of one card's; and the toggles across a resume
(``tests/test_trainer.py``): off -> on seeds it from the restored
params, on -> off drops it, a checkpoint without it resumes.
"""

import json
import os

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from torch import nn

import ml_trainer_tpu as J
import ml_trainer_tpu_torch as mt
from ml_trainer_tpu.checkpoint import checkpoint as jckpt
from ml_trainer_tpu.data import ArrayDataset as JArray
from ml_trainer_tpu_torch.checkpoint import checkpoint as ckpt
from ml_trainer_tpu_torch.data import ArrayDataset as TArray
from ml_trainer_tpu_torch.train_state import load_state_tree

TOL = dict(rtol=1e-5, atol=1e-6)
KW = dict(epochs=1, batch_size=4, optimizer="sgd", momentum=0.9, lr=0.05,
          criterion="cross_entropy", metric="accuracy",
          pred_function="softmax", ema_decay=0.9)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


class _JaxMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        hidden = fnn.relu(fnn.Dense(8)(x))  # Dense_0
        return fnn.Dense(2)(hidden)  # Dense_1


class _PortMLP(nn.Module):
    """The flax names ``Dense_0``/``Dense_1`` as module names."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(5, 8)
        self.Dense_1 = nn.Linear(8, 2)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def _data(poison=True):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(24, 5)).astype(np.float32)
    y = rng.integers(0, 2, 24).astype(np.int32)
    if poison:
        x[9, 1] = np.nan  # its batch is skipped
    xv = rng.normal(size=(8, 5)).astype(np.float32)
    yv = rng.integers(0, 2, 8).astype(np.int32)
    return x, y, xv, yv


def _port_trainer(model_dir, model=None, poison=False, **kw):
    x, y, xv, yv = _data(poison)
    if model is None:
        model = _PortMLP()
        with torch.no_grad():
            gen = torch.Generator().manual_seed(0)
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return mt.Trainer(model, datasets=(TArray(x, y), TArray(xv, yv)),
                      model_dir=str(model_dir),
                      **{"device": "cpu", **KW, **kw})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    x, y, xv, yv = _data()
    jdir = tmp_path_factory.mktemp("jax")
    jtr = J.Trainer(_JaxMLP(), datasets=(JArray(x, y), JArray(xv, yv)),
                    backend="cpu", loader="python", model_dir=str(jdir),
                    **KW)
    model = _PortMLP()
    model.load_state_dict(mt.params_from_jax(_host(jtr.state.params)))
    ttr = _port_trainer(tmp_path_factory.mktemp("port"), model, poison=True)
    jtr.fit()
    ttr.fit()
    return jtr, ttr, jdir


def test_ema_and_history_match_jax(runs):
    jtr, ttr, _ = runs
    assert jtr.history["skipped_steps"] == ttr.history["skipped_steps"]
    assert ttr.history["skipped_steps"] == [1]
    want = mt.params_from_jax(_host(jtr.state.ema_params))
    assert set(want) == set(ttr.state.ema_params)
    for k, w in want.items():
        np.testing.assert_allclose(ttr.state.ema_params[k].numpy(),
                                   w.numpy(), err_msg=k, **TOL)
    for k, p in ttr.model.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(),
            mt.params_from_jax(_host(jtr.state.params))[k].numpy(),
            err_msg=k, **TOL)
    for key in ("train_loss", "val_loss", "train_metric", "val_metric"):
        np.testing.assert_allclose(ttr.history[key], jtr.history[key],
                                   rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("apply_pred", [True, False])
def test_predict_matches_jax(runs, apply_pred):
    jtr, ttr, _ = runs
    _, _, xv, yv = _data()
    batches = [(xv[:4], yv[:4]), (xv[4:], yv[4:])]
    want = jtr.predict(batches, apply_pred_function=apply_pred)
    got = ttr.predict(batches, apply_pred_function=apply_pred)
    assert got.shape == want.shape == (8, 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_predict_takes_bare_batches_and_serves_the_ema(runs):
    _, ttr, _ = runs
    _, _, xv, yv = _data()
    bare = ttr.predict([xv[:4], xv[4:]])
    assert np.array_equal(bare, ttr.predict([(xv[:4], yv[:4]),
                                             (xv[4:], yv[4:])]))
    copy = _PortMLP()
    copy.load_state_dict(ttr.state.ema_params)
    np.testing.assert_array_equal(
        ttr.predict([xv[:4], xv[4:]], model=copy), bare)
    copy.load_state_dict(dict(ttr.model.named_parameters()))
    assert not np.array_equal(ttr.predict([xv[:4], xv[4:]], model=copy),
                              bare)


def test_predict_refuses_a_model_that_computes_its_own_loss(tmp_path):
    tr = mt.Trainer(mt.init_model("gpt2_tiny", loss_chunk=8, max_len=16,
                                  device="cpu"), device="cpu",
                    metric=None, model_dir=str(tmp_path))
    with pytest.raises(ValueError, match="own loss"):
        tr.predict([np.zeros((1, 16), np.int32)])


def test_a_jax_checkpoint_with_ema_reads_into_the_port(runs, tmp_path):
    jtr, ttr, jdir = runs
    path = jckpt.latest_checkpoint(os.path.join(str(jdir), "checkpoints"))
    ckpt.verify_checkpoint(path)
    tree = ckpt.restore_checkpoint(path)[0]
    want = _host(jtr.state.ema_params)
    np.testing.assert_array_equal(tree["ema_params"]["Dense_0"]["kernel"],
                                  want["Dense_0"]["kernel"])
    fresh = _port_trainer(tmp_path)
    load_state_tree(fresh.state, fresh.model,
                    mt.state_from_jax(jax.device_get(jtr.state)))
    for k, w in mt.params_from_jax(want).items():
        assert torch.equal(fresh.state.ema_params[k], w), k


def test_a_port_checkpoint_with_ema_passes_the_jax_verifier(runs):
    _, ttr, _ = runs
    path = ckpt.latest_valid_checkpoint(os.path.join(ttr.model_dir,
                                                     "checkpoints"))
    jckpt.verify_checkpoint(path)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    ema = [leaf["path"] for leaf in manifest["leaves"]
           if leaf["path"][0] == "ema_params"]
    assert sorted(p[1] for p in ema) == sorted(ttr.state.ema_params)


# ------------------------------------------------------- within the port
def test_ema_tracks_a_float64_recompute_and_drives_eval(tmp_path):
    d = KW["ema_decay"]
    tr = _port_trainer(tmp_path)
    ema = {k: p.detach().double().clone()
           for k, p in tr.model.named_parameters()}
    for x, y in tr.train_loader:
        tr._train_step(torch.as_tensor(x), torch.as_tensor(y), 1.0)
        ema = {k: d * e + (1 - d) * dict(tr.model.named_parameters())[k]
               .detach().double() for k, e in ema.items()}
    for k, e in ema.items():
        np.testing.assert_allclose(tr.state.ema_params[k].numpy(),
                                   e.numpy(), atol=1e-6, rtol=0, err_msg=k)
    copy = _PortMLP()
    copy.load_state_dict(tr.state.ema_params)
    assert tr.test(None, tr.val_loader) == tr.test(copy, tr.val_loader)
    tr.save_model(str(tmp_path / "saved"))
    saved = torch.load(tmp_path / "saved" / "model.pth")
    for k, e in tr.state.ema_params.items():
        assert torch.equal(saved[k], e), k
    assert not torch.equal(saved["Dense_0.weight"], tr.model.Dense_0.weight)


@pytest.mark.parametrize("kw", [{}, dict(is_parallel=True,
                                         device=["cpu"] * 2,
                                         dp_update="sharded")],
                         ids=["fused", "sharded"])
def test_a_skipped_step_keeps_the_ema(tmp_path, kw):
    tr = _port_trainer(tmp_path, **kw)
    batches = [(torch.as_tensor(x), torch.as_tensor(y))
               for x, y in tr.train_loader][:2]
    tr._train_step(*batches[0], 1.0)
    before = {k: e.clone() for k, e in tr.state.ema_params.items()}
    x, y = batches[1]
    tr._train_step(x * float("nan"), y, 1.0)
    assert int(tr.state.skipped_steps) == 1
    for k, e in tr.state.ema_params.items():
        assert torch.equal(e, before[k]), k


def test_sharded_replicas_keep_one_cards_ema(tmp_path):
    one = _port_trainer(tmp_path / "one", optimizer="adam", lr=1e-3)
    two = _port_trainer(tmp_path / "two", optimizer="adam", lr=1e-3,
                        is_parallel=True, device=["cpu"] * 2,
                        dp_update="sharded")
    one.fit()
    two.fit()
    assert two.fused_adam
    for k, e in one.state.ema_params.items():
        torch.testing.assert_close(two.state.ema_params[k], e, atol=1e-6,
                                   rtol=0, msg=k)


def test_ema_toggles_across_resume(tmp_path):
    _port_trainer(tmp_path, epochs=1, ema_decay=None).fit()
    seeded = _port_trainer(tmp_path, epochs=1)
    seeded.fit(resume=True)  # nothing left to train: the restore alone
    for k, p in seeded.model.named_parameters():
        assert torch.equal(seeded.state.ema_params[k], p), k
    on = _port_trainer(tmp_path, epochs=2)
    on.fit(resume=True)  # seeded from the restored params, then trained
    assert on.history["epochs"] == [1, 2]
    off = _port_trainer(tmp_path, epochs=2, ema_decay=None)
    off.fit(resume=True)  # the saved EMA is dropped
    assert off.state.ema_params is None
    assert off.history["epochs"] == [1, 2]


def test_a_checkpoint_without_ema_leaves_still_resumes(tmp_path):
    _port_trainer(tmp_path, epochs=1).fit()
    path = ckpt.latest_valid_checkpoint(str(tmp_path / "checkpoints"))
    manifest_path = os.path.join(path, "manifest.json")
    manifest = json.load(open(manifest_path))
    pruned = [leaf for leaf in manifest["leaves"]
              if leaf["path"][0] != "ema_params"]
    assert len(pruned) < len(manifest["leaves"])
    manifest["leaves"] = pruned
    with open(manifest_path, "w") as fp:
        json.dump(manifest, fp)
    resumed = _port_trainer(tmp_path, epochs=1)
    resumed.fit(resume=True)
    assert resumed.history["epochs"] == [1]
    for k, p in resumed.model.named_parameters():
        assert torch.equal(resumed.state.ema_params[k], p), k


def test_ema_decay_out_of_range_is_refused(tmp_path):
    for bad in (0.0, 1.0, 1.5):
        with pytest.raises(ValueError, match="ema_decay"):
            _port_trainer(tmp_path, ema_decay=bad)

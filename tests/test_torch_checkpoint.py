"""Full-state checkpoints of the port (``ml_trainer_tpu_torch.checkpoint``)
and its fault plans (``resilience/faults.py``), on the CPU.

* A ``gpt2_tiny`` adamw state with bf16 loss scaling, written by a fit,
  reads back bit for bit, every leaf file with ``allow_pickle=False``,
  and loads into a fresh trainer's tensors bit for bit.
* Format parity with the JAX package's format v2: its
  ``verify_checkpoint`` and ``latest_valid_checkpoint`` accept a port
  directory and reject it once a leaf is truncated; the port's accepts
  a JAX directory; both manifests carry the same keys.
* ``ckpt_truncate``: quarantine and fallback; a CRC mismatch raises on
  restore.  ``block=False`` copies to the host before it returns.  A
  prune with an uncommitted directory keeps the newest committed one.
* ``state_from_jax``: the JAX ``TrainState`` of each of the five
  optimizers (with and without coupled decay) carried into the port's
  tree, the moments in the port's layout.
* The fault plan's parser, and the kinds it refuses.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ml_trainer_tpu_torch as mt
from ml_trainer_tpu import checkpoint as jckpt
from ml_trainer_tpu.ops import get_optimizer as jget_optimizer
from ml_trainer_tpu.train_state import TrainState as JTrainState
from ml_trainer_tpu_torch import checkpoint as ckpt
from ml_trainer_tpu_torch.checkpoint import CheckpointCorrupt
from ml_trainer_tpu_torch.checkpoint.checkpoint import _flatten
from ml_trainer_tpu_torch.convert import state_from_jax
from ml_trainer_tpu_torch.resilience import FaultPlan, faults
from ml_trainer_tpu_torch.train_state import load_state_tree, state_tree

MANIFEST_KEYS = {"format", "epoch", "history", "leaves", "mesh",
                 "weights_fingerprint"}


def _leaves(tree) -> dict:
    return {p: v for p, v in _flatten(tree)
            if v is not None and not isinstance(v, dict)}


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for path, w in want.items():
        g = np.asarray(got[path])
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g, w), path


def _gpt2_trainer(model_dir, **kw):
    sets = (mt.SyntheticTokens(size=16, seq_len=32, vocab_size=64),
            mt.SyntheticTokens(size=8, seq_len=32, vocab_size=64, seed=1))
    model = mt.init_model("gpt2_tiny", seed=0, vocab_size=64, max_len=32,
                          device="cpu")
    return mt.Trainer(model, datasets=sets, epochs=1, batch_size=8,
                      optimizer="adamw", weight_decay=0.01, lr=1e-3,
                      scheduler="CosineAnnealingWarmRestarts",
                      precision="bf16", device="cpu",
                      model_dir=str(model_dir), **kw)


@pytest.fixture(scope="module")
def bf16_fit(tmp_path_factory):
    d = tmp_path_factory.mktemp("bf16_fit")
    tr = _gpt2_trainer(d)
    tr.fit()
    return tr, os.path.join(str(d), "checkpoints", "checkpoint_1")


def test_round_trip_of_a_bf16_adamw_state_is_bitwise(bf16_fit, tmp_path):
    tr, path = bf16_fit
    want = state_tree(tr.state, tr.model)
    assert want["loss_scale"] is not None and want["ema_params"] is None
    tree, history, epoch = ckpt.restore_checkpoint(path)
    assert epoch == 1 and history["train_loss"] == tr.history["train_loss"]
    _assert_trees_equal(tree, want)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert set(manifest) == MANIFEST_KEYS and manifest["format"] == 2
    assert manifest["mesh"] is None
    assert manifest["weights_fingerprint"] == ckpt.weights_fingerprint(
        {"params": want["params"]})
    for leaf in manifest["leaves"]:
        if "file" in leaf:
            np.load(os.path.join(path, leaf["file"]), allow_pickle=False)
    # Into a fresh trainer's own tensors, at their addresses.
    fresh = _gpt2_trainer(tmp_path)
    before = {p: t.data_ptr() for p, t in
              _leaves(state_tree(fresh.state, fresh.model)).items()
              if isinstance(t, torch.Tensor)}
    load_state_tree(fresh.state, fresh.model, tree)
    got = state_tree(fresh.state, fresh.model)
    _assert_trees_equal(got, want)
    assert {p: t.data_ptr() for p, t in _leaves(got).items()
            if isinstance(t, torch.Tensor)} == before
    assert fresh.state.step == tr.state.step == 2


def test_a_leaf_numpy_cannot_hold_is_named(tmp_path):
    tree = {"params": {"w": torch.ones(2, dtype=torch.bfloat16)}}
    with pytest.raises(ValueError, match="params/w: torch.bfloat16"):
        ckpt.save_checkpoint(str(tmp_path), tree, {}, epoch=1)


@pytest.mark.parametrize("change,match", [
    (lambda t: t["params"].pop("ln_final.bias"), "params/ln_final.bias"),
    (lambda t: t["opt_state"]["1"]["0"]["mu"].update(
        {"ln_final.bias": np.zeros(3, np.float32)}),
     "opt_state/1/0/mu/ln_final.bias"),
    (lambda t: t.update(loss_scale=np.float64(2.0)), "loss_scale: dtype"),
    (lambda t: t.update(rng=np.zeros(2, np.uint32)), "rng"),
])
def test_a_tree_that_does_not_fit_names_the_first_path(bf16_fit, tmp_path,
                                                       change, match):
    tree = ckpt.restore_checkpoint(bf16_fit[1])[0]
    change(tree)
    fresh = _gpt2_trainer(tmp_path)
    first = next(fresh.model.parameters())
    kept = first.detach().clone()
    with pytest.raises(ValueError, match=match):
        load_state_tree(fresh.state, fresh.model, tree)
    assert torch.equal(first.detach(), kept)  # nothing was written


# ------------------------------------------------------ format parity
def _jax_state():
    """A JAX ``TrainState`` of adamw over a small Dense tree, numpy
    params (nothing to compile)."""
    rng = np.random.default_rng(0)
    params = {"Dense_0": {"kernel": rng.normal(size=(5, 8)).astype(
        np.float32), "bias": np.zeros(8, np.float32)}}
    return JTrainState(step=jnp.asarray(7, jnp.int32), params=params,
                       opt_state=jget_optimizer("adamw", 1e-3).init(params),
                       batch_stats={}, rng=np.zeros(2, np.uint32))


def _truncate_largest(path):
    npys = [os.path.join(path, n) for n in os.listdir(path)
            if n.endswith(".npy")]
    victim = max(npys, key=os.path.getsize)
    with open(victim, "r+b") as fp:
        fp.truncate(os.path.getsize(victim) // 2)


def test_the_jax_package_verifies_a_port_checkpoint(bf16_fit, tmp_path):
    tree = ckpt.restore_checkpoint(bf16_fit[1])[0]
    good = ckpt.save_checkpoint(str(tmp_path), tree, {"train_loss": [1.0]},
                                epoch=1)
    bad = ckpt.save_checkpoint(str(tmp_path), tree, {}, epoch=2)
    jckpt.verify_checkpoint(bad)
    assert jckpt.latest_valid_checkpoint(str(tmp_path)) == bad
    _truncate_largest(bad)
    with pytest.raises(jckpt.CheckpointCorrupt, match="CRC32"):
        jckpt.verify_checkpoint(bad)
    assert jckpt.latest_valid_checkpoint(str(tmp_path),
                                         quarantine=False) == good


def test_the_port_verifies_a_jax_checkpoint(tmp_path):
    jax_path = jckpt.save_checkpoint(str(tmp_path / "j"), _jax_state(),
                                     {"train_loss": [1.0]}, epoch=3)
    ckpt.verify_checkpoint(jax_path)
    assert ckpt.latest_valid_checkpoint(str(tmp_path / "j")) == jax_path
    assert ckpt.checkpoint_format(jax_path) == 2
    tree, history, epoch = ckpt.restore_checkpoint(jax_path)
    assert epoch == 3 and history == {"train_loss": [1.0]}
    assert int(tree["step"]) == 7 and tree["ema_params"] is None
    port_path = ckpt.save_checkpoint(str(tmp_path / "t"), {
        "params": {"w": torch.ones(2)}, "ema_params": None}, {}, epoch=1)
    j_manifest = json.load(open(os.path.join(jax_path, "manifest.json")))
    t_manifest = json.load(open(os.path.join(port_path, "manifest.json")))
    assert set(j_manifest) == set(t_manifest) == MANIFEST_KEYS


# ------------------------------------------------- integrity, writer
def _small_tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(64, 32, generator=gen),
                       "b": torch.randn(32, generator=gen)},
            "opt_state": {"0": {}, "1": {"count": torch.tensor(3)}},
            "step": np.asarray(5, np.int32), "ema_params": None}


def test_ckpt_truncate_is_quarantined_with_fallback(tmp_path):
    state = _small_tree()
    good = ckpt.save_checkpoint(str(tmp_path), state, {"train_loss": [1.0]},
                                epoch=1)
    with faults.injected("ckpt_truncate@epoch=2"):
        bad = ckpt.save_checkpoint(str(tmp_path), state,
                                   {"train_loss": [1.0, 0.5]}, epoch=2)
    assert os.path.exists(os.path.join(bad, "manifest.json"))
    with pytest.raises(CheckpointCorrupt, match="CRC32"):
        ckpt.verify_checkpoint(bad)
    with pytest.raises(CheckpointCorrupt, match="CRC32"):
        ckpt.restore_checkpoint(bad)
    assert ckpt.latest_checkpoint(str(tmp_path)) == bad
    assert ckpt.latest_valid_checkpoint(str(tmp_path)) == good
    assert os.path.isdir(bad + ckpt.CORRUPT_SUFFIX) and not os.path.exists(bad)
    tree, hist, epoch = ckpt.restore_checkpoint(good)
    assert epoch == 1 and hist["train_loss"] == [1.0]
    _assert_trees_equal(tree, state)


def test_async_save_snapshots_before_it_returns(tmp_path):
    state = _small_tree()
    want = {k: v.clone() for k, v in state["params"].items()}
    path = ckpt.save_checkpoint(str(tmp_path), state, {}, epoch=1,
                                block=False)
    for t in state["params"].values():
        t.add_(1.0)  # the next step writes the state in place
    ckpt.wait_for_checkpoints()
    tree = ckpt.restore_checkpoint(path)[0]
    for k, w in want.items():
        assert np.array_equal(tree["params"][k], w.numpy())
    assert not np.array_equal(tree["params"]["w"],
                              state["params"]["w"].numpy())


def test_prune_keeps_the_newest_committed_past_an_uncommitted_dir(tmp_path):
    for e in (1, 2, 3):
        ckpt.save_checkpoint(str(tmp_path), _small_tree(), {}, epoch=e,
                             keep=0)
    inflight = tmp_path / "checkpoint_4"
    inflight.mkdir()
    (inflight / "leaf_00000.npy").write_bytes(b"\x93NUMPY partial")
    ckpt.prune_checkpoints(str(tmp_path), keep=1)
    assert not (tmp_path / "checkpoint_1").exists()
    assert not (tmp_path / "checkpoint_2").exists()
    assert (tmp_path / "checkpoint_3").exists() and inflight.exists()
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("checkpoint_3")


@pytest.mark.parametrize("arr", [
    np.arange(12, dtype=np.float32).reshape(3, 4), np.asarray(5, np.int32),
    np.array([True, False]), np.zeros((0, 3), np.float32),
    np.arange(6.0).reshape(2, 3).T,
], ids=["matrix", "scalar", "bool", "empty", "transposed"])
def test_leaf_files_are_the_bytes_np_save_writes(tmp_path, arr):
    from ml_trainer_tpu_torch.checkpoint.checkpoint import _crc32, _write_npy

    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, order="C"), allow_pickle=False)
    path = str(tmp_path / "leaf.npy")
    crc = _write_npy(path, arr)
    assert open(path, "rb").read() == buf.getvalue()
    assert crc == _crc32(buf.getvalue())
    back = np.load(path, allow_pickle=False)
    assert back.shape == arr.shape and np.array_equal(back, arr)


def test_fingerprints_follow_values_and_structure():
    a, b = _small_tree(0), _small_tree(1)
    assert ckpt.weights_fingerprint(a) == ckpt.weights_fingerprint(
        _small_tree(0))
    assert ckpt.weights_fingerprint(a) != ckpt.weights_fingerprint(b)
    assert (ckpt.weights_structure_digest(a)
            == ckpt.weights_structure_digest(b))


# -------------------------------------------------- state_from_jax
JAX_MLP = {"Dense_0": {"kernel": (5, 8), "bias": (8,)},
           "Dense_1": {"kernel": (8, 2), "bias": (2,)}}


class _PortMLP(torch.nn.Module):
    """The flax names ``Dense_0``/``Dense_1`` as module names."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(5, 8)
        self.Dense_1 = torch.nn.Linear(8, 2)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


@pytest.mark.parametrize("name", ["sgd", "adam", "adagrad", "adamax",
                                  "adamw"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_state_from_jax_carries_every_optimizer(name, wd):
    rng = np.random.default_rng(0)
    params = {m: {k: rng.normal(size=s).astype(np.float32)
                  for k, s in leaves.items()}
              for m, leaves in JAX_MLP.items()}
    inner = jget_optimizer(name, lambda count: 1e-3, momentum=0.9,
                           weight_decay=wd)
    opt = optax.chain(optax.identity(), inner).init(params)
    # Distinct values in every moment, so a transposed or swapped leaf
    # shows.
    opt = jax.tree.map(
        lambda x: (rng.normal(size=x.shape).astype(np.float32)
                   if np.issubdtype(np.asarray(x).dtype, np.floating)
                   else np.asarray(x) + 4), opt)
    jstate = JTrainState(step=np.int32(9), params=params, opt_state=opt,
                         batch_stats={}, rng=np.zeros(2, np.uint32),
                         skipped_steps=np.int32(2), bad_streak=np.int32(1))
    tree = state_from_jax(jstate)
    ds = mt.ArrayDataset(np.zeros((8, 5), np.float32),
                         np.zeros((8, 2), np.float32))
    tr = mt.Trainer(_PortMLP(), datasets=(ds, ds), epochs=1, batch_size=4,
                    optimizer=name, weight_decay=wd, criterion="l2",
                    metric=None, pred_function=None,
                    scheduler="CosineAnnealingWarmRestarts", device="cpu")
    load_state_tree(tr.state, tr.model, tree)
    assert tr.state.step == 9 and int(tr.state.skipped_steps) == 2
    torch.testing.assert_close(tr.model.Dense_0.weight,
                               torch.tensor(params["Dense_0"]["kernel"].T),
                               rtol=0, atol=0)
    inner_state = (opt[1][1] if wd and name != "adamw" else opt[1])
    first = inner_state[0]
    field = {"sgd": "trace", "adagrad": "sum_of_squares"}.get(name, "mu")
    port = tr.state.opt_state[1][1] if wd and name != "adamw" \
        else tr.state.opt_state[1]
    torch.testing.assert_close(
        port[0][field]["Dense_1.weight"],
        torch.tensor(getattr(first, field)["Dense_1"]["kernel"].T),
        rtol=0, atol=0)


def test_state_from_jax_splits_params_and_batch_stats():
    ones = np.ones(4, np.float32)
    jstate = JTrainState(
        step=np.int32(1),
        params={"stem_bn": {"scale": ones, "bias": 0 * ones}},
        opt_state=(optax.EmptyState(),), batch_stats={
            "stem_bn": {"mean": 0 * ones, "var": ones}},
        rng=np.zeros(2, np.uint32))
    tree = state_from_jax(jstate)
    assert set(tree["params"]) == {"stem_bn.weight", "stem_bn.bias"}
    assert set(tree["batch_stats"]) == {"stem_bn.running_mean",
                                        "stem_bn.running_var"}
    assert tree["opt_state"] == {"0": {}} and tree["loss_scale"] is None


# -------------------------------------------------------- fault plans
def test_fault_plan_parse_fire_and_remaining():
    plan = FaultPlan.parse(
        "nan_grad@step=12;ckpt_truncate@epoch=1;preempt@step=40")
    assert [f.kind for f in plan.faults] == ["nan_grad", "ckpt_truncate",
                                             "preempt"]
    assert plan.fire("nan_grad", step=11) is None
    assert plan.fire("nan_grad", step=12) is not None
    assert plan.fire("nan_grad", step=12) is None
    assert plan.fire("ckpt_truncate", epoch=2) is None
    assert plan.fire("ckpt_truncate", epoch=1) is not None
    assert [f.spec() for f in plan.remaining()] == ["preempt@step=40"]
    window = FaultPlan.parse("nan_grad@step=5,count=3")
    assert [window.fire("nan_grad", step=s) is not None
            for s in (4, 5, 6, 7, 8)] == [False, True, True, True, False]


def test_fault_plan_from_the_environment(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "preempt@step=2")
    plan = faults.active_plan()
    assert plan is not None and plan.faults[0].kind == "preempt"
    assert faults.active_plan() is plan
    with faults.injected("nan_grad@step=1") as installed:
        assert faults.active_plan() is installed
    monkeypatch.delenv(faults.ENV_VAR)
    assert faults.active_plan() is None


@pytest.mark.parametrize("spec,error,match", [
    ("decode_wedge@step=5", NotImplementedError, "ROADMAP.md"),
    ("host_kill@step=9,host=1", NotImplementedError, "ROADMAP.md"),
    ("replica_kill@step=3,host=2", NotImplementedError, "ROADMAP.md"),
    ("meteor_strike@step=1", ValueError, "unknown fault kind"),
    ("nan_grad@banana=1", ValueError, "unknown fault key"),
    ("nan_grad@step=1,secs=2", ValueError, "unknown fault key"),
    ("nan_grad@step", ValueError, "malformed"),
])
def test_fault_plan_refuses_what_the_port_does_not_act_on(spec, error,
                                                          match):
    with pytest.raises(error, match=match):
        FaultPlan.parse(spec)

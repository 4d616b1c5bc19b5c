"""Preemption, resume and rollback through the port's ``Trainer.fit``, on
the CPU (the JAX package's ``tests/test_resilience.py`` scenarios).

* A run preempted mid-epoch 2 (``preempt@step=6``, ``save_every_steps=2``)
  and resumed ends bit for bit where the uninterrupted run ends: history,
  parameters, buffers, optimizer state and counters.  Four cases: MLModel
  without and with a metric, ``gpt2_tiny`` in bf16 (loss scale in the
  state), and MLModel's sharded update over 2 CPU replicas (K4/K5's
  plain versions).  Every restore writes into the tensors the state
  holds (their ``data_ptr()`` unchanged).
* Against the JAX package (MLModel from the JAX trainer's initial
  weights, losses rtol 1e-4 as in ``tests/test_torch_model_trainer.py``):
  the same preempt-and-resume scenario in both packages; and the JAX
  run's ``checkpoint_1``, restored through JAX and carried by
  ``convert.state_from_jax`` into a port checkpoint, resumes in the port
  to the JAX run's epoch-2 losses.
* A real SIGTERM (raised by the dataset while it loads a batch, no
  timer) at K = 1 and K = 4; ``save_every_steps`` refused at K > 1, an
  epoch-boundary resume at K = 4 bitwise the uninterrupted K = 4 run, a
  mid-epoch checkpoint refused at K = 4; rollback after consecutive
  non-finite steps; a corrupt newest checkpoint skipped; a 2-replica
  checkpoint restored at 1 replica.
"""

import json
import os
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

import ml_trainer_tpu as J
import ml_trainer_tpu_torch as mt
import ml_trainer_tpu_torch.trainer as trainer_mod
from ml_trainer_tpu import MLModel as JMLModel
from ml_trainer_tpu import checkpoint as jckpt
from ml_trainer_tpu.data import SyntheticCIFAR10 as JCIFAR
from ml_trainer_tpu.resilience import faults as jfaults
from ml_trainer_tpu.utils.functions import custom_pre_process_function as jc
from ml_trainer_tpu_torch import checkpoint as ckpt
from ml_trainer_tpu_torch.checkpoint.checkpoint import _flatten
from ml_trainer_tpu_torch.convert import state_from_jax
from ml_trainer_tpu_torch.data import ArrayDataset
from ml_trainer_tpu_torch.resilience import faults
from ml_trainer_tpu_torch.train_state import state_tree

MLP_KW = dict(batch_size=16, metric=None, lr=0.01)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: small ops otherwise wait on all cores'
    threads, which the suite's other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cifar(size, seed, cls=mt.SyntheticCIFAR10,
           transform=mt.custom_pre_process_function):
    return cls(size=size, seed=seed, transform=transform())


def make(model_dir, case="mlmodel", epochs=2, size=64, train_set=None,
         **kw):
    """The JAX package's ``make_trainer`` in the port: MLModel on float
    CIFAR batches (NaN-poisonable), 4 steps an epoch; or one of the
    other cases."""
    model_dir = str(model_dir)
    if case == "gpt2_bf16":
        sets = (mt.SyntheticTokens(size=64, seq_len=32, vocab_size=64),
                mt.SyntheticTokens(size=16, seq_len=32, vocab_size=64,
                                   seed=1))
        model = mt.init_model("gpt2_tiny", seed=0, vocab_size=64,
                              max_len=32, device="cpu")
        return mt.Trainer(model, datasets=sets, epochs=epochs,
                          batch_size=16, optimizer="adamw",
                          weight_decay=0.01, lr=1e-3, precision="bf16",
                          device="cpu", model_dir=model_dir, **kw)
    if case == "sharded":
        kw = dict(kw, optimizer="adam", is_parallel=True,
                  mesh_shape={"data": 2}, dp_update="sharded")
        device = ["cpu", "cpu"]
    else:
        device = "cpu"
    if case == "mlmodel_accuracy":
        kw = dict(kw, metric="accuracy")
    return mt.Trainer(
        mt.init_model("mlmodel", seed=0, device="cpu"),
        datasets=(train_set or _cifar(size, 0), _cifar(32, 1)),
        epochs=epochs, device=device, model_dir=model_dir,
        **dict(dict(MLP_KW, loader="python"), **kw))


def _leaves(tr) -> dict:
    return {p: v for p, v in _flatten(state_tree(tr.state, tr.model))
            if isinstance(v, torch.Tensor)}


def assert_same_run(got, want):
    assert got.history == want.history
    assert got.state.step == want.state.step
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for path, t in w.items():
        assert g[path].dtype == t.dtype, path
        assert torch.equal(g[path], t), path


@pytest.fixture
def restores(monkeypatch):
    """Every ``load_state_tree`` of the trainer, with the state tensors'
    addresses before and after it."""
    seen = []
    real = trainer_mod.load_state_tree

    def spy(state, model, tree):
        def ptrs():
            return {p: t.data_ptr() for p, t in _flatten(
                state_tree(state, model)) if isinstance(t, torch.Tensor)}

        before = ptrs()
        real(state, model, tree)
        seen.append((before, ptrs()))

    monkeypatch.setattr(trainer_mod, "load_state_tree", spy)
    return seen


def _marker(model_dir):
    return os.path.join(str(model_dir), "checkpoints", "PREEMPTED.json")


# --------------------------------------------------- preempt and resume
@pytest.mark.parametrize("case", ["mlmodel", "mlmodel_accuracy",
                                  "gpt2_bf16", "sharded"])
def test_preempt_resume_bit_exact_mid_epoch(tmp_path, restores, case):
    ref = make(tmp_path / "ref", case)
    if case == "sharded":
        assert ref.dp_update == "sharded" and ref.fused_adam
    ref.fit()
    assert not ref.preempted
    d = tmp_path / "pre"
    with faults.injected("preempt@step=6"):  # batch 2 of epoch 2
        t1 = make(d, case, save_every_steps=2)
        t1.fit()
    assert t1.preempted and len(t1.train_losses) == 1
    assert json.load(open(_marker(d)))["epoch"] == 2
    assert json.load(open(_marker(d)))["batches_done"] == 2
    t2 = make(d, case, save_every_steps=2)
    t2.fit(resume=True)
    assert not t2.preempted and not os.path.exists(_marker(d))
    assert_same_run(t2, ref)
    assert len(restores) == 1 and restores[0][0] == restores[0][1]


# ----------------------------------------------- against the JAX package
def _jax_make(model_dir, **kw):
    return J.Trainer(JMLModel(),
                     datasets=(_cifar(64, 0, JCIFAR, jc),
                               _cifar(32, 1, JCIFAR, jc)),
                     epochs=2, backend="cpu", loader="python",
                     model_dir=str(model_dir), **dict(MLP_KW, **kw))


def test_resumed_runs_agree_with_the_jax_package(tmp_path):
    """JAX: preempted at step 6, resumed.  The port: the same from the
    JAX trainer's initial weights; and from the JAX run's checkpoint_1,
    carried into a port checkpoint."""
    jdir, tdir, cdir = tmp_path / "j", tmp_path / "t", tmp_path / "c"
    with jfaults.injected("preempt@step=6"):
        j1 = _jax_make(jdir, save_every_steps=2)
        weights = mt.params_from_jax(
            {"params": jax.tree.map(np.asarray, j1.state.params)})
        j1.fit()
    assert j1.preempted
    # checkpoint_1 of the JAX run, through JAX, into the port's format.
    jstate, jhist, epoch = jckpt.restore_checkpoint(
        os.path.join(str(jdir), "checkpoints", "checkpoint_1"),
        jckpt.fetch_to_host(j1.state))
    ckpt.save_checkpoint(os.path.join(str(cdir), "checkpoints"),
                         state_from_jax(jstate), jhist, epoch)
    j2 = _jax_make(jdir, save_every_steps=2)
    j2.fit(resume=True)

    with faults.injected("preempt@step=6"):
        t1 = make(tdir, save_every_steps=2)
        t1.model.load_state_dict(weights)
        t1.fit()
    assert t1.preempted
    t2 = make(tdir, save_every_steps=2)
    t2.fit(resume=True)
    carried = make(cdir)
    carried.fit(resume=True)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(t2.history[key], j2.history[key],
                                   rtol=1e-4, atol=1e-7, err_msg=key)
        assert carried.history[key][0] == jhist[key][0]
        np.testing.assert_allclose(carried.history[key][1],
                                   j2.history[key][1], rtol=1e-4,
                                   err_msg=key)
    assert t2.history["epochs"] == carried.history["epochs"] == [1, 2]
    assert t2.state.step == carried.state.step == int(j2.state.step) == 8


# -------------------------------------------------------------- signals
class _SignalAt(ArrayDataset):
    """Sends SIGTERM to this process while its item ``k`` is loaded, once,
    and only while the trainer's handler is installed."""

    def __init__(self, base, k):
        super().__init__(base.data, base.targets, base.transform)
        self.k, self.handler, self.sent = k, None, False

    def batch(self, indices):
        if self.k in indices and not self.sent:
            if signal.getsignal(signal.SIGTERM) != self.handler:
                raise RuntimeError("the trainer's SIGTERM handler is not "
                                   "installed")
            self.sent = True
            os.kill(os.getpid(), signal.SIGTERM)
        return super().batch(indices)


@pytest.mark.parametrize("k", [1, 4])
def test_sigterm_requests_clean_preemption(tmp_path, k):
    """The signal takes the ``preempt`` path: at K = 1 after the step in
    flight, with an emergency checkpoint of the batch cursor; at K = 4 at
    the next dispatch, with none.  The handlers are restored after fit."""
    previous = signal.getsignal(signal.SIGTERM)
    data = _SignalAt(_cifar(64, 0), k=37)
    tr = make(tmp_path, epochs=2, train_set=data, steps_per_execution=k,
              batch_size=8)
    data.handler = tr._on_preempt_signal
    tr.fit()
    assert data.sent and tr.preempted and tr.train_losses == []
    assert os.path.exists(_marker(tmp_path))
    assert signal.getsignal(signal.SIGTERM) == previous
    found = ckpt.latest_checkpoint(os.path.join(str(tmp_path),
                                                "checkpoints"))
    if k == 1:
        mid = ckpt.restore_checkpoint(found)[1]["mid_epoch"]
        assert mid["epoch"] == 1 and 1 <= mid["batches_done"] < 8
    else:
        assert found is None


def test_no_handlers_off_the_main_thread_or_when_asked(tmp_path):
    import threading

    tr = make(tmp_path, epochs=1)
    out = []
    worker = threading.Thread(
        target=lambda: out.append(tr._install_preempt_handlers()))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and out == [{}]
    tr.handle_preemption = False
    assert tr._install_preempt_handlers() == {}


# ------------------------------------------------------------ K > 1
def test_steps_per_execution_resumes_at_epoch_boundaries(tmp_path):
    with pytest.raises(ValueError, match="steps_per_execution"):
        make(tmp_path / "x", save_every_steps=2, steps_per_execution=3)
    kw = dict(steps_per_execution=4, batch_size=8)
    ref = make(tmp_path / "ref", **kw)
    ref.fit()
    resumed = tmp_path / "resumed" / "checkpoints"
    shutil.copytree(tmp_path / "ref" / "checkpoints" / "checkpoint_1",
                    resumed / "checkpoint_1")
    tr = make(tmp_path / "resumed", **kw)
    tr.fit(resume=True)
    assert_same_run(tr, ref)
    # A mid-epoch checkpoint resumes only through the per-batch path.
    with faults.injected("preempt@step=3"):
        make(tmp_path / "mid", batch_size=8, save_every_steps=1).fit()
    with pytest.raises(ValueError, match="steps_per_execution=1"):
        make(tmp_path / "mid", **kw).fit(resume=True)


# ------------------------------------------------ rollback, corruption
def test_rollback_after_consecutive_bad_steps(tmp_path, restores):
    with faults.injected("nan_grad@step=5,count=3"):
        tr = make(tmp_path, save_every_steps=1, rollback_bad_steps=2,
                  log_every_steps=1)
        tr.fit()
    assert tr._lr_scale == pytest.approx(0.5) and tr.rollbacks == 1
    assert tr.history["rollbacks"] == 1
    assert sum(tr.history["skipped_steps"]) >= 2
    assert all(np.isfinite(v) for v in tr.history["train_loss"])
    assert len(restores) == 1 and restores[0][0] == restores[0][1]


def test_resume_falls_back_past_a_corrupt_checkpoint(tmp_path):
    make(tmp_path).fit()
    newest = ckpt.latest_checkpoint(os.path.join(str(tmp_path),
                                                 "checkpoints"))
    assert newest.endswith("checkpoint_2")
    leaves = sorted(f for f in os.listdir(newest) if f.endswith(".npy"))
    with open(os.path.join(newest, leaves[-1]), "r+b") as fp:
        fp.truncate(1)
    tr = make(tmp_path, epochs=3)
    tr.fit(resume=True)
    assert os.path.isdir(newest + ckpt.CORRUPT_SUFFIX)
    assert tr.history["epochs"] == [1, 2, 3]
    assert all(np.isfinite(v) for v in tr.history["train_loss"])


def test_a_two_replica_checkpoint_restores_at_one_replica(tmp_path):
    two = make(tmp_path, "sharded", epochs=1)
    two.fit()
    one = make(tmp_path, epochs=1, optimizer="adam")
    assert one.mesh.size == 1
    one.fit(resume=True)  # epoch 1 is done: nothing left to train
    saved = ckpt.restore_checkpoint(os.path.join(
        str(tmp_path), "checkpoints", "checkpoint_1"))[0]
    got = _leaves(one)
    want = {p: v for p, v in _flatten(saved)
            if isinstance(v, np.ndarray) and p[0] != "step"}
    assert set(got) == set(want)
    for path, arr in want.items():
        assert np.array_equal(got[path].numpy(), arr), path
    assert one.history == two.history

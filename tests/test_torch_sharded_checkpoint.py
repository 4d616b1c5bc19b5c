"""Format-3 (sharded) checkpoints: the port's two-process ZeRO-1 run
writes each process's pieces, resumes from them bit for bit on two
processes and stitched on one, and the format is the JAX package's both
ways: its v3 reader reads the port's directories and the port reads the
directories its ``Trainer(sharded_checkpoint=True)`` writes.

Two worker processes (``tests/torch_mp_worker.py``, suite ``ckpt``) are
launched once for the module, at two threads each.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import ml_trainer_tpu_torch as mt
from ml_trainer_tpu import MLModel as JMLModel
from ml_trainer_tpu import Trainer as JTrainer
from ml_trainer_tpu.checkpoint import checkpoint as jckpt
from ml_trainer_tpu.data import SyntheticCIFAR10 as JCIFAR
from ml_trainer_tpu_torch.checkpoint import (
    CheckpointCorrupt,
    latest_valid_checkpoint,
    restore_checkpoint,
    verify_checkpoint,
)
from ml_trainer_tpu_torch.checkpoint.checkpoint import _flatten

from test_torch_distributed import launch


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("ckpt")
    return workdir, launch("ckpt", workdir)


def _records(launched, scenario: str) -> list:
    recs = [launched[1][r][scenario] for r in (0, 1)]
    for rank, rec in enumerate(recs):
        assert "error" not in rec, f"rank {rank}:\n{rec['error']}"
    return recs


@pytest.fixture(scope="module")
def run(launched):
    return launched[0], _records(launched, "ckpt_sharded_write_and_resume")


def _flat(tree) -> dict:
    return {"/".join(p): np.asarray(v) for p, v in _flatten(tree)
            if v is not None and not isinstance(v, dict)}


def _jax_stitched(path) -> dict:
    """Every leaf of a format-3 directory, whole, through the JAX
    package's v3 reader (its piece tables and ``_stitch``)."""
    with open(os.path.join(path, "manifest.json")) as fp:
        manifest = json.load(fp)
    tables = jckpt._read_piece_tables(path, manifest.get("process_count"))
    out = {}
    for i, leaf in enumerate(manifest["leaves"]):
        if leaf.get("empty") or leaf.get("none"):
            continue
        shape = tuple(leaf["shape"])
        out["/".join(leaf["path"])] = jckpt._stitch(
            path, tables.get(i, []), [0] * len(shape), list(shape), shape,
            np.dtype(leaf["dtype"]))
    return out


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_each_process_writes_its_own_pieces(run):
    """Format 3 with two piece tables: process 0 writes every replicated
    leaf whole and rows [0, d/2) of each moment; process 1 only rows
    [d/2, d) of each moment."""
    _, (r0, r1) = run
    assert r0["format"] == r1["format"] == 3
    assert r0["process_count"] == 2
    split = {tuple(k.split("/")) for k in r0["split"]}
    assert split and all(k[-2] in ("mu", "nu") for k in split)
    for rank, rec in enumerate((r0, r1)):
        mine = {tuple(p): (s, e) for p, s, e in rec["pieces"]}
        assert set(mine) >= split
        for path in split:
            start, stop = mine[path]
            rows = rec["local_shapes"]["/".join(path)][0]
            assert (start[0], stop[0]) == (rank * rows, (rank + 1) * rows)
        whole = set(mine) - split
        assert bool(whole) == (rank == 0)
        assert ("params", "fc1.weight") in whole or rank == 1


def test_two_processes_resume_bitwise(run):
    _, recs = run
    for rec in recs:
        assert rec["resumed"]["bitwise"], rec["resumed"]
        assert rec["history"] and rec["epochs"] == [1, 2]


def test_preemption_reaching_one_rank_stops_both_at_one_step(launched):
    """Rank 1 alone is preempted after global step 3 (epoch 1, batch 3):
    the processes agree at that dispatch, both write the emergency
    format-3 checkpoint, and both resume to the uninterrupted run."""
    recs = _records(launched, "ckpt_preempt_reaching_one_rank")
    for rec in recs:
        assert rec["preempted"] is True
        assert rec["info"] == {"epoch": 1, "batches_done": 3}
        assert rec["resumed"]["bitwise"], rec["resumed"]
        assert rec["history"]


def test_jax_v3_reader_reads_the_port_pieces(run):
    """The JAX package's stitching of the port's directory gives the
    port's own restore, and the two processes' saved state (parameters
    from process 0, each moment its two blocks)."""
    workdir, _ = run
    path = os.path.join(workdir, "whole", "checkpoints", "checkpoint_2")
    verify_checkpoint(path)
    mine = _flat(restore_checkpoint(path)[0])
    _same(mine, _jax_stitched(path))
    states = [dict(np.load(os.path.join(workdir, f"whole_state_{r}.npz")))
              for r in (0, 1)]
    for k, v in mine.items():
        if k.split("/")[-2:-1] in (["mu"], ["nu"]):
            want = np.concatenate([s[k] for s in states])
        else:
            want = states[0][k]
        np.testing.assert_array_equal(v, want, err_msg=k)


def test_two_process_checkpoint_restores_into_one_process(run, tmp_path):
    """2 -> 1: a one-process trainer (two co-located replicas, the
    sharded step) resumes the two-process checkpoint: its whole state
    is the stitched state, bit for bit; so is a single replica's."""
    workdir, _ = run
    src = os.path.join(workdir, "whole", "checkpoints")
    want = _flat(restore_checkpoint(os.path.join(src, "checkpoint_2"))[0])
    sets = _image_sets()
    for label, kw in (("two", dict(device=["cpu"] * 2, dp_update="sharded")),
                      ("one", dict(device="cpu"))):
        model_dir = tmp_path / label
        shutil.copytree(src, model_dir / "checkpoints")
        tr = mt.Trainer(mt.init_model("mlmodel", seed=0, device="cpu"),
                        datasets=sets, epochs=2, batch_size=16,
                        optimizer="adam", lr=1e-3, grad_clip_norm=1.0,
                        loader="python", seed=7, model_dir=str(model_dir),
                        **kw)
        assert tr._resume_from_latest() == 3
        got = _flat(mt.train_state.state_tree(tr.state, tr.model))
        _same({k: got[k] for k in want}, want)


def test_port_reads_the_jax_sharded_checkpoint(tmp_path):
    """The JAX Trainer's ``sharded_checkpoint=True`` run with ZeRO-1 over
    its 8 host devices: the port verifies the directory and restores the
    arrays the JAX reader stitches."""
    assert jax.device_count() == 8
    tr = JTrainer(JMLModel(), datasets=(JCIFAR(size=64, seed=0),
                                        JCIFAR(size=32, seed=1)),
                  epochs=1, batch_size=16, model_dir=str(tmp_path),
                  is_parallel=True, backend="cpu", seed=11, lr=0.01,
                  optimizer="adam", shard_opt_state=True,
                  sharded_checkpoint=True, loader="python")
    tr.fit()
    path = jckpt.latest_checkpoint(os.path.join(str(tmp_path),
                                                "checkpoints"))
    assert jckpt.checkpoint_format(path) == 3
    verify_checkpoint(path)
    want = _jax_stitched(path)
    got = _flat(restore_checkpoint(path)[0])
    _same(got, want)
    with open(os.path.join(path, "manifest_p00000.json")) as fp:
        pieces = json.load(fp)["pieces"]
    assert len(pieces) > len(want)  # the moments in blocks


def test_crc_corruption_is_caught(run, tmp_path):
    workdir, _ = run
    ckpt_dir = tmp_path / "checkpoints"
    shutil.copytree(os.path.join(workdir, "whole", "checkpoints"), ckpt_dir)
    path = ckpt_dir / "checkpoint_2"
    with open(path / "manifest_p00001.json") as fp:
        victim = path / json.load(fp)["pieces"][0]["file"]
    data = bytearray(victim.read_bytes())
    data[-1] ^= 0xFF
    victim.write_bytes(bytes(data))
    with pytest.raises(CheckpointCorrupt, match="CRC32"):
        verify_checkpoint(str(path))
    with pytest.raises(CheckpointCorrupt, match="CRC32"):
        restore_checkpoint(str(path))
    assert latest_valid_checkpoint(str(ckpt_dir)) == str(
        ckpt_dir / "checkpoint_1")
    assert (ckpt_dir / "checkpoint_2.corrupt").exists()


def _image_sets():
    from ml_trainer_tpu_torch.data import transforms as tt

    def one(seed, n):
        rng = np.random.default_rng(seed)
        x = rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)
        y = rng.integers(0, 10, size=n).astype(np.int32)
        return mt.ArrayDataset(x, y, tt.Compose([
            tt.ToFloat(), tt.Normalize((0.5,) * 3, (0.25,) * 3)]))

    return one(0, 64), one(1, 32)


def test_one_process_sharded_checkpoint_writes_replica_pieces(tmp_path):
    """``sharded_checkpoint=True`` in one process of two co-located
    replicas: process 0 writes each moment as two blocks, and a resumed
    run ends bitwise the uninterrupted one."""
    kw = dict(batch_size=16, optimizer="adam", lr=1e-3, dp_update="sharded",
              device=["cpu"] * 2, loader="python", seed=7,
              sharded_checkpoint=True)

    def trainer(name, epochs):
        return mt.Trainer(mt.init_model("mlmodel", seed=0, device="cpu"),
                          datasets=_image_sets(), epochs=epochs,
                          model_dir=str(tmp_path / name), **kw)

    whole = trainer("whole", 2)
    whole.fit()
    trainer("part", 1).fit()
    path = tmp_path / "part" / "checkpoints" / "checkpoint_1"
    with open(path / "manifest.json") as fp:
        assert json.load(fp)["format"] == 3
    with open(path / "manifest_p00000.json") as fp:
        names = [e["file"] for e in json.load(fp)["pieces"]]
    assert any(n.endswith("_s1_p00000.npy") for n in names)
    resumed = trainer("part", 2)
    resumed.fit(resume=True)
    _same(_flat(mt.train_state.state_tree(resumed.state, resumed.model)),
          _flat(mt.train_state.state_tree(whole.state, whole.model)))
    assert resumed.history["train_loss"] == whole.history["train_loss"]

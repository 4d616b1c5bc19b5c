"""One process per replica (``torch.distributed``, gloo on the CPU)
against the port's one-process replicas, and the pieces of the JAX
package's multi-process path the port copies: the ``ShardedSampler``
split and ``param_fingerprint``.

Two worker processes (``tests/torch_mp_worker.py``, suite ``dist``) are
launched once for the module, at two threads each; every scenario runs
in that launch and each test reads what it recorded.  The one-process
2-replica fits these runs are held to bitwise are held to the JAX
package by ``tests/test_torch_parallel.py``/``test_torch_sharded.py``.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ml_trainer_tpu.data import ShardedSampler as JSampler
from ml_trainer_tpu.parallel.desync import param_fingerprint as j_fingerprint
from ml_trainer_tpu_torch.data import ShardedSampler
from ml_trainer_tpu_torch.parallel import (
    create_mesh,
    initialize_distributed,
    param_fingerprint,
    process_count,
)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mp_worker.py")
LAUNCH_TIMEOUT_S = 280  # the workers dump their stacks and exit at 240
BN_RTOL = 1e-5  # synced vs one-process BatchNorm: another sum order


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(suite: str, workdir) -> dict:
    """Both ranks of ``suite``; their records by rank."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(key, None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, suite, str(port), str(rank), str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{suite} workers timed out")
    runs = {}
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        with open(os.path.join(workdir, f"{suite}_{rank}.json")) as fp:
            runs[rank] = json.load(fp)
    return runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return launch("dist", tmp_path_factory.mktemp("dist"))


def _each(runs, name):
    recs = [runs[r][name] for r in (0, 1)]
    for rank, rec in enumerate(recs):
        assert "error" not in rec, f"rank {rank}:\n{rec['error']}"
    return recs


def test_world_is_two_processes(runs):
    assert [(runs[r]["rank"], runs[r]["world"]) for r in (0, 1)] == [
        (0, 2), (1, 2)]


def test_fused_gpt2_is_bitwise_the_one_process_replicas(runs):
    """gpt2_tiny, adamw, clip 1.0, two microbatches a process: every
    state leaf and the history bitwise the one-process run of two
    replicas on the same global batches; each process reads 4 of the 8
    rows of a global batch."""
    for rec in _each(runs, "dist_fused_gpt2"):
        assert rec["state"]["bitwise"], rec["state"]
        assert rec["history"] and rec["mesh"] == {"data": 2}
        assert rec["loader_batch"] == 4
    assert runs[0]["dist_fused_gpt2"]["losses"] == \
        runs[1]["dist_fused_gpt2"]["losses"]


def test_sharded_gpt2_with_dropout_is_bitwise(runs):
    """The sharded step (K4/K5's plain versions) with dropout 0.1: each
    process holds only its dim-0 blocks of the moments, and its state is
    bitwise the one-process run's (the moments' blocks of that rank);
    the masks follow each process's rows of the global batch."""
    for rec in _each(runs, "dist_sharded_gpt2_dropout"):
        assert rec["state"]["bitwise"], rec["state"]
        assert rec["history"] and rec["fused_adam"]
        assert rec["split"] > 0 and rec["format"] == 3
        assert rec["local_rows"] == {
            "opt_state/1/0/mu/blocks.0.attn.proj.bias": [64],
            "opt_state/1/0/mu/blocks.0.attn.proj.weight": [64, 128]}
        assert rec["dropout_masks_differ"]


def test_mlmodel_at_k2_is_bitwise(runs):
    for rec in _each(runs, "dist_mlmodel_k2"):
        assert rec["state"]["bitwise"], rec["state"]
        assert rec["history"]


def test_batch_norm_statistics_are_synced_within_tolerance(runs):
    """A conv + ``layers.BatchNorm`` model: the processes sum their
    per-channel sums of x and x^2 (flax's E[x^2] - E[x]^2), the
    one-process run normalises the global batch at once: parameters and
    running statistics within BN_RTOL of each leaf's largest entry."""
    for rec in _each(runs, "dist_batch_norm"):
        assert rec["synced"] and not rec["ref_synced"]
        assert rec["max_rel"] < BN_RTOL, rec
        assert rec["history_rel"] < BN_RTOL, rec


def test_planted_desync_raises_on_rank_one_and_names_the_step(runs):
    r0, r1 = _each(runs, "dist_planted_desync")
    assert r0["clean_raised"] is None and r1["clean_raised"] is None
    assert r0["raised"] is None
    assert "host 1" in r1["raised"] and "(step 12)" in r1["raised"]


def test_resume_follows_rank_zero_when_rank_one_dir_is_empty(runs):
    """Rank 0 alone holds the format-2 checkpoint; both ranks resume from
    it (rank 0's decision and state broadcast) and end bitwise the
    uninterrupted two-process run.  Only rank 0 writes ``model.pth``."""
    r0, r1 = _each(runs, "dist_resume_follows_rank0")
    for rec in (r0, r1):
        assert rec["state"]["bitwise"], rec["state"]
        assert rec["history"] and rec["epochs"] == [1, 2]
        assert rec["rank1_dir_empty"]
    assert r0["model_pth_written"] and not r1["model_pth_written"]


def test_desync_every_steps_acts_at_its_cadence(runs):
    """``desync_every_steps=3`` at K = 2 (4 steps an epoch): the check
    runs after the dispatch a multiple of 3 fell in (global step 4 of
    epoch 1, 8 of epoch 2) and at each epoch's end."""
    for rec in _each(runs, "dist_desync_every_steps"):
        assert rec["steps"] == [4, 4, 8, 8]


def test_multi_process_refusals(runs):
    for rec in _each(runs, "dist_refusals"):
        assert "ROADMAP.md" in rec["local_replicas"]
        assert "gloo" in rec["gloo_graph"]
        assert "layers.BatchNorm" in rec["torch_batch_norm"]
        assert "format 3" in rec["v2_of_split_state"]


def test_native_loader_reads_its_share(runs):
    for rec in _each(runs, "dist_native_loader_split"):
        assert rec == {"kind": "NativeLoader", "labels": True, "batches": 4}


@pytest.mark.parametrize("n,replicas,shuffle,drop_last", [
    (64, 2, True, False), (67, 2, True, False), (67, 4, True, True),
    (10, 3, False, False)])
def test_sharded_sampler_matches_jax(n, replicas, shuffle, drop_last):
    for rank in range(replicas):
        for epoch in (0, 3):
            mine = ShardedSampler(n, replicas, rank, shuffle=shuffle,
                                  seed=7, drop_last=drop_last)
            theirs = JSampler(n, replicas, rank, shuffle=shuffle, seed=7,
                              drop_last=drop_last)
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            np.testing.assert_array_equal(mine.indices(), theirs.indices())
            assert len(mine) == len(theirs)


def test_param_fingerprint_matches_jax():
    """The same numpy tree (nested dicts, a list, a None) gives the JAX
    function's float exactly; torch tensors of it give the same."""
    rng = np.random.default_rng(3)
    tree = {"b": {"kernel": rng.normal(size=(5, 7)).astype(np.float32),
                  "bias": rng.normal(size=7).astype(np.float32)},
            "a": [rng.normal(size=3).astype(np.float32),
                  np.float32(2.5)], "z": None}
    want = j_fingerprint(tree)
    assert param_fingerprint(tree) == want
    as_torch = {"b": {k: torch.from_numpy(v) for k, v in tree["b"].items()},
                "a": [torch.from_numpy(tree["a"][0]), tree["a"][1]],
                "z": None}
    assert param_fingerprint(as_torch) == want
    assert param_fingerprint(tree, sharded={"b/kernel"}) != want


def test_rendezvous_rules():
    """One process with nothing explicit is a no-op (no group); the
    arguments are checked before any rendezvous."""
    initialize_distributed("nccl")
    assert process_count() == 1 and not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_distributed("gloo", num_processes=2)
    with pytest.raises(ValueError, match="process_id"):
        initialize_distributed("gloo", "localhost:1")
    with pytest.raises(ValueError, match="unknown process-group backend"):
        initialize_distributed("mpi")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        initialize_distributed("nccl", "localhost:1", 1, 0, device="cpu")
    assert not torch.distributed.is_initialized()


def test_one_replica_per_process_mesh():
    mesh = create_mesh(None, ["cpu"], distributed_run=True)
    assert mesh.distributed and mesh.size == 1 and mesh.local == (0,)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        create_mesh(None, ["cpu", "cpu"], distributed_run=True)
    one = create_mesh({"data": 3}, ["cpu"] * 3)
    assert not one.distributed and one.local == (0, 1, 2)


def _torchrun_env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    return env


def test_cli_under_torchrun_trains_across_two_processes(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    ml_trainer_tpu_torch --is_parallel``: two gloo processes train one
    run; process 0 writes the history, model.pth and the checkpoints."""
    out = tmp_path / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "ml_trainer_tpu_torch",
         "--backend", "cpu", "--is_parallel", "--synthetic", "--epochs", "2",
         "--batch_size", "32", "--synthetic_train_size", "64",
         "--synthetic_val_size", "32", "--model_dir", str(out)],
        cwd=os.path.dirname(os.path.dirname(WORKER)), env=_torchrun_env(),
        capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "history.json") as fp:
        history = json.load(fp)
    assert history["epochs"] == [1, 2]
    assert np.isfinite(history["train_loss"]).all()
    assert sorted(os.listdir(out / "checkpoints")) == ["checkpoint_1",
                                                       "checkpoint_2"]
    assert (out / "model.pth").exists()


def test_example_02_relaunches_one_process_a_replica(tmp_path):
    """``PROCESSES=2``: example 02 relaunches itself under torchrun, two
    processes of one replica each; both print the same history."""
    root = os.path.dirname(os.path.dirname(WORKER))
    env = dict(_torchrun_env(), BACKEND="cpu", PROCESSES="2",
               MODEL="mlmodel", SYNTH_SIZE="64", BATCH_SIZE="32",
               EPOCHS="1", MODEL_DIR=str(tmp_path / "d"))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "examples", "torch_port",
                                      "02_distributed_training.py")],
        cwd=root, env=env, capture_output=True, text=True,
        timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    printed = [line for line in proc.stdout.splitlines()
               if line.startswith("{'epochs'")]
    assert len(printed) == 2 and printed[0] == printed[1]
    assert (tmp_path / "d" / "history.pkl").exists()


def test_synced_batch_norm_is_flax_arithmetic():
    """``BatchNorm.synced`` in a process without a group is flax's
    ``nn.BatchNorm`` in train mode on the local batch (E[x^2] - E[x]^2,
    the biased variance in the running update): output and running
    statistics against flax's on the same input."""
    import flax.linen as fnn
    import jax.numpy as jnp

    from ml_trainer_tpu_torch.models.layers import BN_EPS, BatchNorm

    rng = np.random.default_rng(5)
    x = (rng.normal(size=(6, 5, 5, 4)) * 3 + 2).astype(np.float32)  # NHWC
    scale = rng.normal(size=4).astype(np.float32)
    bias = rng.normal(size=4).astype(np.float32)
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=BN_EPS)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(4), "var": jnp.ones(4)}}
    want, new = flax_bn.apply(variables, jnp.asarray(x),
                              mutable=["batch_stats"])
    bn = BatchNorm(4, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()
    bn.synced = True
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    # A few float32 ulps: flax sums in its own order.
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)

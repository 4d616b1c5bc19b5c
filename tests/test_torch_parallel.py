"""Port parity: data-parallel training of ``ml_trainer_tpu_torch`` (the
mesh, collectives, bucket plan and the sharded ``Trainer`` step) against
the JAX package's on the CPU.

The JAX trainer runs over the 8 host devices ``tests/conftest.py``
forces; the port runs 8 replicas that share the CPU
(``device=["cpu"] * 8``).  The GPT-2 run: ``gpt2_tiny`` at vocab 1020
(so ``tok_embed``'s dim 0 does not divide by 8 and it takes the
replicated psum path, as GPT-2 124M's 50257 does), seq 64, global batch
16 in 2 microbatches per replica, adam lr 3e-4 with no weight decay (the
fused tail's configuration), cosine restarts, clip 1.0, 2 epochs of 2
steps, the JAX trainer's initial params injected by ``params_from_jax``.

Bars (those of ``tests/test_torch_trainer.py``): per-epoch losses and
metrics rtol 1e-4; params atol 1e-4, the attention's key bias 1e-3
(its gradient is rounding noise that Adam's normalised step turns into
up to ~lr per step).  Within the port: ``fused_adam`` on and off give
bitwise the same losses, params and optimizer state (the CPU runs the
kernels' plain versions, which follow the unfused chain's op order), and
the sharded step, the ``dp_update="fused"`` step and one replica agree
within the same bars.
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch import nn

import ml_trainer_tpu as J
import ml_trainer_tpu_torch as mt
from ml_trainer_tpu.data import ArrayDataset as JArray
from ml_trainer_tpu.data import SyntheticTokens as JTokens
from ml_trainer_tpu.models import get_model as jget_model
from ml_trainer_tpu.parallel import plan_grad_buckets as j_plan
from ml_trainer_tpu_torch import trainer as trainer_mod
from ml_trainer_tpu_torch.data import ArrayDataset as TArray
from ml_trainer_tpu_torch.ops.optimizers import tree_map
from ml_trainer_tpu_torch.parallel import (
    bucketed_all_gather,
    bucketed_reduce_scatter,
    collectives as col,
    comm_stats,
    create_mesh,
    plan_grad_buckets,
)

N = 8
SEQ, VOCAB = 64, 1020
GPT_KW = dict(epochs=2, batch_size=16, grad_accum_steps=2, optimizer="adam",
              lr=3e-4, weight_decay=0.0,
              scheduler="CosineAnnealingWarmRestarts", grad_clip_norm=1.0)
E = 128  # gpt2_tiny's width: the key bias is qkv.bias[E:2E]


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads: the suite runs several test files at once,
    and eight replicas of tiny matmuls gain little from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------- plan
SHAPES = [(1020, 128), (1, 64, 128), (128,), (384, 128), (384,), (128, 512),
          (512,), (7,), (), (16, 3), (0, 4), (64, 64)]


@pytest.mark.parametrize("n,bucket_bytes", [(1, 4 * 2 ** 20), (2, 2 ** 16),
                                            (4, 200_000), (8, 2 ** 17),
                                            (8, 4 * 2 ** 20), (3, 2 ** 15)])
def test_plan_grad_buckets_matches_jax(n, bucket_bytes):
    want = j_plan([jax.ShapeDtypeStruct(s, np.float32) for s in SHAPES], n,
                  bucket_bytes=bucket_bytes)
    got = plan_grad_buckets([torch.empty(s, device="meta") for s in SHAPES],
                            n, bucket_bytes=bucket_bytes)
    assert got.n == want.n
    assert got.sharded == want.sharded
    assert got.buckets == want.buckets
    assert got.bucket_bytes == want.bucket_bytes
    assert got.overlap_fraction == pytest.approx(want.overlap_fraction,
                                                 rel=1e-12)


# -------------------------------------------------------- collectives
def _replicas(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def test_collectives_on_colocated_replicas():
    comm_stats.reset_comm_stats()
    xs = _replicas((6, 5), 3)
    ts = [torch.tensor(x) for x in xs]
    want = (xs[0] + xs[1]) + xs[2]  # the fixed replica order
    out = col.psum(ts)
    assert len(out) == 3 and all(o is out[0] for o in out)
    assert np.array_equal(out[0].numpy(), want)
    mean = col.pmean(ts)[0].numpy()
    assert np.array_equal(mean, want / np.float32(3))
    blocks = col.reduce_scatter(ts)
    assert [tuple(b.shape) for b in blocks] == [(2, 5)] * 3
    assert np.array_equal(torch.cat(blocks).numpy(), want)
    tiled = col.all_gather(ts)[0].numpy()
    assert np.array_equal(tiled, np.concatenate(xs))
    stacked = col.all_gather(ts, tiled=False)[0].numpy()
    assert np.array_equal(stacked, np.stack(xs))
    # Repeated calls repeat bit for bit (no atomics, fixed order).
    assert torch.equal(col.psum(ts)[0], out[0])
    mesh = create_mesh({"data": 3}, ["cpu"] * 3)
    assert col.axis_size(mesh) == 3 and col.axis_index(mesh) == [0, 1, 2]
    # Analytic bytes per participant, the JAX formulas: 120 bytes each.
    size = 6 * 5 * 4
    assert comm_stats.comm_bytes() == pytest.approx({
        "psum": 2 * 2 * size * 2 / 3, "pmean": 2 * size * 2 / 3,
        "reduce_scatter": size * 2 / 3, "all_gather": 2 * size * 2})
    assert comm_stats.comm_calls() == {"psum": 2, "pmean": 1,
                                       "reduce_scatter": 1, "all_gather": 2}
    comm_stats.reset_comm_stats()
    assert comm_stats.comm_bytes() == {}
    with pytest.raises(ValueError, match="does not split"):
        col.reduce_scatter([torch.ones(4)] * 3)
    with pytest.raises(ValueError, match="replica tensors differ"):
        col.psum([torch.ones(4), torch.ones(5)])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        col.psum([torch.ones(4), torch.ones(4, device="meta")])


def test_bucketed_reduce_scatter_and_all_gather_round_trip():
    shapes = [(1021, 16), (16,), (24, 8), (8,), (1, 12)]
    n = 4
    plan = plan_grad_buckets([torch.empty(s) for s in shapes], n,
                             bucket_bytes=600)
    assert len(plan.buckets) > 1 and plan.sharded == (
        False, True, True, True, False)
    per = [[torch.tensor(x) for x in (_replicas(s, 1, seed=10 * j + i)[0]
                                      for i, s in enumerate(shapes))]
           for j in range(n)]
    comm_stats.reset_comm_stats()
    got = bucketed_reduce_scatter(per, plan)
    for i, s in enumerate(shapes):
        total = ((per[0][i] + per[1][i]) + per[2][i]) + per[3][i]
        for j in range(n):
            if plan.sharded[i]:
                k = s[0] // n
                assert torch.equal(got[j][i], total[j * k:(j + 1) * k])
            else:  # replicated leaves pass through
                assert got[j][i] is per[j][i]
    full = bucketed_all_gather(got, plan, shapes)
    for i, s in enumerate(shapes):
        if plan.sharded[i]:
            total = ((per[0][i] + per[1][i]) + per[2][i]) + per[3][i]
            assert all(torch.equal(full[j][i], total) for j in range(n))
    by_bucket = comm_stats.comm_bucket_bytes()
    assert set(by_bucket) == {"reduce_scatter", "all_gather"}
    assert sorted(by_bucket["reduce_scatter"]) == [
        f"b{b}" for b in range(len(plan.buckets))]
    assert sorted(by_bucket["all_gather"]) == sorted(
        by_bucket["reduce_scatter"])


def test_create_mesh_rules():
    mesh = create_mesh({"data": 2}, ["cpu", "cpu"])
    assert mesh.shape == {"data": 2} and mesh.device == torch.device("cpu")
    assert create_mesh(None, ["cpu"] * 3).size == 3
    with pytest.raises(ValueError, match="does not cover"):
        create_mesh({"data": 2}, ["cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        create_mesh({"data": 1, "tensor": 2}, ["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        create_mesh({"data": 2}, ["cuda:0", "cuda:1"])


# -------------------------------------------------------- the trainer
def _port_gpt(state_dict):
    model = mt.get_model("gpt2_tiny", vocab_size=VOCAB, device="cpu")
    model.load_state_dict(state_dict)
    return model


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    j_sets = (JTokens(size=32, seq_len=SEQ, vocab_size=VOCAB),
              JTokens(size=16, seq_len=SEQ, vocab_size=VOCAB, seed=1))
    t_sets = (mt.SyntheticTokens(size=32, seq_len=SEQ, vocab_size=VOCAB),
              mt.SyntheticTokens(size=16, seq_len=SEQ, vocab_size=VOCAB,
                                 seed=1))
    tmp = tmp_path_factory.mktemp("dp")
    jtr = J.Trainer(jget_model("gpt2_tiny", vocab_size=VOCAB),
                    datasets=j_sets, backend="cpu", loader="python",
                    is_parallel=True, dp_update="sharded",
                    model_dir=str(tmp / "jax"), **GPT_KW)
    # The reference really takes the sharded step with ZeRO-1 moments.
    assert jtr.fused_adam and jtr.mesh.shape["data"] == N
    assert P("data") in {leaf.sharding.spec for leaf in jax.tree.leaves(
        jtr.state.opt_state) if getattr(leaf, "ndim", 0) > 0}
    init = mt.params_from_jax(_host(jtr.state.params))
    jtr.fit()
    runs = {}
    for name, kw in (
            ("sharded", dict(dp_update="sharded")),
            # Small buckets: several reduce-scatters per step.
            ("sharded_plain", dict(dp_update="sharded", fused_adam=False,
                                   bucket_mb=0.05)),
            ("fused", dict()),
            ("single", None)):
        where = (dict(device="cpu") if kw is None
                 else dict(is_parallel=True, device=["cpu"] * N, **kw))
        comm_stats.reset_comm_stats()
        tr = mt.Trainer(_port_gpt(init), datasets=t_sets,
                        model_dir=str(tmp / name), **where, **GPT_KW)
        tr.fit()
        runs[name] = tr
        if name == "sharded_plain":
            runs["plan_comm"] = (tr._bucket_plan,
                                 comm_stats.comm_bucket_bytes(),
                                 comm_stats.comm_calls())
    return jtr, runs


@pytest.mark.parametrize("key", ["train_loss", "val_loss", "train_metric",
                                 "val_metric"])
def test_sharded_trainer_epoch_history_matches_jax(dp_runs, key):
    jtr, runs = dp_runs
    ttr = runs["sharded"]
    assert ttr.fused_adam and ttr.dp_update == "sharded"
    assert len(ttr.history[key]) == 2
    np.testing.assert_allclose(ttr.history[key], jtr.history[key],
                               rtol=1e-4, atol=1e-7)


def _assert_params_close(got, want, atol=1e-4, key_atol=1e-3):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if name.endswith("attn.qkv.bias"):
            torch.testing.assert_close(g[E:2 * E], w[E:2 * E], atol=key_atol,
                                       rtol=0, msg=name)
            g = torch.cat([g[:E], g[2 * E:]])
            w = torch.cat([w[:E], w[2 * E:]])
        torch.testing.assert_close(g, w, atol=atol, rtol=0, msg=name)


def test_sharded_trainer_final_params_match_jax(dp_runs):
    jtr, runs = dp_runs
    ttr = runs["sharded"]
    assert ttr.state.step == int(jtr.state.step) == 4
    assert ttr.history["skipped_steps"] == jtr.history["skipped_steps"] == [
        0, 0]
    _assert_params_close(ttr.model.state_dict(),
                         mt.params_from_jax(_host(jtr.state.params)))
    # The ZeRO-1 moments, carried over and compared the same way.
    j_adam = mt.adam_state_from_jax(_host(jtr.state.opt_state))[1][0]
    t_adam = ttr.state.opt_state[1][0]
    assert int(t_adam["count"]) == int(j_adam["count"]) == 4
    for k in ("mu", "nu"):
        for name, w in j_adam[k].items():
            torch.testing.assert_close(t_adam[k][name], w, rtol=1e-3,
                                       atol=1e-6, msg=f"{k} {name}")


def test_fused_adam_on_and_off_are_bitwise_equal(dp_runs):
    _, runs = dp_runs
    on, off = runs["sharded"], runs["sharded_plain"]
    assert not off.fused_adam
    for key in ("train_loss", "val_loss", "train_metric", "val_metric"):
        assert on.history[key] == off.history[key], key
    for name, p in on.model.state_dict().items():
        assert torch.equal(p, off.model.state_dict()[name]), name
    a, b = [], []
    tree_map(a.append, on.state.opt_state)
    tree_map(b.append, off.state.opt_state)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert mt.launch_counts()["unscale_sqsum"] == 0  # plain versions on CPU


def test_sharded_fused_and_single_replica_agree(dp_runs):
    _, runs = dp_runs
    ref = runs["single"]
    assert runs["fused"].dp_update == "fused" and runs["fused"].mesh.size == N
    for name in ("sharded", "fused"):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(runs[name].history[key],
                                       ref.history[key], rtol=1e-4)
        _assert_params_close(runs[name].model.state_dict(),
                             ref.model.state_dict())


def test_sharded_step_accounts_one_collective_per_bucket(dp_runs):
    _, runs = dp_runs
    plan, by_bucket, calls = runs["plan_comm"]
    assert len(plan.buckets) > 1 and 0 < plan.overlap_fraction < 1
    names = list(dict(runs["sharded_plain"].model.named_parameters()))
    replicated = {k for k, s in zip(names, plan.sharded) if not s}
    assert replicated == {"tok_embed.weight", "pos_embed"}
    assert sorted(by_bucket["reduce_scatter"]) == sorted(
        by_bucket["all_gather"]) == sorted(
        f"b{b}" for b in range(len(plan.buckets)))
    steps = 4
    assert calls["reduce_scatter"] == calls["all_gather"] == (
        len(plan.buckets) * steps)
    # Per step: the replicated leaves' psum, the norm's psum, the guard's.
    assert calls["psum"] == 3 * steps


# ------------------------------------------------------------- guard
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


def test_poisoned_batch_is_skipped_alike_by_the_sharded_trainers(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(24, 5)).astype(np.float32)
    y = rng.normal(size=(24, 2)).astype(np.float32)
    x[7, 2] = np.nan  # one poisoned sample: one replica's shard of a batch
    xv = rng.normal(size=(8, 5)).astype(np.float32)
    yv = rng.normal(size=(8, 2)).astype(np.float32)
    kw = dict(epochs=2, batch_size=8, optimizer="adam", lr=1e-2,
              criterion="l2", metric="mcrmse", pred_function=None,
              grad_clip_norm=5.0, is_parallel=True, dp_update="sharded")
    jtr = J.Trainer(_JaxMLP(), datasets=(JArray(x, y), JArray(xv, yv)),
                    backend="cpu", loader="python",
                    model_dir=str(tmp_path / "j"), **kw)
    ttr = mt.Trainer(_port_mlp(_host(jtr.state.params)),
                     datasets=(TArray(x, y), TArray(xv, yv)),
                     device=["cpu"] * N, model_dir=str(tmp_path / "t"), **kw)
    assert jtr.fused_adam and ttr.fused_adam
    jtr.fit()
    ttr.fit()
    assert jtr.history["skipped_steps"] == [1, 1]
    assert ttr.history["skipped_steps"] == [1, 1]
    for key in ("train_loss", "val_loss", "train_metric", "val_metric"):
        np.testing.assert_allclose(ttr.history[key], jtr.history[key],
                                   rtol=1e-5, err_msg=key)
    # Only `step` advanced over the skipped batches; Adam's count and the
    # schedule's count stayed behind on every replica's shard.
    assert ttr.state.step == int(jtr.state.step) == 6
    adam_t, lr_t = ttr.state.opt_state[1][0], ttr.state.opt_state[1][1]
    assert int(adam_t["count"]) == int(lr_t["count"]) == 4
    assert int(jtr.state.opt_state[1][0].count) == 4
    jp = _host(jtr.state.params)
    torch.testing.assert_close(ttr.model[0].weight,
                               torch.tensor(jp["Dense_0"]["kernel"]).T,
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(ttr.model[2].bias,
                               torch.tensor(jp["Dense_1"]["bias"]),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------- refusals
@pytest.mark.parametrize("kw,match", [
    (dict(fused_adam=True, optimizer="adam"), "dp_update='sharded'"),
    (dict(fused_adam=True, optimizer="adamw", is_parallel=True,
          dp_update="sharded"), "optimizer='adam'"),
    (dict(fused_adam=True, optimizer="adam", weight_decay=0.1,
          is_parallel=True, dp_update="sharded"), "weight_decay"),
    (dict(dp_update="zero3"), "dp_update must be"),
    (dict(dp_update="sharded", steps_per_execution=2),
     "requires steps_per_execution=1"),
])
def test_reference_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        mt.Trainer("gpt2_tiny", device=["cpu"] * 2, **kw)


def test_single_replica_sharded_falls_back_with_a_warning(monkeypatch):
    said = []

    class Recorder:
        def __getattr__(self, level):
            return lambda msg, **kw: said.append((level, msg))

    monkeypatch.setattr(trainer_mod, "logger", Recorder())
    tr = mt.Trainer("gpt2_tiny", device="cpu", is_parallel=True,
                    dp_update="sharded", optimizer="adam")
    assert tr.dp_update == "fused" and tr.fused_adam is False
    assert ("warning", "dp_update='sharded' on a single-replica mesh has "
            "nothing to shard; falling back to the fused step.") in said
    tr = mt.Trainer("gpt2_tiny", device=["cpu"] * 2, dp_update="sharded",
                    optimizer="adam")
    assert tr.fused_adam and tr.shard_opt_state
    assert any("implies shard_opt_state=True" in m for _, m in said)


def test_distinct_cuda_devices_are_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        mt.Trainer("gpt2_tiny", is_parallel=True,
                   device=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="does not cover"):
        mt.Trainer("gpt2_tiny", device="cpu", mesh_shape={"data": 2})

"""``steps_per_execution`` in the port: K optimizer steps a dispatch.

The JAX package runs a full chunk of K batches as one ``lax.scan`` of its
step over batches stacked to [K, B, ...]; the ragged tail runs batch by
batch.  The port runs the same chunks through ``_train_chunk``: K
in-place steps (``_train_step_in_place``), one CUDA graph replay a chunk
on the card, the steps themselves on the CPU.

* The port's ``Trainer(K=3)`` against the JAX ``Trainer(K=3)`` on
  ``mlmodel`` and ``gpt2_tiny`` (fp32 and bf16 with the dynamic loss
  scale), from the JAX trainer's initial weights: the bars of
  ``tests/test_torch_trainer.py`` and ``tests/test_torch_precision.py``
  (histories rtol 1e-4 in fp32, params atol 1e-4 with the key bias at
  1e-3; 2e-2 in bf16, where the loss scale's state must be equal).
* The port at K = 3 against itself at K = 1: final parameters, buffers,
  optimizer state, counters and loss scale bitwise; the epoch losses and
  metrics within 1e-6 relative.  The steps are the same operations on
  the same tensors; only the epoch sums are added in another order (a
  dispatch's K losses first, then the epoch's, as in the JAX package).
* A batch planted non-finite in the middle of a chunk: the same skipped
  steps and the same loss-scale trajectory, step by step, as K = 1.
* ``_train_step_in_place`` against the functional ``_train_step``:
  bitwise, with every state tensor at the address it had before.
* ``device.CountedGraph``'s replay bookkeeping, with a stub graph.
* The refusals, as in the JAX package.
* On the card (``cuda``): ``gpt2_tiny`` through the flash kernels at
  K = 3, its chunks as graph replays, against K = 1 eager.

The JAX package is imported only where a test compares with it, so that
the ``cuda`` case also runs on a machine without it (``--noconftest``).
"""

import math

import numpy as np
import pytest
import torch
from torch import nn

import ml_trainer_tpu_torch as mt
from ml_trainer_tpu_torch import device as tdev
from ml_trainer_tpu_torch.data import ArrayDataset as TArray
from ml_trainer_tpu_torch.data import prefetch_to_device
from ml_trainer_tpu_torch.models.layers import BatchNorm, Conv
from ml_trainer_tpu_torch.ops.optimizers import tree_leaves
from ml_trainer_tpu_torch.parallel import collectives as col
from ml_trainer_tpu_torch.parallel import comm_stats
from ml_trainer_tpu_torch.trainer import _state_tensors

LOSS_KEYS = ("train_loss", "val_loss", "train_metric", "val_metric")
SUM_RTOL = 1e-6  # the epoch sums' order; everything else bitwise


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: small ops otherwise wait on all cores'
    threads, which the suite's other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax():
    """The JAX package and its pieces these tests use (the card's machine
    has no jax)."""
    import jax

    import ml_trainer_tpu as J
    from ml_trainer_tpu.data import SyntheticCIFAR10, SyntheticTokens
    from ml_trainer_tpu.models import get_model
    from ml_trainer_tpu.utils.functions import custom_pre_process_function

    return dict(jax=jax, J=J, CIFAR=SyntheticCIFAR10, Tokens=SyntheticTokens,
                get_model=get_model, custom=custom_pre_process_function)


def _host(jx, tree):
    return jx["jax"].tree.map(np.asarray, tree)


def _cifar_sets(mod, custom, n=32, n_val=16):
    return (mod(size=n, transform=custom()),
            mod(size=n_val, seed=1, transform=custom()))


def _token_sets(mod, n=32, n_val=16):
    return (mod(size=n, seq_len=64, vocab_size=1024),
            mod(size=n_val, seq_len=64, vocab_size=1024, seed=1))


JAX_RUNS = {
    # name: (model, port kwargs, train samples, trainer kwargs); 32
    # samples at batch 8: per epoch one chunk of 3 and a tail of 1
    "mlmodel_fp32": ("mlmodel", {}, 32, dict(
        batch_size=8, optimizer="sgd", momentum=0.9, lr=0.01,
        scheduler="CosineAnnealingWarmRestarts", metric="accuracy")),
    # The JAX test's 80 samples at batch 32, [32, 32, 16]: the ragged 16
    # leaves for the tail at once and the two full batches follow it, so
    # the tail runs 16, 32, 32 in both packages.
    "mlmodel_ragged_80": ("mlmodel", {}, 80, dict(
        batch_size=32, optimizer="adam", lr=1e-3, grad_clip_norm=0.5,
        metric="accuracy")),
    "gpt2_tiny_fp32": ("gpt2_tiny", dict(attention_impl="flash"), 32, dict(
        batch_size=8, grad_accum_steps=2, optimizer="adamw", lr=3e-4,
        weight_decay=0.01, scheduler="CosineAnnealingWarmRestarts",
        grad_clip_norm=1.0)),
    "gpt2_tiny_bf16": ("gpt2_tiny", dict(attention_impl="flash"), 32, dict(
        batch_size=8, grad_accum_steps=2, optimizer="adamw", lr=3e-4,
        weight_decay=0.01, grad_clip_norm=1.0, precision="bf16")),
}


@pytest.mark.parametrize("run", sorted(JAX_RUNS))
def test_k3_matches_the_jax_trainer_at_k3(run, tmp_path):
    jx = _jax()
    name, port_kw, n, kw = JAX_RUNS[run]
    kw = dict(kw, epochs=2, steps_per_execution=3)
    if name == "mlmodel":
        j_sets = _cifar_sets(jx["CIFAR"], jx["custom"], n)
        t_sets = _cifar_sets(mt.SyntheticCIFAR10,
                             mt.custom_pre_process_function, n)
    else:
        j_sets, t_sets = _token_sets(jx["Tokens"], n), _token_sets(
            mt.SyntheticTokens, n)
    jtr = jx["J"].Trainer(jx["get_model"](name), datasets=j_sets,
                          backend="cpu", loader="python",
                          model_dir=str(tmp_path / "j"), **kw)
    model = mt.get_model(name, device="cpu", **port_kw)
    model.load_state_dict(mt.params_from_jax(
        _host(jx, {"params": jtr.state.params})))
    ttr = mt.Trainer(model, datasets=t_sets, device="cpu", loader="python",
                     model_dir=str(tmp_path / "t"), **kw)
    jtr.fit()
    ttr.fit()
    bf16 = kw.get("precision") == "bf16"
    for key in LOSS_KEYS:
        # In bf16 the GPT-2 accuracy (near 1/1024 on random tokens) moves
        # by whole tokens where bf16 breaks a near-tie otherwise: 1e-3 is
        # two of the 2048 tokens a validation epoch scores.
        atol = 1e-3 if bf16 and key.endswith("metric") else 1e-7
        np.testing.assert_allclose(ttr.history[key], jtr.history[key],
                                   rtol=2e-2 if bf16 else 1e-4, atol=atol,
                                   err_msg=key)
    assert ttr.history["skipped_steps"] == jtr.history["skipped_steps"]
    assert ttr.state.step == int(jtr.state.step) == 2 * len(ttr.train_loader)
    if bf16:
        s, js = ttr.state, jtr.state
        assert (float(s.loss_scale), int(s.good_steps)) == (
            float(js.loss_scale), int(js.good_steps))
        return
    want = mt.params_from_jax(_host(jx, {"params": jtr.state.params}))
    got = ttr.model.state_dict()
    e = 128  # gpt2_tiny's width: the key bias is qkv.bias[e:2e]
    for key, w in want.items():
        g = got[key]
        if key.endswith("attn.qkv.bias"):
            torch.testing.assert_close(g[e:2 * e], w[e:2 * e], atol=1e-3,
                                       rtol=0, msg=key)
            g, w = torch.cat([g[:e], g[2 * e:]]), torch.cat([w[:e], w[2 * e:]])
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0, msg=key)


# ------------------------------------------------------ K = 3 vs K = 1
class _BNModel(nn.Module):
    """Conv -> BatchNorm -> mean -> Dense over NHWC [B, 8, 8, 3]."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.conv = Conv(3, 4, 3, 2, device="cpu")
        self.bn = BatchNorm(4, device="cpu")
        self.head = nn.Linear(4, 3, device="cpu")
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)

    def forward(self, x):
        x = self.bn(self.conv(x.permute(0, 3, 1, 2)))
        return self.head(torch.relu(x).mean(dim=(2, 3)))


def _images(n, seed, side=32, classes=10):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, side, side, 3)).astype(np.float32)
    return x, rng.integers(0, classes, size=n).astype(np.int32)


def _model(name):
    if name == "bn":
        return _BNModel()
    if name == "gpt2_tiny":
        return mt.init_model("gpt2_tiny", seed=0, device="cpu",
                             vocab_size=256, max_len=64,
                             attention_impl="flash")
    return mt.init_model(name, seed=0, device="cpu")


def _sets(name, n, n_val=40):
    if name == "gpt2_tiny":
        return (mt.SyntheticTokens(size=n, seq_len=64, vocab_size=256),
                mt.SyntheticTokens(size=n_val, seq_len=64, vocab_size=256,
                                   seed=1))
    side, classes = (8, 3) if name == "bn" else (32, 10)
    return (TArray(*_images(n, 0, side, classes)),
            TArray(*_images(n_val, 1, side, classes)))


def _fit(k, name, n, tmp_path, **kw):
    kw = dict(dict(epochs=2, batch_size=32, optimizer="adam", lr=1e-3,
                   metric="accuracy", device="cpu"), **kw)
    tr = mt.Trainer(_model(name), datasets=_sets(name, n),
                    model_dir=str(tmp_path / f"k{k}"),
                    steps_per_execution=k, **kw)
    tr.fit()
    return tr


def _assert_same_run(a, b):
    """``b`` (K > 1) is ``a`` (K = 1) bitwise, the epoch sums aside."""
    for key in LOSS_KEYS:
        np.testing.assert_allclose(b.history[key], a.history[key],
                                   rtol=SUM_RTOL, atol=0, err_msg=key)
    for key in ("skipped_steps", "epochs", "rollbacks"):
        assert b.history[key] == a.history[key], key
    for (key, p), q in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(p, q), key
    assert a.state.step == b.state.step
    sa, sb = _state_tensors(a.state), _state_tensors(b.state)
    assert len(sa) == len(sb)
    for i, (p, q) in enumerate(zip(sa, sb)):
        assert p.dtype == q.dtype and torch.equal(p, q), i


SAME_RUNS = {
    # name: (model, samples, trainer kwargs); batch 32, 2 epochs
    # 7 batches an epoch: 2 chunks + a tail of 1
    "mlmodel_accum2_clip": ("mlmodel", 224, dict(grad_accum_steps=2,
                                                 grad_clip_norm=0.5)),
    "mlmodel_bf16_accum2_clip": ("mlmodel", 224, dict(
        grad_accum_steps=2, grad_clip_norm=0.5, precision="bf16")),
    # the JAX test's 80 samples at batch 32, here in 2 microbatches (drop
    # last): 2 batches, no full chunk, the tail in the batches' order
    "mlmodel_accum2_80": ("mlmodel", 80, dict(grad_accum_steps=2,
                                              grad_clip_norm=0.5)),
    # [32] * 6 + [16]: 2 chunks, the ragged batch through the tail
    "mlmodel_ragged_208": ("mlmodel", 208, dict(
        grad_clip_norm=0.5, scheduler="StepLR", optimizer="sgd",
        momentum=0.9, lr=0.01)),
    # BatchNorm on 2 replicas of the fused step (global-microbatch
    # statistics), with the guard reverting the running statistics
    "bn_fused_2_replicas": ("bn", 224, dict(
        grad_accum_steps=2, is_parallel=True, device=["cpu"] * 2,
        optimizer="sgd", momentum=0.9, lr=0.05)),
    # 7 batches of 8 an epoch: 2 chunks + a tail of 1
    "gpt2_tiny_adamw_cosine": ("gpt2_tiny", 56, dict(
        batch_size=8, grad_accum_steps=2, optimizer="adamw", lr=3e-4,
        weight_decay=0.01, scheduler="CosineAnnealingWarmRestarts",
        grad_clip_norm=1.0, metric=None)),
}


@pytest.mark.parametrize("run", sorted(SAME_RUNS))
def test_k3_is_bitwise_k1_but_for_the_order_of_the_epoch_sums(run, tmp_path):
    name, n, kw = SAME_RUNS[run]
    a = _fit(1, name, n, tmp_path, **kw)
    b = _fit(3, name, n, tmp_path, **kw)
    assert b.steps_per_execution == 3
    if name == "bn":
        assert b._has_batch_norm and b.mesh.size == 2
    _assert_same_run(a, b)
    if kw.get("precision") == "bf16":
        assert b.state.loss_scale is not None


POISON_SEED = 7


def _poisoned_sets(n, batch, poison_batch):
    """Images with one NaN sample, placed so that the loader's first
    epoch puts it in batch ``poison_batch``."""
    x, y = _images(n, 0)
    # The Loader's first-epoch permutation at the trainer's seed.
    first = np.random.default_rng((POISON_SEED, 0)).permutation(n)
    x[first[poison_batch * batch + 3], 5, 7, 1] = np.nan
    return TArray(x, y), TArray(*_images(32, 1))


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_non_finite_batch_inside_a_chunk_is_skipped_as_at_k1(precision,
                                                             tmp_path):
    """7 batches of 32: the NaN sample sits in batch 1 of epoch 1, the
    middle of the first chunk; the guard skips that step (and in bf16
    halves the scale) exactly as the K = 1 run does, step by step."""
    runs = {}
    for k in (1, 3):
        tr = mt.Trainer(mt.init_model("mlmodel", seed=0, device="cpu"),
                        datasets=_poisoned_sets(224, 32, 1), epochs=2,
                        batch_size=32, optimizer="adam", lr=1e-3,
                        grad_clip_norm=0.5, metric="accuracy",
                        precision=precision, device="cpu",
                        seed=POISON_SEED, model_dir=str(tmp_path / f"k{k}"),
                        steps_per_execution=k)
        trail = []
        step = tr._train_step

        def recorded(*args, _step=step, _tr=tr, _trail=trail):
            out = _step(*args)
            s = _tr.state
            _trail.append((int(s.skipped_steps), int(s.bad_streak),
                           None if s.loss_scale is None
                           else (float(s.loss_scale), int(s.good_steps))))
            return out

        tr._train_step = recorded  # under the in-place step too
        tr.fit()
        runs[k] = (tr, trail)
    (a, trail_1), (b, trail_3) = runs[1], runs[3]
    assert len(trail_1) == len(trail_3) == 14
    assert trail_3 == trail_1
    assert a.history["skipped_steps"][0] == 1
    if precision:
        assert trail_1[1][2][0] == trail_1[0][2][0] / 2  # backed off
    _assert_same_run(a, b)


# ------------------------------------------------- the capturable step
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("lr_scale", [1.0, 0.1])
def test_in_place_step_is_bitwise_the_functional_step(lr_scale, precision,
                                                      tmp_path):
    """Three steps (accum 2, clip, adamw with cosine restarts) from the
    same state: ``_train_step`` with a host ``lr_scale`` and
    ``_train_step_in_place`` with it as a device scalar give the same
    bits, and the in-place step leaves every state tensor, parameter and
    buffer where it was."""
    sets = _sets("gpt2_tiny", 24)
    kw = dict(datasets=sets, epochs=1, batch_size=8, grad_accum_steps=2,
              optimizer="adamw", lr=3e-3, weight_decay=0.01,
              scheduler="CosineAnnealingWarmRestarts", grad_clip_norm=1.0,
              precision=precision, device="cpu")
    fun = mt.Trainer(_model("gpt2_tiny"), model_dir=str(tmp_path / "f"), **kw)
    inp = mt.Trainer(_model("gpt2_tiny"), model_dir=str(tmp_path / "i"),
                     **kw)
    held = [t.data_ptr() for t in _state_tensors(inp.state)]
    held_model = [t.data_ptr() for t in inp.model.state_dict().values()]
    lr_t = torch.full((), lr_scale, dtype=torch.float32)
    for x, y in prefetch_to_device(fun.train_loader, device="cpu"):
        lf, mf = fun._train_step(x, y, lr_scale)
        li, mi = inp._train_step_in_place(x, y, lr_t)
        assert torch.equal(lf, li) and torch.equal(mf, mi)
    assert fun.state.step == inp.state.step == 3
    for (key, p), q in zip(fun.model.state_dict().items(),
                           inp.model.state_dict().values()):
        assert torch.equal(p, q), key
    got = _state_tensors(inp.state)
    for i, (p, q) in enumerate(zip(_state_tensors(fun.state), got)):
        assert torch.equal(p, q), i
    assert [t.data_ptr() for t in got] == held
    assert [t.data_ptr() for t in inp.model.state_dict().values()] == \
        held_model
    assert int(inp.state.opt_state[1][0]["count"]) == 3  # adamw's count


def test_state_tensors_cover_every_leaf_once():
    tr = mt.Trainer(_model("gpt2_tiny"), datasets=_sets("gpt2_tiny", 16),
                    epochs=1, batch_size=8, optimizer="adamw", lr=1e-3,
                    precision="bf16", device="cpu")
    leaves = _state_tensors(tr.state)
    assert len(leaves) == len(tree_leaves(tr.state.opt_state)) + 4
    assert len({t.data_ptr() for t in leaves}) == len(leaves)


# ----------------------------------------- launch counts under replays
class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_counted_graph_moves_the_capture_counts_to_the_replays():
    mt.reset_launch_counts()
    tdev.count_launch("flash_fwd")  # an eager launch before the capture
    graph = tdev.CountedGraph(_StubGraph())
    with graph.capturing() as g:
        assert isinstance(g, _StubGraph)
        for _ in range(12):
            tdev.count_launch("flash_fwd")
        for _ in range(24):
            tdev.count_launch("flash_bwd_dq")
    # The capture launched nothing.
    assert mt.launch_counts()["flash_fwd"] == 1
    assert mt.launch_counts()["flash_bwd_dq"] == 0
    assert graph.added[0] == {"flash_fwd": 12, "flash_bwd_dq": 24}
    for _ in range(3):
        graph.replay()
    counts = mt.launch_counts()
    assert graph.graph.replays == 3
    assert counts["flash_fwd"] == 1 + 36 and counts["flash_bwd_dq"] == 72
    assert counts["flash_bwd_dkv"] == 0
    mt.reset_launch_counts()


def test_counted_graph_replays_comm_stats_and_undoes_a_failed_capture():
    comm_stats.reset_comm_stats()
    x = torch.ones(8)
    col.pmean([x, x])
    graph = tdev.CountedGraph(_StubGraph(), comm_stats.tallies())
    with graph.capturing():
        col.psum([x, x])
        col.pmean([x, x])
    assert comm_stats.comm_calls() == {"pmean": 1}
    graph.replay()
    graph.replay()
    assert comm_stats.comm_calls() == {"pmean": 3, "psum": 2}
    assert comm_stats.comm_bytes() == {"pmean": 3 * 32.0, "psum": 2 * 32.0}
    # A capture that raises leaves the counters as they were.
    mt.reset_launch_counts()
    failed = tdev.CountedGraph(_StubGraph())
    with pytest.raises(RuntimeError, match="capture failed"):
        with failed.capturing():
            tdev.count_launch("fused_adam")
            raise RuntimeError("capture failed")
    assert mt.launch_counts()["fused_adam"] == 0
    comm_stats.reset_comm_stats()


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("kw", [
    dict(steps_per_execution=0),
    dict(steps_per_execution=4, dp_update="sharded", is_parallel=True),
], ids=["k0", "sharded_k4"])
def test_refusals_match_jax(kw, tmp_path):
    jx = _jax()
    with pytest.raises(ValueError, match="steps_per_execution") as want:
        jx["J"].Trainer(jx["get_model"]("mlmodel"), backend="cpu",
                        model_dir=str(tmp_path), **kw)
    with pytest.raises(ValueError, match="steps_per_execution") as got:
        mt.Trainer("mlmodel", device=["cpu"] * 2 if "dp_update" in kw
                   else "cpu", **kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_gpt2_tiny_graph_chunks_match_eager_on_card(tmp_path):
    """``gpt2_tiny`` (head_dim 32, through the flash route's padding: K1,
    K2 and K3) at K = 3, every full chunk one replay of its CUDA graph
    (the first chunk runs eagerly before the capture), against K = 1
    eager: bitwise but for the epoch sums, and the exact launch counts
    of the kernels that ran, replays included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA) and nvcc")
    from ml_trainer_tpu_torch import step_graph

    replays = []
    real = step_graph.StepGraph.replay

    def counted(self, *args):
        replays.append(self)
        return real(self, *args)

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(step_graph.StepGraph, "replay", counted)
        for k in (1, 3):
            sets = (mt.SyntheticTokens(size=112, seq_len=128,
                                       vocab_size=1024),
                    mt.SyntheticTokens(size=48, seq_len=128,
                                       vocab_size=1024, seed=1))
            model = mt.init_model("gpt2_tiny", seed=0, device="cuda",
                                  attention_impl="flash")
            tr = mt.Trainer(model, datasets=sets, epochs=2, batch_size=8,
                            grad_accum_steps=2, optimizer="adamw", lr=3e-4,
                            weight_decay=0.01, grad_clip_norm=1.0,
                            scheduler="CosineAnnealingWarmRestarts",
                            metric="accuracy", device="cuda",
                            model_dir=str(tmp_path / f"k{k}"),
                            steps_per_execution=k)
            mt.reset_launch_counts()
            tr.fit()
            torch.cuda.synchronize()
            runs[k] = (tr, mt.launch_counts())
            assert not tr._graphs  # freed when fit() ended
    (a, counts_1), (b, counts_3) = runs[1], runs[3]
    # 14 train steps an epoch: 4 chunks (the first eager) and a tail of 2;
    # 6 validation batches: 2 chunks (the first eager).
    assert len(replays) == (3 + 1) + (4 + 2)
    depth, micro = b.model.depth, 2 * 14 * 2
    want = {"flash_fwd": depth * (micro + 2 * 6),
            "flash_bwd_dq": depth * micro, "flash_bwd_dkv": depth * micro}
    for counts in (counts_1, counts_3):
        assert {k: counts[k] for k in want} == want
        assert counts["paged_attention"] == counts["fused_adam"] == 0
    _assert_same_run(a, b)
    assert all(math.isfinite(v) for v in b.history["train_loss"])

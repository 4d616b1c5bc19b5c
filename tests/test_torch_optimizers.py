"""lamb, lion and adafactor in the port (``ops/optimizers.py``) against
the JAX package's optax chains, on the CPU.

* Five steps of each under a cosine schedule, decaying everything or
  matrices only, from the same leaves in each package's layout: a square
  256 x 256 Dense kernel (adafactor's tie between its two axes), a
  128 x 384 kernel, a 64 x 64 one (not factored), a bias and a
  3 x 3 x 128 x 128 conv.  Parameters and every state leaf within 1e-6
  of the largest entry; without ``flax_axes`` the square kernel's
  factored moments trade places.
* lion's ``sign()``: bitwise-equal gradients keep the same signs.
* A 3-step ``gpt2_tiny`` fit with each optimizer against the JAX
  ``Trainer`` from the same weights: losses within 1e-5, parameters
  near the JAX run's (lion: 1e-6 of the largest, a flipped sign allowed
  only where the interpolation sat near 0, and rarely).
* Format-v2 checkpoints across the packages (adafactor both ways, all
  three from the JAX package), the CLI's ``--optimizer adafactor``.
* ``dp_update="sharded"`` on 2 replicas (a 3-layer MLP): the JAX
  package's sharded lamb takes its trust ratio per replica shard and
  differs from its fused step; the port's sharded step differs from its
  fused step the same way.  The JAX sharded adafactor raises where a
  sharded leaf factors; the port refuses it there.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch
from flax import linen as flax_nn

import ml_trainer_tpu as J
import ml_trainer_tpu_torch as mt
from ml_trainer_tpu import checkpoint as jckpt
from ml_trainer_tpu.data import ArrayDataset as JArrayDataset
from ml_trainer_tpu.data import SyntheticTokens as JTokens
from ml_trainer_tpu.models import get_model as jget_model
from ml_trainer_tpu.ops import get_optimizer as jget_optimizer
from ml_trainer_tpu.ops.optimizers import (
    decay_mask_matrices_only as jmatrices_only,
)
from ml_trainer_tpu_torch import checkpoint as ckpt
from ml_trainer_tpu_torch import cli
from ml_trainer_tpu_torch.convert import (
    adam_state_from_jax,
    params_from_jax,
    state_from_jax,
    state_to_jax,
)
from ml_trainer_tpu_torch.ops.optimizers import (
    decay_mask_matrices_only,
    get_optimizer,
    scale_by_factored_rms,
)
from ml_trainer_tpu_torch.train_state import (
    as_tree,
    load_state_tree,
    state_tree,
)

NAMES = ("lamb", "lion", "adafactor")

# flax-layout leaves (Dense [in, out], Conv HWIO).
SHAPES = {"sq": {"kernel": (256, 256), "bias": (256,)},
          "wide": {"kernel": (128, 384)},
          "small": {"kernel": (64, 64)},
          "conv": {"kernel": (3, 3, 128, 128)}}
AXES = {"sq.weight": (1, 0), "wide.weight": (1, 0), "small.weight": (1, 0),
        "conv.weight": (2, 3, 1, 0)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: small ops otherwise wait on all cores'
    threads, which the suite's other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    return {m: {k: (scale * rng.normal(size=s)).astype(np.float32)
                for k, s in leaves.items()} for m, leaves in SHAPES.items()}


def _jax_schedule():
    return optax.cosine_decay_schedule(1e-2, 5, alpha=0.1)


def _port_schedule():
    def lr(count):
        c = torch.clamp(count.to(torch.float32), max=5.0)
        cos = 0.5 * (1.0 + torch.cos(torch.pi * c / 5.0))
        return 1e-2 * ((1.0 - 0.1) * cos + 0.1)
    return lr


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def _leaves(tree, prefix=""):
    """{path: array} of a port state (tuples and dicts)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree.detach().numpy()}


def _run_both(name, wd, matrices_only, axes=AXES, steps=5):
    rng = np.random.default_rng(0)
    jparams = _tree(rng)
    grads = [_tree(rng, scale=10.0 ** (-i)) for i in range(steps)]
    jtx = jget_optimizer(name, _jax_schedule(), weight_decay=wd,
                         decay_mask=jmatrices_only if matrices_only else None)
    ttx = get_optimizer(name, _port_schedule(), weight_decay=wd,
                        decay_mask=(decay_mask_matrices_only
                                    if matrices_only else None),
                        flax_axes=axes)
    jstate = jtx.init(jparams)
    tparams = params_from_jax(jparams)
    tstate = ttx.init(tparams)
    jupdate = jax.jit(jtx.update)
    for g in grads:
        upd, jstate = jupdate(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tupd, tstate = ttx.update(params_from_jax(g), tstate, tparams)
        tparams = {k: p + tupd[k] for k, p in tparams.items()}
    return jparams, jstate, tparams, tstate


@pytest.mark.parametrize("matrices_only", [False, True],
                         ids=["decay_all", "matrices_only"])
@pytest.mark.parametrize("name", NAMES)
def test_five_steps_match_optax(name, matrices_only):
    jparams, jstate, tparams, tstate = _run_both(name, 0.01, matrices_only)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for k, w in want.items():
        assert _rel(tparams[k], w) < 1e-6, k
    # Every state leaf, through the JAX -> port converter.
    conv = _leaves(adam_state_from_jax(jax.tree.map(np.asarray, jstate)))
    got = _leaves(tstate)
    assert set(got) == set(conv)
    for path, w in conv.items():
        assert got[path].shape == w.shape, path
        if np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(got[path], w), path
        else:
            assert _rel(got[path], w) < 1e-6, path


def test_adafactor_factors_the_flax_axes():
    """The square kernel and the conv (I == O) tie: on the port's own
    layout the roles of v_row and v_col swap; on the flax view they are
    the JAX vectors, and the 64 x 64 kernel keeps a full v."""
    _, jstate, _, tstate = _run_both("adafactor", 0.0, False, steps=2)
    fj = jstate[0]
    assert fj.v_row["sq"]["kernel"].shape == (256,)
    assert fj.v["small"]["kernel"].shape == (64, 64)
    assert tstate[0]["v"]["small.weight"].shape == (64, 64)
    assert tstate[0]["v_row"]["conv.weight"].shape == (3, 3, 128)
    _, _, _, bare = _run_both("adafactor", 0.0, False, axes=None, steps=2)
    want = np.asarray(fj.v_row["sq"]["kernel"])
    assert _rel(tstate[0]["v_row"]["sq.weight"], want) < 1e-6
    assert _rel(bare[0]["v_row"]["sq.weight"], want) > 1e-3


def test_adafactor_state_placeholders():
    tx = scale_by_factored_rms(flax_axes=AXES)
    state = tx.init(params_from_jax(_tree(np.random.default_rng(1))))
    assert state["v"]["sq.weight"].shape == (1,)
    assert state["v_row"]["small.weight"].shape == (1,)
    assert state["v"]["sq.bias"].shape == (256,)


def test_lion_signs_bitwise_equal_gradients():
    _, jstate, tparams, tstate = _run_both("lion", 0.0, False)
    for k, w in params_from_jax(jax.tree.map(
            np.asarray, jstate[0].mu)).items():
        assert _rel(tstate[0]["mu"][k], w) < 1e-6, k
    assert all(np.isfinite(p.numpy()).all() for p in tparams.values())


# ------------------------------------------------------ Trainer-level
GPT_KW = dict(batch_size=8, lr=1e-3, weight_decay=0.01,
              scheduler="CosineAnnealingWarmRestarts", metric=None)
# Three steps: lion's in three epochs of one (a checkpoint after each
# step, for its interpolations), the others' in one epoch.
EPOCHS = {"lamb": 1, "lion": 3, "adafactor": 1}


def _token_sets(mod, vocab=256, seq=32, size=8):
    return (mod(size=size, seq_len=seq, vocab_size=vocab),
            mod(size=8, seq_len=seq, vocab_size=vocab, seed=1))


def _fit_pair(name, tmp_path, jax_devices=None, t_device="cpu", **kw):
    vocab, epochs = 256, EPOCHS[name]
    kw = dict(kw, epochs=epochs)
    with pytest.MonkeyPatch.context() as mp:
        if jax_devices:
            real = jax.devices
            mp.setattr(jax, "devices",
                       lambda *a, **k: real(*a, **k)[:jax_devices])
        jtr = J.Trainer(jget_model("gpt2_tiny", vocab_size=vocab),
                        datasets=_token_sets(JTokens, size=24 // epochs),
                        backend="cpu", loader="python", optimizer=name,
                        model_dir=str(tmp_path / "j"), **GPT_KW, **kw)
    model = mt.get_model("gpt2_tiny", vocab_size=vocab, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(
        np.asarray, {"params": jtr.state.params})))
    ttr = mt.Trainer(model,
                     datasets=_token_sets(mt.SyntheticTokens,
                                          size=24 // epochs),
                     device=t_device, loader="python", optimizer=name,
                     model_dir=str(tmp_path / "t"), **GPT_KW, **kw)
    jtr.fit()
    ttr.fit()
    return jtr, ttr


# The key third of attention's qkv bias takes a gradient that is 0 in
# exact arithmetic (softmax ignores a shift shared by a row's logits):
# what each package computes there is float cancellation noise, which
# all three optimizers normalise to full-size updates (lamb's trust
# ratio spreads it over the leaf).  Those leaves are left out of the
# parameter check; the losses cover them.
NOISE_LEAF = "attn.qkv.bias"
# Parameters against the JAX run, of the leaf's largest entry.  lamb's
# Adam normalises each element first: a bias element whose gradient is
# near its eps moves with float32 reorderings of the reductions (as for
# adamw, ROADMAP.md Queue C 3; 1.0e-3 measured after 3 steps).  lion's
# update is a sign: anything but a permitted flip is rounding.
BARS = {"lamb": 5e-3, "lion": 1e-6, "adafactor": 1e-4}


def _lion_near_zero(jtr, tmp_path) -> dict:
    """Per parameter, the elements where some step's interpolation
    ``(1 - b1) g + b1 m`` sat within 1e-3 of the leaf's largest: each
    step's moment read from the JAX run's checkpoint of that epoch (one
    step an epoch), its gradient from two moments.  The two packages'
    gradients differ by the order of their reductions, so a sign can
    flip a little away from 0 (the flips measured: 7 of 415,000
    elements, at up to 1.2e-4 of the largest)."""
    b1, b2 = 0.9, 0.99
    prev, near = None, {}
    for epoch in (1, 2, 3):
        state, _, _ = jckpt.restore_checkpoint(os.path.join(
            str(tmp_path / "j"), "checkpoints", f"checkpoint_{epoch}"),
            jtr.state)
        mu = adam_state_from_jax(jax.tree.map(
            np.asarray, state.opt_state))[1][0]["mu"]
        for k, m in mu.items():
            m0 = torch.zeros_like(m) if prev is None else prev[k]
            g = (m - b2 * m0) / (1 - b2)
            c = ((1 - b1) * g + b1 * m0).abs()
            hit = c <= 1e-3 * float(c.max())
            near[k] = hit if k not in near else near[k] | hit
        prev = mu
    return near


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """name -> (JAX trainer, port trainer, their directory): each
    optimizer's 3-step ``gpt2_tiny`` fit in both packages."""
    out = {}
    for name in NAMES:
        d = tmp_path_factory.mktemp(name)
        out[name] = (*_fit_pair(name, d), d)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_three_step_fit_matches_the_jax_trainer(name, fits):
    jtr, ttr, tmp_path = fits[name]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(ttr.history[key], jtr.history[key],
                                   rtol=0, atol=1e-5)
    assert ttr.state.step == 3
    jp = params_from_jax(jax.tree.map(np.asarray,
                                      {"params": jtr.state.params}))
    near = _lion_near_zero(jtr, tmp_path) if name == "lion" else {}
    bar, flips, total = BARS[name], 0, 0
    for k, p in ttr.model.named_parameters():
        if k.endswith(NOISE_LEAF):
            continue
        w = torch.as_tensor(np.asarray(jp[k]))
        off = (p.detach() - w).abs() > bar * float(w.abs().max())
        if k in near:
            flips += int((off & near[k]).sum())
            off &= ~near[k]
        total += off.numel()
        assert not bool(off.any()), k
    assert flips <= 1e-4 * total


def _opt_leaves(state) -> dict:
    return _leaves(as_tree(state) if isinstance(state, tuple) else state)


def test_adafactor_checkpoints_cross_both_ways(fits, tmp_path):
    jtr, ttr, d = fits["adafactor"]
    # port -> JAX: the port's checkpoint through state_to_jax, restored
    # by the JAX package onto its own trainer's template.
    tree = ckpt.restore_checkpoint(ckpt.latest_checkpoint(os.path.join(
        str(d / "t"), "checkpoints")))[0]
    path = ckpt.save_checkpoint(str(tmp_path / "x"),
                                state_to_jax(tree, ttr.model), {}, epoch=1)
    jstate, _, epoch = jckpt.restore_checkpoint(path, jtr.state)
    assert epoch == 1 and int(jstate.step) == 3
    # ... and back: the JAX state carried into the port is the tree.
    back = state_from_jax(jax.tree.map(np.asarray, jstate))
    want = _opt_leaves(state_tree(ttr.state, ttr.model)["opt_state"])
    got = _opt_leaves(back["opt_state"])
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.array_equal(got[k], w), k
    for k, p in ttr.model.named_parameters():
        assert torch.equal(back["params"][k], p.detach()), k


@pytest.mark.parametrize("name", NAMES)
def test_jax_checkpoints_load_into_the_port(name, fits):
    jtr, ttr, d = fits[name]
    jstate, _, _ = jckpt.restore_checkpoint(jckpt.latest_checkpoint(
        os.path.join(str(d / "j"), "checkpoints")), jtr.state)
    tr = mt.Trainer(mt.get_model("gpt2_tiny", vocab_size=256, device="cpu"),
                    datasets=_token_sets(mt.SyntheticTokens),
                    device="cpu", loader="python", optimizer=name,
                    model_dir=str(d / "t2"), epochs=1, **GPT_KW)
    load_state_tree(tr.state, tr.model,
                    state_from_jax(jax.tree.map(np.asarray, jstate)))
    want = _opt_leaves(adam_state_from_jax(jax.tree.map(
        np.asarray, jstate.opt_state)))
    got = _opt_leaves(tr.state.opt_state)
    assert set(got) == set(want) and tr.state.step == 3
    for k, w in want.items():
        assert np.array_equal(got[k], w), k


def test_cli_trains_with_adafactor(tmp_path):
    cli.cli(["--backend", "cpu", "--synthetic", "--epochs", "1",
             "--batch_size", "32", "--synthetic_train_size", "64",
             "--synthetic_val_size", "32", "--optimizer", "adafactor",
             "--model_dir", str(tmp_path / "m")])
    hist = mt.load_history(str(tmp_path / "m"))
    assert np.isfinite(hist["train_loss"]).all()
    assert os.path.exists(tmp_path / "m" / "model.pth")


# ------------------------------------------------- dp_update="sharded"
SHARDED = dict(is_parallel=True, dp_update="sharded")


class _JMLP(flax_nn.Module):
    """64 -> 256 -> 256 -> 10: the middle kernel factors (adafactor),
    and the flax dim 0 of each kernel is its input."""

    @flax_nn.compact
    def __call__(self, x):
        x = flax_nn.relu(flax_nn.Dense(256)(x))
        x = flax_nn.relu(flax_nn.Dense(256)(x))
        return flax_nn.Dense(10)(x)


class _PortMLP(torch.nn.Module):
    """The flax names ``Dense_0``.. as module names."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(64, 256)
        self.Dense_1 = torch.nn.Linear(256, 256)
        self.Dense_2 = torch.nn.Linear(256, 10)

    def forward(self, x):
        x = torch.relu(self.Dense_0(x))
        return self.Dense_2(torch.relu(self.Dense_1(x)))


def _mlp_sets(mod):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(48, 64)).astype(np.float32)
    y = rng.integers(0, 10, size=48).astype(np.int32)
    return mod(x[:32], y[:32]), mod(x[32:], y[32:])


MLP_KW = dict(epochs=2, batch_size=16, optimizer="lamb", lr=1e-2,
              weight_decay=0.01, metric=None, criterion="cross_entropy")


def _mlp_pair(tmp_path, sharded, **kw):
    kw = dict(MLP_KW, **kw)
    with pytest.MonkeyPatch.context() as mp:
        real = jax.devices
        mp.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:2])
        jtr = J.Trainer(_JMLP(), datasets=_mlp_sets(JArrayDataset),
                        backend="cpu", loader="python",
                        model_dir=str(tmp_path / "j"),
                        **(SHARDED if sharded else {}), **kw)
    model = _PortMLP()
    model.load_state_dict(params_from_jax(jax.tree.map(
        np.asarray, {"params": jtr.state.params})))
    ttr = mt.Trainer(model, datasets=_mlp_sets(mt.ArrayDataset),
                     device=["cpu"] * 2 if sharded else "cpu",
                     loader="python", model_dir=str(tmp_path / "t"),
                     **(SHARDED if sharded else {}), **kw)
    return jtr, ttr


def _mlp_params(jtr, ttr):
    jp = params_from_jax(jax.tree.map(np.asarray,
                                      {"params": jtr.state.params}))
    return jp, {k: p.detach() for k, p in ttr.model.named_parameters()}


def test_sharded_lamb_matches_the_jax_sharded_step(tmp_path):
    """The JAX sharded step takes lamb's trust ratio per replica block
    of the flax dim 0 (a Dense kernel's input rows; the port's dim 0 is
    the output), so it leaves the fused step's result.  The port's
    sharded step lands on the JAX sharded run's parameters (1e-5 of the
    largest entry; 1.2e-6 measured), and its fused step does not (1e-4
    to 9e-3 off)."""
    jtr, ttr = _mlp_pair(tmp_path / "s", True)
    assert jtr.mesh.shape["data"] == 2 and ttr.mesh.size == 2
    fused = _PortMLP()
    fused.load_state_dict(ttr.model.state_dict())
    fused = mt.Trainer(fused, datasets=_mlp_sets(mt.ArrayDataset),
                       device="cpu", loader="python",
                       model_dir=str(tmp_path / "f"), **MLP_KW)
    for tr in (jtr, ttr, fused):
        tr.fit()
    np.testing.assert_allclose(ttr.history["train_loss"],
                               jtr.history["train_loss"], rtol=0, atol=1e-5)
    js, ts = _mlp_params(jtr, ttr)
    tf = {k: p.detach() for k, p in fused.model.named_parameters()}
    for k, w in js.items():
        assert _rel(ts[k], w) < 1e-5, k
    assert max(_rel(tf[k], w) for k, w in js.items()) > 1e-4


def test_sharded_adafactor_is_refused_where_jax_raises(tmp_path):
    """Dense_1's [256, 256] kernel is sharded and factored: the JAX
    sharded step raises; the port refuses it when the state is built."""
    with pytest.raises(ValueError, match="Queue C"):
        _mlp_pair(tmp_path, True, optimizer="adafactor")
    with pytest.MonkeyPatch.context() as mp:
        real = jax.devices
        mp.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:2])
        jtr = J.Trainer(_JMLP(), datasets=_mlp_sets(JArrayDataset),
                        backend="cpu", loader="python",
                        model_dir=str(tmp_path / "j"),
                        **SHARDED, **dict(MLP_KW, optimizer="adafactor"))
    with pytest.raises(TypeError, match="incompatible shapes"):
        jtr.fit()

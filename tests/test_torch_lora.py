"""LoRA training in the port (``ml_trainer_tpu_torch/lora.py``,
``models/layers.py`` ``lora_delta``, ``Trainer(lora=...)``) against the
JAX package's, on the CPU.

The same weights on both sides (``params_from_jax``), inputs from numpy
seeds.  Tolerance: float32 outputs and gradients within 1e-5 of the
largest entry, losses within 1e-5 relative, the frozen base bitwise.
The adapters after a fit are held at 5e-5 of the largest entry: Adam
divides each element's moment by its own root, so where a gradient
element is small its relative float32 reordering error passes into a
full-size step (1.4e-5 of the largest entry after four steps here).

* ``lora_delta`` in train mode (parameters A [in, r], B [r, out]) and in
  serve mode (stacks gathered per row) against the JAX
  ``MultiHeadAttention`` and ``MLP`` with the same knobs: outputs, and
  the train-mode attention's gradients (adapters and input).
* A ``Trainer(lora=...)`` fit of ``gpt2_tiny`` against the JAX one:
  losses, adapter leaves, every base leaf bitwise unchanged, the
  optimizer state under the JAX test's bound (0.2 x 2 x the parameter
  bytes) with the frozen base carrying none; the JAX state carried into
  the port (``state_from_jax``: the masked moments); the port's
  checkpoint verified by the JAX package and resumed at K = 2 bitwise the
  K = 1 run; the guard on the ``nan_grad`` plan and on a poisoned base
  (the port takes no gradient of the base).
* The refusals: ``dp_update="sharded"``, and a model of another family.
"""

import os

import jax
import numpy as np
import pytest
import torch

import ml_trainer_tpu as J
import ml_trainer_tpu_torch as mt
from ml_trainer_tpu import checkpoint as jckpt
from ml_trainer_tpu.data import SyntheticTokens as JTokens
from ml_trainer_tpu.models import get_model as jget_model
from ml_trainer_tpu.models.layers import MLP as JMLP
from ml_trainer_tpu.models.layers import MultiHeadAttention as JMHA
from ml_trainer_tpu.resilience import faults as jfaults
from ml_trainer_tpu_torch import checkpoint as ckpt
from ml_trainer_tpu_torch.convert import _unmasked, state_from_jax
from ml_trainer_tpu_torch.models.layers import MLP, MultiHeadAttention
from ml_trainer_tpu_torch.resilience import faults
from ml_trainer_tpu_torch.train_state import load_state_tree

VOCAB, SEQ = 256, 16
LORA = dict(rank=4, alpha=8.0, targets=("qkv", "proj"))
# lr as the GPT-2 parity fit's (test_torch_trainer.py).  At the JAX
# package's own test's 0.05 the first Adam steps, sign-like where an
# adapter's gradient is tiny, lift float32 reorderings to ~1.1e-5 of the
# largest adapter entry after four steps.
FIT_KW = dict(epochs=2, batch_size=8, metric=None, optimizer="adamw",
              lr=3e-4, weight_decay=0.01, grad_clip_norm=1.0)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _close(got, want, what="", rel=1e-5):
    """float32: within ``rel`` of the largest entry of ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol, what


def _sets(jax_side: bool):
    cls = JTokens if jax_side else mt.SyntheticTokens
    return (cls(size=16, seq_len=SEQ, vocab_size=VOCAB, seed=0),
            cls(size=8, seq_len=SEQ, vocab_size=VOCAB, seed=1))


def _flat_state(tr) -> dict:
    """The trainer's parameters and optimizer state by path."""
    out = {f"p/{k}": p.data for k, p in tr.model.named_parameters()}
    for i, t in enumerate(mt.ops.optimizers.tree_leaves(tr.state.opt_state)):
        out[f"o/{i}"] = t
    return out


def _port_trainer(params, model_dir, **kw):
    """A port LoRA trainer on the flax ``params`` (base and adapters; the
    JAX trainer's initial ones)."""
    model = mt.get_model("gpt2_tiny", vocab_size=VOCAB, max_len=64,
                         device="cpu")
    tr = mt.Trainer(model, datasets=_sets(False), device="cpu",
                    model_dir=str(model_dir), lora=LORA, **{**FIT_KW, **kw})
    tr.model.load_state_dict(mt.params_from_jax(params))
    return tr


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora_fits")
    jtr = J.Trainer(jget_model("gpt2_tiny", vocab_size=VOCAB, max_len=64),
                    datasets=_sets(True), backend="cpu", loader="python",
                    model_dir=str(d / "j"), lora=J.LoraConfig(**LORA),
                    **FIT_KW)
    j_init = _host(jtr.state.params)
    ttr = _port_trainer(j_init, d / "t")
    t_init = {k: v.clone() for k, v in ttr.model.state_dict().items()}
    with jfaults.injected("nan_grad@step=2"):
        jtr.fit()
    with faults.injected("nan_grad@step=2"):
        ttr.fit()
    return jtr, ttr, j_init, t_init, d


# ------------------------------------------------------------ the layers
def _layer_pair(kind, serve: bool, seed: int):
    """The JAX layer's and the port's outputs on the same weights, and for
    the train-mode attention the gradients of ``sum(out * w)`` over the
    adapters and the input (the MLP's adapters run the same code)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    w = rng.normal(size=(3, 5, 32)).astype(np.float32)
    knobs = dict(lora_rank=4, lora_alpha=8.0,
                 lora_targets=("qkv", "proj", "fc_in", "fc_out"),
                 lora_slots=3 if serve else 0)
    if kind == "attn":
        jmod = JMHA(num_heads=4, causal=True, **knobs)
        tmod = MultiHeadAttention(32, 4, causal=True, device="cpu", **knobs)
    else:
        jmod = JMLP(hidden_dim=64, **knobs)
        tmod = MLP(32, 64, device="cpu", **knobs)
    idx = np.array([2, 0, 1], np.int32)
    init_kw = {"adapter_idx": idx} if serve else {}
    variables = _host(jmod.init(jax.random.PRNGKey(seed), x, **init_kw))
    params = variables["params"]
    lora = {}
    for k, v in list(params.items()) + list(variables.get("lora",
                                                          {}).items()):
        if "_lora_" in k:  # real mass in every adapter leaf
            arr = rng.normal(size=v.shape).astype(np.float32) * 0.5
            if serve:
                arr[0] = 0.0  # slot 0: the trash adapter
                lora[k] = arr
            else:
                params[k] = arr
    j_idx = idx if serve else None

    def objective(p, xx):
        out = jmod.apply({"params": p, **({"lora": lora} if serve else {})},
                         xx, adapter_idx=j_idx)
        return (out * w).sum(), out

    grads_too = kind == "attn" and not serve
    if grads_too:
        (_, want), (j_gp, j_gx) = jax.jit(jax.value_and_grad(
            objective, argnums=(0, 1), has_aux=True))(params, x)
    else:
        want = objective(params, x)[1]
    tmod.load_state_dict(mt.params_from_jax({"params": params}))
    for k, v in lora.items():
        getattr(tmod, k).copy_(torch.from_numpy(v))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tmod(tx, adapter_idx=torch.from_numpy(idx.astype(np.int64))
               if serve else None)
    grads = {}
    if grads_too:
        (got * torch.from_numpy(w)).sum().backward()
        grads["x"] = (tx.grad.numpy(), np.asarray(j_gx))
        for k in lora_names(params):
            grads[k] = (getattr(tmod, k).grad.numpy(), np.asarray(j_gp[k]))
    return got.detach().numpy(), np.asarray(want), grads


def lora_names(params):
    return sorted(k for k in params if "_lora_" in k)


@pytest.mark.parametrize("kind", ["attn", "mlp"])
@pytest.mark.parametrize("serve", [False, True], ids=["train", "serve"])
def test_lora_delta_matches_the_jax_layer(kind, serve):
    got, want, grads = _layer_pair(kind, serve, seed=3)
    what = f"{kind} {'serve' if serve else 'train'}"
    _close(got, want, what)
    assert len(grads) == (0 if serve or kind == "mlp" else 5)
    for name, (g, jg) in grads.items():
        _close(g, jg, f"{what} d{name}")


def test_a_zero_b_is_the_base_bitwise():
    base = mt.init_model("gpt2_tiny", seed=0, device="cpu", max_len=64)
    lora = base.clone(share=False, lora_rank=4, lora_alpha=8.0,
                      lora_targets=("qkv", "proj", "fc_in", "fc_out"))
    mt.models.layers.init_lora(lora, seed=0)
    served = base.clone(lora_rank=8, lora_slots=3,
                        lora_targets=("qkv", "proj", "fc_in", "fc_out"))
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 1024, (2, 9)))
    with torch.no_grad():
        want = base(x)
        assert torch.equal(lora(x), want)
        assert torch.equal(served(x, adapter_idx=torch.tensor([0, 0])),
                           want)
    # The serve clone shares the base's tensors; the train clone copies.
    assert (served.blocks[0].attn.qkv.weight.data_ptr()
            == base.blocks[0].attn.qkv.weight.data_ptr())
    assert (lora.blocks[0].attn.qkv.weight.data_ptr()
            != base.blocks[0].attn.qkv.weight.data_ptr())
    assert lora.blocks[0].attn.qkv_lora_A.abs().max() > 0


# ----------------------------------------------------------- the trainer
def test_lora_fit_matches_jax(fits):
    jtr, ttr, _, _, _ = fits
    np.testing.assert_allclose(ttr.history["train_loss"],
                               jtr.history["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(ttr.history["val_loss"],
                               jtr.history["val_loss"], rtol=1e-5)
    want = mt.params_from_jax(_host(jtr.state.params))
    got = ttr.model.state_dict()
    assert set(want) == set(got)
    for name in (k for k in want if "_lora_" in k):
        _close(got[name].numpy(), want[name].numpy(), name, rel=5e-5)
    assert ttr.state.step == int(jtr.state.step) == 4


def test_the_frozen_base_never_moves(fits):
    _, ttr, _, t_init, _ = fits
    after = ttr.model.state_dict()
    moved = [k for k in t_init if "_lora_" in k
             and not torch.equal(after[k], t_init[k])]
    assert len(moved) == 8
    for k, v in t_init.items():
        if "_lora_" not in k:
            assert torch.equal(after[k], v), k
    assert all(p.requires_grad == ("_lora_" in k)
               for k, p in ttr.model.named_parameters())


def test_the_optimizer_state_holds_the_adapters_only(fits):
    jtr, ttr, _, _, _ = fits
    params = dict(ttr.model.named_parameters())
    p_bytes = sum(p.numel() * p.element_size() for p in params.values())
    leaves = mt.ops.optimizers.tree_leaves(ttr.state.opt_state)
    o_bytes = sum(t.numel() * t.element_size() for t in leaves)
    assert o_bytes < 0.2 * 2 * p_bytes
    adam = ttr.state.opt_state["inner_states"]["lora"][1][0]
    assert set(adam["mu"]) == {k for k in params if "_lora_" in k}
    assert ttr.state.opt_state["inner_states"]["frozen"] == {}
    # The JAX state carried over: its masked moments are the port's (the
    # fixture's state is put back after).
    own = {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
           for k, v in _flat_state(ttr).items()}
    load_state_tree(ttr.state, ttr.model, state_from_jax(_host(jtr.state)))
    j_mu = mt.params_from_jax(_unmasked(_host(
        jtr.state.opt_state.inner_states["lora"].inner_state[1][0].mu)))
    for k, v in adam["mu"].items():
        assert torch.equal(ttr.state.opt_state["inner_states"]["lora"][1][0]
                           ["mu"][k], j_mu[k]), k
    for k, t in _flat_state(ttr).items():
        if isinstance(t, torch.Tensor):
            t.copy_(own[k])


def test_a_lora_checkpoint_resumes_bitwise(fits, tmp_path):
    """One epoch at K = 2, then ``fit(resume=True)`` to two: the state
    bitwise the fixture's uninterrupted K = 1 run's (a chunk's steps are
    the single steps), the history equal up to the order of the epoch
    sums; the checkpoint is one the JAX package verifies."""
    _, full, j_init, _, _ = fits
    half = _port_trainer(j_init, tmp_path / "half", steps_per_execution=2,
                         epochs=1)
    half.fit()
    path = os.path.join(tmp_path, "half", "checkpoints", "checkpoint_1")
    jckpt.verify_checkpoint(path)  # the JAX package reads it
    tree, _, epoch = ckpt.restore_checkpoint(path)
    assert epoch == 1 and "inner_states" in tree["opt_state"]
    again = _port_trainer(j_init, tmp_path / "half", steps_per_execution=2)
    again.fit(resume=True)
    for (name, a), b in zip(full.model.state_dict().items(),
                            again.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(mt.ops.optimizers.tree_leaves(full.state.opt_state),
                    mt.ops.optimizers.tree_leaves(again.state.opt_state)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(again.history["train_loss"],
                               full.history["train_loss"], rtol=1e-6)
    assert again.history["val_loss"] == full.history["val_loss"]


def test_the_guard_decides_as_the_jax_guard(fits, tmp_path):
    """The port's guard reads the loss and the adapters' gradients, the
    JAX guard every leaf's.  On the ``nan_grad`` plan (the fixture's
    fits ran under ``nan_grad@step=2``; a token batch cannot carry NaN,
    so both packages take every step) and on a NaN in a frozen base
    leaf (both skip every step and keep the adapters) they agree."""
    jtr, ttr, j_init, _, _ = fits
    assert ttr.history["skipped_steps"] == jtr.history["skipped_steps"]
    assert ttr.history["skipped_steps"] == [0, 0]
    poisoned = jax.tree.map(np.array, j_init)
    poisoned["block1"]["mlp"]["fc_out"]["bias"][3] = np.nan
    state = jtr.state.replace(params=jax.tree.map(
        lambda ref, new: jax.device_put(new, ref.sharding),
        jtr.state.params, poisoned))
    x, y = (np.asarray(a) for a in _sets(True)[0][np.arange(16)])
    for i in range(2):  # the fixture's compiled step, on two batches
        state = jtr._train_step(state, x[i * 8:(i + 1) * 8],
                                y[i * 8:(i + 1) * 8], 1.0)[0]
    assert int(state.skipped_steps) == 2
    t3 = _port_trainer(poisoned, tmp_path / "t3", epochs=1)
    before = {k: v.clone() for k, v in t3.model.state_dict().items()}
    tx, ty = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    for i in range(2):  # the same two batches through the port's step
        t3._train_step(tx[i * 8:(i + 1) * 8], ty[i * 8:(i + 1) * 8], 1.0)
    assert int(t3.state.skipped_steps) == 2
    for k, v in t3.model.state_dict().items():
        assert torch.equal(torch.nan_to_num(v),
                           torch.nan_to_num(before[k])), k
    for k, v in _host(state.params)["block0"]["attn"].items():
        if "_lora_" in k:
            np.testing.assert_array_equal(v, j_init["block0"]["attn"][k])


def test_lora_refusals():
    sets = _sets(False)
    with pytest.raises(ValueError, match="fused update"):
        mt.Trainer("gpt2_tiny", datasets=sets, batch_size=8, device="cpu",
                   lora=LORA, dp_update="sharded")
    for name in ("llama_tiny", "bert_tiny", "vit_tiny"):
        with pytest.raises(ValueError, match="GPT-2 family"):
            mt.Trainer(name, device="cpu", lora=LORA)
    with pytest.raises(ValueError, match="unknown lora target"):
        mt.LoraConfig(targets=("qkv", "embed"))
    tr = mt.Trainer("gpt2_tiny", device="cpu")
    with pytest.raises(ValueError, match="export_lora requires"):
        tr.export_lora("/nonexistent.npz")

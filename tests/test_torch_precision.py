"""Port parity: the bf16 precision policy and dynamic loss scaling of
``ml_trainer_tpu_torch`` (``precision.py`` and its threading through the
``Trainer``) against the JAX package's on the CPU.

* Policy and ``loss_scale`` resolution: the same accepted values, the
  same results and the same error messages (``tests/test_precision.py``'s
  cases, run through both packages).
* The scale arithmetic folded into the non-finite guard: a small MLP
  (flax ``Dense``/``relu`` against ``nn.Linear``/``ReLU``, the same
  weights) trained at bf16 with a NaN sample, under the dynamic scale,
  a short ``growth_interval`` and a static scale.  ``loss_scale``,
  ``good_steps``, ``bad_streak`` and the skipped steps equal exactly;
  losses within 2e-2 relative.
* An fp32 run is bitwise the same with ``precision=None`` and
  ``precision="fp32"``: none of the cast or scale code runs.
* ``Trainer(precision="bf16")`` runs of ``gpt2_tiny`` (the port through
  its flash route, the plain twins of K1-K3 on the CPU) and ``vit_tiny``
  against the JAX ``Trainer`` from the same weights, and a 2-replica
  sharded ``gpt2_tiny`` run (K4/K5's plain versions) against the JAX
  package's 2-device sharded run.  Bars: per-epoch losses within 2e-2
  relative (the JAX package's own bf16 bar, ``tests/test_attention.py``:
  bf16 rounds at other places in the two frameworks, and bf16 keeps 8
  significant bits); ``loss_scale`` and ``good_steps`` equal exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import ml_trainer_tpu as J
import ml_trainer_tpu_torch as mt
from ml_trainer_tpu import precision as jp
from ml_trainer_tpu.data import ArrayDataset as JArray
from ml_trainer_tpu.data import SyntheticCIFAR10 as JCIFAR
from ml_trainer_tpu.data import SyntheticTokens as JTokens
from ml_trainer_tpu.models import get_model as jget_model
from ml_trainer_tpu.utils.functions import (
    custom_pre_process_function as j_custom,
)
from ml_trainer_tpu_torch import precision as tp
from ml_trainer_tpu_torch.data import ArrayDataset as TArray
from test_torch_trainer import _JaxMLP, _port_mlp

LOSS_RTOL = 2e-2
KEYS = ("train_loss", "val_loss")


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _scale_state(tr):
    """(loss_scale, good_steps, bad_streak, skipped) of either package's
    trainer, or None without a scale."""
    s = tr.state
    if s.loss_scale is None:
        return None
    return (float(s.loss_scale), int(s.good_steps), int(s.bad_streak),
            int(s.skipped_steps))


def _assert_losses(jtr, ttr, keys=KEYS):
    for key in keys:
        np.testing.assert_allclose(ttr.history[key], jtr.history[key],
                                   rtol=LOSS_RTOL, err_msg=key)
    assert ttr.history["skipped_steps"] == jtr.history["skipped_steps"]


# ------------------------------------------------------------ resolution
@pytest.mark.parametrize("policy", [None, "fp32", "float32", "bf16",
                                    "bfloat16", "mixed_bf16", "BF16", "fp8"])
def test_policy_resolution_matches_jax(policy):
    try:
        want = jp.resolve_precision(policy)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tp.resolve_precision(policy)
        assert str(got.value) == str(err)
        return
    got = tp.resolve_precision(policy)
    assert got.active == want.active
    assert got.label() == want.label()
    assert got.params == torch.float32
    assert got.output == torch.float32
    assert tp.resolve_precision(got) is got


def test_non_fp32_master_params_are_refused_alike():
    with pytest.raises(ValueError, match="params") as want:
        jp.resolve_precision(jp.Precision(params=jax.numpy.bfloat16))
    with pytest.raises(ValueError, match="params") as got:
        tp.resolve_precision(tp.Precision(params=torch.bfloat16))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("loss_scale", ["dynamic", "DYNAMIC", None, 1024.0,
                                        3, -1.0, 0.0, "auto", "config"])
def test_loss_scale_resolution_matches_jax(policy, loss_scale):
    j_arg = t_arg = loss_scale
    if loss_scale == "config":
        j_arg = jp.LossScaleConfig(growth_interval=7, init_scale=8.0)
        t_arg = tp.LossScaleConfig(growth_interval=7, init_scale=8.0)
    j_policy, t_policy = (jp.resolve_precision(policy),
                          tp.resolve_precision(policy))
    try:
        want = jp.resolve_loss_scale(j_arg, j_policy)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tp.resolve_loss_scale(t_arg, t_policy)
        assert str(got.value) == str(err)
        return
    got = tp.resolve_loss_scale(t_arg, t_policy)
    if want is None:
        assert got is None
    else:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if policy == "fp32":
        assert got is None  # the scale never enters the fp32 program


def test_cast_floating_skips_integers_and_cast_like_restores():
    tree = {"w": torch.ones(2), "ids": torch.ones(2, dtype=torch.int32),
            "pair": (torch.zeros(3, dtype=torch.float64), 5)}
    out = tp.cast_floating(tree, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int32
    assert out["pair"][0].dtype == torch.bfloat16 and out["pair"][1] == 5
    back = tp.cast_like(out, tree)
    assert back["w"].dtype == torch.float32
    assert back["pair"][0].dtype == torch.float64
    assert back["ids"].dtype == torch.int32


def test_loss_scale_without_the_guard_is_refused_alike():
    kw = dict(precision="bf16", nonfinite_guard=False)
    with pytest.raises(ValueError) as want:
        J.Trainer(_JaxMLP(), backend="cpu", **kw)
    with pytest.raises(ValueError) as got:
        mt.Trainer(_port_mlp({"Dense_0": {"kernel": np.zeros((5, 8)),
                                          "bias": np.zeros(8)},
                              "Dense_1": {"kernel": np.zeros((8, 2)),
                                          "bias": np.zeros(2)}}),
                   device="cpu", **kw)
    assert str(got.value) == str(want.value)
    assert "nonfinite_guard" in str(got.value)
    # Bare bf16 without the guard is fine in both.
    mt.Trainer("gpt2_tiny", device="cpu", precision="bf16", loss_scale=None,
               nonfinite_guard=False)


# -------------------------------------------------- the scale arithmetic
def _mlp_pair(tmp_path, poison, epochs, **kw):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(24, 5)).astype(np.float32)
    y = rng.normal(size=(24, 2)).astype(np.float32)
    if poison:
        x[7, 2] = np.nan  # one poisoned sample: its batch is skipped
    xv = rng.normal(size=(8, 5)).astype(np.float32)
    yv = rng.normal(size=(8, 2)).astype(np.float32)
    common = dict(epochs=epochs, batch_size=4, optimizer="adam", lr=1e-2,
                  criterion="l2", metric="mcrmse", pred_function=None,
                  grad_clip_norm=5.0, precision="bf16")
    j_kw = {k: (v[0] if isinstance(v, tuple) else v) for k, v in kw.items()}
    t_kw = {k: (v[1] if isinstance(v, tuple) else v) for k, v in kw.items()}
    jtr = J.Trainer(_JaxMLP(), datasets=(JArray(x, y), JArray(xv, yv)),
                    backend="cpu", loader="python",
                    model_dir=str(tmp_path / "j"), **common, **j_kw)
    ttr = mt.Trainer(_port_mlp(_host(jtr.state.params)),
                     datasets=(TArray(x, y), TArray(xv, yv)), device="cpu",
                     model_dir=str(tmp_path / "t"), **common, **t_kw)
    jtr.fit()
    ttr.fit()
    _assert_losses(jtr, ttr, KEYS + ("train_metric", "val_metric"))
    assert _scale_state(ttr) == _scale_state(jtr)
    assert int(ttr.state.bad_streak) == int(jtr.state.bad_streak)
    return jtr, ttr


def test_dynamic_scale_halves_on_overflow_without_burning_rollback(tmp_path):
    """The poisoned batch is skipped in each of 2 epochs: the scale halves
    twice (from 2^15: the default growth interval is not reached), the
    rollback streak is not advanced, and only ``step`` moves over the
    skipped batches."""
    jtr, ttr = _mlp_pair(tmp_path, poison=True, epochs=2)
    assert ttr.history["skipped_steps"] == [1, 1]
    scale, _, streak, skipped = _scale_state(ttr)
    assert (scale, streak, skipped) == (2.0 ** 13, 0, 2)
    assert ttr.state.step == int(jtr.state.step) == 12
    assert int(ttr.state.opt_state[1][0]["count"]) == 10


def test_scale_grows_after_a_short_growth_interval(tmp_path):
    """growth_interval=2 over 6 finite steps: the scale doubles three
    times and the counter restarts each time."""
    cfg = (jp.LossScaleConfig(init_scale=2.0 ** 10, growth_interval=2),
           tp.LossScaleConfig(init_scale=2.0 ** 10, growth_interval=2))
    _, ttr = _mlp_pair(tmp_path, poison=False, epochs=1, loss_scale=cfg)
    assert ttr.history["skipped_steps"] == [0]
    assert _scale_state(ttr) == (2.0 ** 13, 0, 0, 0)


def test_static_scale_never_moves(tmp_path):
    """A float scale pins min == max: an overflow skips the step without
    backing off, so it counts against the rollback streak as at fp32."""
    _, ttr = _mlp_pair(tmp_path, poison=True, epochs=1, loss_scale=128.0)
    assert ttr.history["skipped_steps"] == [1]
    assert _scale_state(ttr)[0] == 128.0


def test_bare_bf16_keeps_no_scale_state(tmp_path):
    _, ttr = _mlp_pair(tmp_path, poison=True, epochs=1, loss_scale=None)
    assert ttr.state.loss_scale is None and ttr.state.good_steps is None
    assert int(ttr.state.bad_streak) == 0  # the skip was not the last step


# ----------------------------------------------------------- fp32 intact
def test_fp32_run_is_bitwise_the_same_with_precision_none_and_fp32(tmp_path):
    sets = (mt.SyntheticTokens(size=8, seq_len=64, vocab_size=256),
            mt.SyntheticTokens(size=4, seq_len=64, vocab_size=256, seed=1))
    runs = []
    for i, precision in enumerate((None, "fp32")):
        model = mt.init_model("gpt2_tiny", seed=0, device="cpu",
                              vocab_size=256, max_len=64)
        tr = mt.Trainer(model, datasets=sets, epochs=1, batch_size=4,
                        grad_accum_steps=2, optimizer="adamw", lr=1e-3,
                        grad_clip_norm=1.0, device="cpu",
                        model_dir=str(tmp_path / str(i)),
                        precision=precision)
        assert tr.state.loss_scale is None and tr.model.dtype == torch.float32
        tr.fit()
        runs.append(tr)
    a, b = runs
    assert a.history == b.history
    for (name, p), q in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(p, q), name


# ------------------------------------------------ the families in bf16
GPT_KW = dict(epochs=2, batch_size=8, grad_accum_steps=2, optimizer="adamw",
              lr=3e-4, weight_decay=0.01, grad_clip_norm=1.0)


def _fit_pair(j_model, t_model, j_sets, t_sets, tmp_path, jax_devices=None,
              t_device="cpu", **kw):
    """The JAX trainer and the port's at ``precision="bf16"``, the port's
    model given the JAX trainer's initial (float32) params.  With
    ``jax_devices`` the JAX trainer is built over the first that many
    host devices."""
    with pytest.MonkeyPatch.context() as mp:
        if jax_devices:
            real = jax.devices
            mp.setattr(jax, "devices",
                       lambda *a, **k: real(*a, **k)[:jax_devices])
        jtr = J.Trainer(j_model, datasets=j_sets, backend="cpu",
                        loader="python", model_dir=str(tmp_path / "j"),
                        precision="bf16", **kw)
    t_model.load_state_dict(mt.params_from_jax(_host(
        {"params": jtr.state.params})))
    ttr = mt.Trainer(t_model, datasets=t_sets, device=t_device,
                     loader="python", model_dir=str(tmp_path / "t"),
                     precision="bf16", **kw)
    jtr.fit()
    ttr.fit()
    return jtr, ttr


def test_gpt2_tiny_bf16_flash_route_matches_jax(tmp_path):
    seq, vocab = 128, 1024
    j_sets = (JTokens(size=16, seq_len=seq, vocab_size=vocab),
              JTokens(size=8, seq_len=seq, vocab_size=vocab, seed=1))
    t_sets = (mt.SyntheticTokens(size=16, seq_len=seq, vocab_size=vocab),
              mt.SyntheticTokens(size=8, seq_len=seq, vocab_size=vocab,
                                 seed=1))
    model = mt.get_model("gpt2_tiny", device="cpu", attention_impl="flash")
    jtr, ttr = _fit_pair(jget_model("gpt2_tiny"), model, j_sets, t_sets,
                         tmp_path, **GPT_KW)
    # The Trainer rebuilt the float32 registry model at bf16 compute.
    assert ttr.model.dtype == torch.bfloat16
    assert ttr.model.attention_impl == "flash"
    assert {p.dtype for p in ttr.model.parameters()} == {torch.float32}
    _assert_losses(jtr, ttr, KEYS + ("train_metric", "val_metric"))
    assert _scale_state(ttr) == _scale_state(jtr) == (2.0 ** 15, 4, 0, 0)


def test_vit_tiny_bf16_matches_jax(tmp_path):
    t = mt.custom_pre_process_function()
    j_t = j_custom()
    j_sets = (JCIFAR(size=16, transform=j_t), JCIFAR(size=8, transform=j_t,
                                                     seed=1))
    t_sets = (mt.SyntheticCIFAR10(size=16, transform=t),
              mt.SyntheticCIFAR10(size=8, transform=t, seed=1))
    jtr, ttr = _fit_pair(jget_model("vit_tiny"),
                         mt.get_model("vit_tiny", device="cpu"), j_sets,
                         t_sets, tmp_path, epochs=2, batch_size=8,
                         optimizer="adam", lr=3e-4)
    assert ttr.model.dtype == torch.bfloat16
    _assert_losses(jtr, ttr, KEYS + ("train_metric", "val_metric"))
    assert _scale_state(ttr) == _scale_state(jtr)


def test_two_replica_sharded_bf16_matches_jax_two_devices(tmp_path):
    """The sharded step (K4/K5's plain versions, the loss scale folded
    into K4's denominator) on 2 replicas against the JAX package's
    sharded step on 2 host devices."""
    seq, vocab = 64, 1020
    j_sets = (JTokens(size=16, seq_len=seq, vocab_size=vocab),
              JTokens(size=8, seq_len=seq, vocab_size=vocab, seed=1))
    t_sets = (mt.SyntheticTokens(size=16, seq_len=seq, vocab_size=vocab),
              mt.SyntheticTokens(size=8, seq_len=seq, vocab_size=vocab,
                                 seed=1))
    kw = dict(epochs=2, batch_size=8, grad_accum_steps=2, optimizer="adam",
              lr=3e-4, grad_clip_norm=1.0, is_parallel=True,
              dp_update="sharded")
    jtr, ttr = _fit_pair(jget_model("gpt2_tiny", vocab_size=vocab),
                         mt.get_model("gpt2_tiny", vocab_size=vocab,
                                      device="cpu"),
                         j_sets, t_sets, tmp_path, jax_devices=2,
                         t_device=["cpu"] * 2, **kw)
    assert jtr.mesh.shape["data"] == 2 and jtr.fused_adam
    assert ttr.mesh.size == 2 and ttr.fused_adam
    _assert_losses(jtr, ttr, KEYS + ("train_metric", "val_metric"))
    assert _scale_state(ttr) == _scale_state(jtr)

"""``Trainer.export_torch`` and the flax-layout view of the port's
weights (``convert.variables_to_jax``), against the JAX package, on the
CPU.

* ``variables_to_jax`` inverts ``params_from_jax`` for every family: the
  JAX init's flax paths, dtypes and arrays, bitwise (GPT-2 with
  adapters, MLModel, ResNet-18, BERT, ViT, Llama).
* ``export_torch`` writes the ``model.pth`` of the JAX package's
  ``export_torch`` for MLModel (the same keys, bitwise the same arrays),
  with and without ``ddp_prefix``, from the weights and from the EMA;
  the file loads into the reference-layout ``nn.Module`` (``C*H*W``
  flatten order at ``fc1``).  Where the JAX export raises (the nested
  trees of ResNet-18 and GPT-2) the port raises the same ``ValueError``.
"""

import jax
import numpy as np
import pytest
import torch

import ml_trainer_tpu as J
import ml_trainer_tpu_torch as mt
from ml_trainer_tpu.checkpoint.torch_export import (
    save_torch_checkpoint as j_save,
)
from ml_trainer_tpu.data import SyntheticCIFAR10 as JCIFAR
from ml_trainer_tpu.models import get_model as jget_model
from ml_trainer_tpu_torch.convert import state_from_jax, variables_to_jax
from ml_trainer_tpu_torch.train_state import load_state_tree


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _flat(tree):
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name,x,kw", [
    ("gpt2_tiny", np.zeros((1, 8), np.int32),
     dict(lora_rank=4, lora_alpha=8.0, lora_targets=("qkv", "fc_out"))),
    ("mlmodel", np.zeros((1, 32, 32, 3), np.float32), {}),
    ("resnet18", np.zeros((1, 32, 32, 3), np.float32), {}),
    ("bert_tiny", np.zeros((1, 8), np.int32), {}),
    ("vit_tiny", np.zeros((1, 32, 32, 3), np.float32), {}),
    ("llama_tiny", np.zeros((1, 8), np.int32), {}),
])
def test_variables_to_jax_inverts_params_from_jax(name, x, kw):
    # The JAX init's tree (traced, not run) with distinct random values.
    shapes = jax.eval_shape(lambda: jget_model(name, **kw).init(
        {"params": jax.random.PRNGKey(0)}, x, train=False))
    rng = np.random.default_rng(0)
    variables = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), dict(shapes))
    model = mt.get_model(name, device="cpu", **kw)
    model.load_state_dict(mt.params_from_jax(variables))
    back = variables_to_jax(model)
    for col in ("params", "batch_stats"):
        want, got = _flat(variables.get(col, {})), _flat(back[col])
        assert list(got) == list(want), col
        for path, w in want.items():
            assert got[path].dtype == w.dtype, path
            np.testing.assert_array_equal(got[path], w, err_msg=path)


@pytest.fixture(scope="module")
def mlmodel_pair(tmp_path_factory):
    """A JAX trainer with an EMA (drawn apart from the weights) and a port
    trainer on the same weights and EMA, MLModel."""
    d = tmp_path_factory.mktemp("export")
    kw = dict(epochs=1, batch_size=4, ema_decay=0.9)
    jtr = J.Trainer(jget_model("mlmodel"),
                    datasets=(JCIFAR(size=8), JCIFAR(size=8, seed=1)),
                    backend="cpu", model_dir=str(d / "j"), **kw)
    rng = np.random.default_rng(1)
    jtr.state = jtr.state.replace(ema_params=jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape)
                   ).astype(np.float32), jtr.state.params))
    ttr = mt.Trainer(mt.get_model("mlmodel", device="cpu"),
                     datasets=(mt.SyntheticCIFAR10(size=8),
                               mt.SyntheticCIFAR10(size=8, seed=1)),
                     device="cpu", model_dir=str(d / "t"), **kw)
    load_state_tree(ttr.state, ttr.model, state_from_jax(_host(jtr.state)))
    return jtr, ttr


@pytest.mark.parametrize("ddp_prefix", [False, True], ids=["plain", "ddp"])
@pytest.mark.parametrize("ema", [False, True], ids=["weights", "ema"])
def test_export_torch_is_the_jax_export_for_mlmodel(mlmodel_pair, tmp_path,
                                                    ddp_prefix, ema):
    """With the EMA, the JAX trainer's ``export_torch``; without, what it
    writes for a trainer without one (``save_torch_checkpoint`` of the
    params), against the port trainer's, with ``ema_decay`` set and not."""
    jtr, ttr = mlmodel_pair
    if ema:
        want = torch.load(jtr.export_torch(str(tmp_path / "j.pth"),
                                           ddp_prefix=ddp_prefix))
    else:
        want = torch.load(j_save(str(tmp_path / "j.pth"),
                                 {"params": _host(jtr.state.params)},
                                 ddp_prefix=ddp_prefix))
    saved_ema, saved_decay = ttr.state.ema_params, ttr.ema_decay
    if not ema:  # the port trainer without an EMA: its own weights
        ttr.state.ema_params, ttr.ema_decay = None, None
    try:
        got = torch.load(ttr.export_torch(str(tmp_path / "t.pth"),
                                          ddp_prefix=ddp_prefix))
    finally:
        ttr.state.ema_params, ttr.ema_decay = saved_ema, saved_decay
    assert list(got) == list(want) and len(got) == 10
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    assert all(k.startswith("module.") == ddp_prefix for k in got)
    # fc1 un-permuted to the reference's C*H*W flatten: a reference-layout
    # torch MLModel on the exported weights computes the port's logits.
    ref = torch.nn.Sequential()
    ref.conv1, ref.conv2 = torch.nn.Conv2d(3, 6, 5), torch.nn.Conv2d(6, 16, 5)
    ref.fc1, ref.fc2 = torch.nn.Linear(400, 120), torch.nn.Linear(120, 84)
    ref.fc3 = torch.nn.Linear(84, 10)
    ref.load_state_dict({k.removeprefix("module."): v
                         for k, v in got.items()})
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    pool = torch.nn.functional.max_pool2d
    h = pool(torch.relu(ref.conv1(x.permute(0, 3, 1, 2))), 2)
    h = pool(torch.relu(ref.conv2(h)), 2).flatten(1)
    h = torch.relu(ref.fc2(torch.relu(ref.fc1(h))))
    with torch.no_grad():
        port = ttr.model(x) if not ema else torch.func.functional_call(
            ttr.model, ttr.state.ema_params, (x,))
        torch.testing.assert_close(ref.fc3(h), port, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["resnet18", "gpt2_tiny"])
def test_nested_trees_raise_as_in_jax(tmp_path, name):
    """The JAX package's ``export_torch`` writes through
    ``save_torch_checkpoint``, which refuses these trees; so does the
    port's."""
    if name == "gpt2_tiny":
        sets = (mt.SyntheticTokens(size=8, seq_len=8, vocab_size=64),) * 2
        kw = dict(vocab_size=64)
    else:
        sets = (mt.SyntheticCIFAR10(size=8),) * 2
        kw = {}
    ttr = mt.Trainer(mt.get_model(name, device="cpu", **kw), datasets=sets,
                     batch_size=4, metric=None, device="cpu",
                     model_dir=str(tmp_path / "t"))
    with pytest.raises(ValueError, match="nested module"):
        j_save(str(tmp_path / "j.pth"), variables_to_jax(ttr.model))
    with pytest.raises(ValueError, match="nested module"):
        ttr.export_torch(str(tmp_path / "t.pth"))

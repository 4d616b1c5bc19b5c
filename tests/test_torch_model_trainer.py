"""Port parity: short ``Trainer`` runs of the image and encoder families
against the JAX package's ``Trainer`` on the CPU, the JAX trainer's
initial variables injected into the port through ``params_from_jax``.

Runs (seeded numpy data, the same batches in both packages):

* ``MLModel``, sgd + momentum, cosine restarts, on ``SyntheticCIFAR10``
  through ``custom_pre_process_function``;
* ``resnet18`` (cifar stem) on 16x16 inputs, batch 8, 2 steps, sgd +
  momentum; validation runs in eval mode on the running statistics;
* ``bert_tiny`` at 128 wide, 2 heads (head_dim 64), S = 128,
  ``right_padded``, adamw: the port trains through its flash route (the
  plain twins of K1-K3 on the CPU);
* ``vit_tiny``, adam at lr 3e-4 (the GPT-2 run's rate, under which the
  key bias's Adam noise stays within its 1e-3 bar over 4 steps);
* a small BatchNorm model with one poisoned sample: the skipped step
  reverts the running statistics too;
* the same BatchNorm model on 2 replicas with the fused data-parallel
  step against the JAX package's data-parallel run: statistics over each
  GLOBAL microbatch (SyncBN), one running update per microbatch.

Bars: per-epoch losses and metrics rtol 1e-4 (as
``tests/test_torch_trainer.py``); params atol 1e-4 (the attention's key
bias 1e-3: its gradient is rounding noise that Adam turns into up to ~lr
a step, as in that file); running statistics rtol 1e-4 / atol 1e-5.
ResNet-18's params take atol 1e-3 (observed 1.8e-4): in train mode the
reference's float32 gradients sit up to 0.6% of a leaf's largest entry
away from a float64 evaluation (its BatchNorm variance is E[x^2] -
E[x]^2), where the port's sit within 1e-5;
``test_resnet18_gradients_against_float64`` holds both to that.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import ml_trainer_tpu as J
import ml_trainer_tpu_torch as mt
from ml_trainer_tpu.data import ArrayDataset as JArray
from ml_trainer_tpu.data import SyntheticCIFAR10 as JCIFAR
from ml_trainer_tpu.data import transforms as jt
from ml_trainer_tpu.models import get_model as jget_model
from ml_trainer_tpu.models.mlmodel import MLModel as JMLModel
from ml_trainer_tpu.utils.functions import (
    custom_pre_process_function as j_custom,
)
from ml_trainer_tpu_torch.data import ArrayDataset as TArray
from ml_trainer_tpu_torch.data import transforms as tt
from ml_trainer_tpu_torch.models.layers import BatchNorm, Conv

KEYS = ("train_loss", "val_loss", "train_metric", "val_metric")
STATS_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: small ops otherwise wait on all cores'
    threads, which the suite's other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _variables(jtr):
    out = {"params": _host(jtr.state.params)}
    if jtr.state.batch_stats:
        out["batch_stats"] = _host(jtr.state.batch_stats)
    return out


def _run_pair(j_model, port_name, j_sets, t_sets, tmp_path, port_kw=None,
              **kw):
    """Fit the JAX trainer and the port's, the port's model built from
    the registry with the JAX trainer's initial variables."""
    jtr = J.Trainer(j_model, datasets=j_sets, backend="cpu",
                    loader="python", model_dir=str(tmp_path / "j"), **kw)
    if isinstance(port_name, str):
        model = mt.get_model(port_name, device="cpu", **(port_kw or {}))
    else:
        model = port_name
    model.load_state_dict(mt.params_from_jax(_variables(jtr)))
    ttr = mt.Trainer(model, datasets=t_sets, device="cpu", loader="python",
                     model_dir=str(tmp_path / "t"), **kw)
    jtr.fit()
    ttr.fit()
    return jtr, ttr


def _assert_history(jtr, ttr, rtol=1e-4):
    for key in KEYS:
        np.testing.assert_allclose(ttr.history[key], jtr.history[key],
                                   rtol=rtol, atol=1e-7, err_msg=key)
    assert ttr.history["skipped_steps"] == jtr.history["skipped_steps"]
    assert ttr.state.step == int(jtr.state.step)


def _assert_state(jtr, ttr, width=None, atol=1e-4):
    want = mt.params_from_jax(_variables(jtr))
    got = ttr.model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if "running_" in name:
            torch.testing.assert_close(g, w, **STATS_TOL, msg=name)
            continue
        if width and name.endswith("attn.qkv.bias"):
            e = width
            torch.testing.assert_close(g[e:2 * e], w[e:2 * e], atol=1e-3,
                                       rtol=0, msg=name)
            g, w = torch.cat([g[:e], g[2 * e:]]), torch.cat([w[:e], w[2 * e:]])
        torch.testing.assert_close(g, w, atol=atol, rtol=0, msg=name)


def _images(seed, n, side, classes=10):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(n, side, side, 3), dtype=np.uint8)
    return x, rng.integers(0, classes, size=n).astype(np.int32)


def _image_sets(side, n_train, n_val, transform_of):
    (x, y), (xv, yv) = _images(0, n_train, side), _images(1, n_val, side)
    j = (JArray(x, y, transform_of(jt)), JArray(xv, yv, transform_of(jt)))
    t = (TArray(x, y, transform_of(tt)), TArray(xv, yv, transform_of(tt)))
    return j, t


def _to_float(m):
    return m.Compose([m.ToFloat(), m.Normalize((0.5,) * 3, (0.25,) * 3)])


# ----------------------------------------------------------------- MLModel
def test_mlmodel_trainer_matches_jax(tmp_path):
    j_sets = (JCIFAR(size=32, transform=j_custom()),
              JCIFAR(size=16, transform=j_custom(), seed=1))
    t_sets = (mt.SyntheticCIFAR10(size=32,
                                  transform=mt.custom_pre_process_function()),
              mt.SyntheticCIFAR10(size=16, seed=1,
                                  transform=mt.custom_pre_process_function()))
    jtr, ttr = _run_pair(JMLModel(), mt.MLModel(device="cpu"), j_sets,
                         t_sets, tmp_path, epochs=2, batch_size=8,
                         optimizer="sgd", momentum=0.9, lr=0.01,
                         scheduler="CosineAnnealingWarmRestarts")
    _assert_history(jtr, ttr)
    _assert_state(jtr, ttr)


# ------------------------------------------------------------------ ResNet
def test_resnet18_trainer_matches_jax_and_validates_on_running_stats(
        tmp_path):
    j_sets, t_sets = _image_sets(16, 16, 8, _to_float)
    jtr, ttr = _run_pair(jget_model("resnet18"), "resnet18", j_sets, t_sets,
                         tmp_path, epochs=1, batch_size=8, optimizer="sgd",
                         momentum=0.9, lr=0.01)
    assert ttr.state.step == 2
    _assert_history(jtr, ttr)
    _assert_state(jtr, ttr, atol=1e-3)
    # Validation ran on the running statistics (eval mode): the history's
    # val loss is the eval-mode loss, which train mode would not give.
    x, y = next(iter(mt.Loader(t_sets[1], batch_size=8)))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    model = ttr.model
    with torch.no_grad():
        eval_loss = float(ttr.criterion(model.eval()(xt), yt))
        train_loss = float(ttr.criterion(model.train()(xt), yt))
    np.testing.assert_allclose(eval_loss, ttr.history["val_loss"][0],
                               rtol=1e-5)
    assert abs(train_loss - eval_loss) > 1e-3


def test_resnet18_gradients_against_float64():
    """One train-mode batch of 8 at 16x16: the port's float32 gradients
    within 1e-5 of each leaf's largest entry of the port's float64 ones;
    the reference's float32 gradients within 1e-2 (observed 6.1e-3)."""
    x, y = _images(0, 8, 16)
    x = _to_float(jt)(x, None)
    j_model = jget_model("resnet18")
    variables = j_model.init(jax.random.PRNGKey(0), x, train=False)

    def j_loss(params):
        out, _ = j_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(out),
                                             y[:, None], axis=1))

    j_grads = mt.params_from_jax(_host(jax.grad(j_loss)(
        variables["params"])))

    def port_grads(dtype):
        model = mt.get_model("resnet18", device="cpu")
        model.load_state_dict(mt.params_from_jax(_host(variables)))
        model = model.to(dtype).train()
        loss = torch.nn.functional.cross_entropy(
            model(torch.from_numpy(x).to(dtype)), torch.from_numpy(y).long())
        loss.backward()
        return {k: p.grad.double() for k, p in model.named_parameters()}

    g32, g64 = port_grads(torch.float32), port_grads(torch.float64)
    assert set(g64) == set(j_grads)
    for name, ref in g64.items():
        top = float(ref.abs().max())
        assert float((g32[name] - ref).abs().max()) <= 1e-5 * top, name
        assert float((j_grads[name].double() - ref).abs().max()) <= (
            1e-2 * top), name


# -------------------------------------------------------------------- BERT
def test_bert_tiny_right_padded_trainer_matches_jax(tmp_path):
    kw = dict(embed_dim=128, num_heads=2, max_len=128, right_padded=True)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 1024, size=(24, 128)).astype(np.int32)
    lens = rng.integers(8, 129, size=24)
    ids[np.arange(128)[None, :] >= lens[:, None]] = 0
    labels = rng.integers(0, 2, size=24).astype(np.int32)
    j_sets = (JArray(ids[:16], labels[:16]), JArray(ids[16:], labels[16:]))
    t_sets = (TArray(ids[:16], labels[:16]), TArray(ids[16:], labels[16:]))
    jtr, ttr = _run_pair(jget_model("bert_tiny", **kw), "bert_tiny", j_sets,
                         t_sets, tmp_path, port_kw=kw, epochs=2,
                         batch_size=8, optimizer="adamw", lr=2e-4,
                         weight_decay=0.01)
    _assert_history(jtr, ttr)
    _assert_state(jtr, ttr, width=128)


# --------------------------------------------------------------------- ViT
def test_vit_tiny_trainer_matches_jax(tmp_path):
    j_sets, t_sets = _image_sets(32, 16, 8, _to_float)
    jtr, ttr = _run_pair(jget_model("vit_tiny"), "vit_tiny", j_sets, t_sets,
                         tmp_path, epochs=2, batch_size=8, optimizer="adam",
                         lr=3e-4)
    _assert_history(jtr, ttr)
    _assert_state(jtr, ttr, width=128)


# ------------------------------------------------- a small BatchNorm model
class _JaxBN(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.Conv(4, (3, 3), strides=(2, 2), padding="SAME",
                     name="conv")(x)
        x = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                          name="bn")(x)
        return fnn.Dense(3, name="head")(jnp.mean(fnn.relu(x), axis=(1, 2)))


class _PortBN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Conv(3, 4, 3, 2, device="cpu")
        self.bn = BatchNorm(4, device="cpu")
        self.head = nn.Linear(4, 3, device="cpu")

    def forward(self, x):
        x = self.bn(self.conv(x.permute(0, 3, 1, 2)))
        return self.head(torch.relu(x).mean(dim=(2, 3)))


def _bn_data(n, seed, poison=None):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 8, 8, 3)) * 2 + 1).astype(np.float32)
    if poison is not None:
        x[poison, 3, 3, 1] = np.nan
    return x, rng.integers(0, 3, size=n).astype(np.int32)


BN_KW = dict(optimizer="sgd", momentum=0.9, lr=0.05)


def test_poisoned_batch_reverts_batch_norm_statistics_alike(tmp_path):
    (x, y), (xv, yv) = _bn_data(24, 0, poison=9), _bn_data(8, 1)
    jtr, ttr = _run_pair(_JaxBN(), _PortBN(), (JArray(x, y), JArray(xv, yv)),
                         (TArray(x, y), TArray(xv, yv)), tmp_path,
                         epochs=2, batch_size=8, **BN_KW)
    assert jtr.history["skipped_steps"] == [1, 1]
    _assert_history(jtr, ttr, rtol=1e-5)
    _assert_state(jtr, ttr)
    stats = ttr.model.bn.running_var
    assert bool(torch.isfinite(stats).all())


def _dp_pair(tmp_path, per_replica=False):
    """The BatchNorm model on the fused data-parallel step: the JAX
    package's run over a {"data": 2} axis of its host mesh, and the
    port's over 2 replicas that share the CPU; ``per_replica`` puts the
    port back on the per-replica-block path."""
    (x, y), (xv, yv) = _bn_data(32, 2), _bn_data(16, 3)
    kw = dict(epochs=2, batch_size=16, grad_accum_steps=2, is_parallel=True,
              **BN_KW)
    jtr = J.Trainer(_JaxBN(), datasets=(JArray(x, y), JArray(xv, yv)),
                    backend="cpu", loader="python",
                    mesh_shape={"data": 2, "tensor": 4},
                    model_dir=str(tmp_path / "j"), **kw)
    model = _PortBN()
    model.load_state_dict(mt.params_from_jax(_variables(jtr)))
    ttr = mt.Trainer(model, datasets=(TArray(x, y), TArray(xv, yv)),
                     device=["cpu"] * 2, model_dir=str(tmp_path / "t"), **kw)
    assert ttr.mesh.size == 2 and ttr._has_batch_norm
    if per_replica:
        ttr._has_batch_norm = False
    jtr.fit()
    ttr.fit()
    return jtr, ttr


def test_fused_dp_batch_norm_uses_global_microbatch_statistics(tmp_path):
    jtr, ttr = _dp_pair(tmp_path)
    assert jtr.mesh.shape["data"] == 2
    _assert_history(jtr, ttr)
    _assert_state(jtr, ttr)


def test_per_replica_batch_norm_would_not_match_jax(tmp_path):
    """The fault the global-microbatch path repairs: per-replica blocks
    normalise with per-replica statistics and update the running
    statistics once per replica."""
    jtr, ttr = _dp_pair(tmp_path, per_replica=True)
    want = mt.params_from_jax(_variables(jtr))["bn.running_var"]
    got = ttr.model.bn.running_var
    assert not torch.allclose(got, want, **STATS_TOL)
    with pytest.raises(AssertionError):
        _assert_history(jtr, ttr)

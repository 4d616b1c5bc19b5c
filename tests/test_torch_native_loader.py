"""Port parity: ``ml_trainer_tpu_torch.data.native`` (the C++ batch worker
behind ctypes) and the Trainer's loader selection, against the JAX
package on the CPU.

Both packages drive the same ``csrc/batch_worker.cpp``; the port builds
its own copy under ``build/native/`` (named by a hash of the sources),
never the JAX package's ``csrc/libbatch_worker.so``.  On the same seeded
``SyntheticCIFAR10`` the port's ``NativeLoader`` must give the JAX
``NativeLoader``'s batches bit for bit: pad 4 with flip over two epochs,
a ragged tail with ``drop_last=False`` (wrapped), and a
``ShardedSampler``.  With ``pad=0, flip=False`` its batches equal the
port's ``ToFloat + Normalize`` within 1e-5 (the C++ pass multiplies by
1/255 and 1/std where numpy divides).  ``loader='auto'`` must pick the
pipeline the JAX ``Trainer`` picks for the same dataset, and
``loader='native'`` must refuse what the JAX package refuses, with its
message.  A short ``fit()`` through the native loader matches the JAX
trainer's native ``fit()`` (rtol 1e-4, float32 throughout), and a
preempted native run resumes bit for bit.
"""

import jax
import numpy as np
import pytest

import ml_trainer_tpu as J
import ml_trainer_tpu_torch as mt
from ml_trainer_tpu.data import native as jnative
from ml_trainer_tpu.data import sampler as jsampler
from ml_trainer_tpu.data import transforms as jtf
from ml_trainer_tpu.data.datasets import ArrayDataset as JArray
from ml_trainer_tpu.data.datasets import SyntheticCIFAR10 as JCIFAR
from ml_trainer_tpu.models import get_model as jget_model
from ml_trainer_tpu.utils.functions import custom_pre_process_function as jc
from ml_trainer_tpu_torch.data import native as tnative
from ml_trainer_tpu_torch.data import transforms as ttf
from ml_trainer_tpu_torch.data.datasets import ArrayDataset as TArray
from ml_trainer_tpu_torch.data.loader import Loader
from ml_trainer_tpu_torch.data.sampler import ShardedSampler
from ml_trainer_tpu_torch.resilience import faults


def _batches(loader, epochs=(0,)):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        out.extend((x.copy(), y.copy()) for x, y in loader)
    return out


def _assert_bitwise(got, want):
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.float32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_library_builds_into_build_native_not_csrc():
    lib = tnative.load_library()
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    assert path.name.startswith("libbatch_worker-")
    assert lib._name == str(path)
    assert tnative.native_available()


@pytest.mark.parametrize("case", [
    dict(pad=4, flip=True, seed=5, kw={}),
    dict(pad=0, flip=True, seed=1, kw=dict(shuffle=False)),
    dict(pad=4, flip=False, seed=2, kw=dict(num_threads=1, queue_cap=1)),
])
def test_augmented_batches_bitwise_the_jax_loader_over_two_epochs(case):
    size = 96
    kw = dict(batch_size=16, pad=case["pad"], flip=case["flip"],
              seed=case["seed"], **case["kw"])
    got = _batches(tnative.NativeLoader(mt.SyntheticCIFAR10(size=size,
                                                            seed=3), **kw),
                   (0, 1))
    want = _batches(jnative.NativeLoader(JCIFAR(size=size, seed=3), **kw),
                    (0, 1))
    _assert_bitwise(got, want)
    # A new epoch reshuffles or redraws: epoch 1 differs from epoch 0.
    n = len(got) // 2
    assert not all(np.array_equal(a[0], b[0])
                   for a, b in zip(got[:n], got[n:]))


def test_ragged_tail_wraps_like_the_jax_loader():
    kw = dict(batch_size=16, seed=7, drop_last=False)
    t = tnative.NativeLoader(mt.SyntheticCIFAR10(size=50, seed=4), **kw)
    j = jnative.NativeLoader(JCIFAR(size=50, seed=4), **kw)
    assert len(t) == len(j) == 4
    got = _batches(t, (0, 1))
    _assert_bitwise(got, _batches(j, (0, 1)))
    assert all(x.shape[0] == 16 for x, _ in got)


@pytest.mark.parametrize("rank", [0, 2])
def test_sharded_sampler_batches_bitwise_the_jax_loader(rank):
    kw = dict(num_replicas=3, rank=rank, shuffle=True, seed=11)
    t = tnative.NativeLoader(mt.SyntheticCIFAR10(size=70, seed=2), 8,
                             sampler=ShardedSampler(70, **kw))
    j = jnative.NativeLoader(JCIFAR(size=70, seed=2), 8,
                             sampler=jsampler.ShardedSampler(70, **kw))
    assert len(t.sampler) == len(j.sampler) == 24
    _assert_bitwise(_batches(t, (0, 1)), _batches(j, (0, 1)))


def test_plain_pass_equals_the_python_transforms_within_1e_5():
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    ds = mt.SyntheticCIFAR10(size=64, seed=8, transform=ttf.Compose(
        [ttf.ToFloat(), ttf.Normalize(mean, std)]))
    native = tnative.NativeLoader(ds, 16, shuffle=False, pad=0, flip=False,
                                  normalize=(mean, std))
    plain = Loader(ds, 16, shuffle=False)
    for (nx, ny), (px, py) in zip(native, plain):
        np.testing.assert_allclose(nx, px, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(ny, py)


def test_two_iterations_of_an_epoch_are_bitwise_and_a_break_parks():
    loader = tnative.NativeLoader(mt.SyntheticCIFAR10(size=128, seed=6), 16,
                                  seed=3, queue_cap=2)
    first = _batches(loader)
    it = iter(loader)
    next(it)
    it.close()  # an early break: the in-flight batches are discarded
    _assert_bitwise(_batches(loader), first)
    it = iter(loader)
    skipped = [next(it) for _ in range(3)]  # a resume's consumed batches
    _assert_bitwise([(x.copy(), y.copy()) for x, y in it], first[3:])
    _assert_bitwise(skipped, first[:3])
    loader.stop()
    loader.stop()  # idempotent
    with pytest.raises(RuntimeError, match="after stop"):
        next(iter(loader))


def _plan_sets(pkg):
    """(name, dataset) pairs over which the two packages' selection rules
    are compared; ``pkg`` is "jax" or "port"."""
    tf, arr, cifar, custom = ((jtf, JArray, JCIFAR, jc) if pkg == "jax" else
                              (ttf, TArray, mt.SyntheticCIFAR10,
                               mt.custom_pre_process_function))
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (48, 32, 32, 3), dtype=np.uint8)
    f32 = u8.astype(np.float32)
    y = rng.integers(0, 10, 48).astype(np.int32)
    norm = tf.Normalize((0.5,) * 3, (0.25,) * 3)
    return [
        ("cifar_custom", cifar(size=48, transform=custom())),
        ("cifar_ragged", cifar(size=44, transform=custom())),
        ("cifar_none", cifar(size=48)),
        ("u8_float_norm", arr(u8, y, tf.Compose([tf.ToFloat(), norm]))),
        ("u8_flip_only", arr(u8, y, tf.Compose(
            [tf.RandomHorizontalFlip(), tf.ToFloat(), norm]))),
        ("u8_flip_p", arr(u8, y, tf.Compose(
            [tf.RandomHorizontalFlip(0.3), tf.ToFloat(), norm]))),
        ("u8_crop_other_size", arr(u8, y, tf.Compose(
            [tf.RandomCrop(28, 2), tf.ToFloat(), norm]))),
        ("u8_no_normalize", arr(u8, y, tf.ToFloat())),
        ("float_data", arr(f32, y, tf.Compose([tf.ToFloat(), norm]))),
        ("tokens", arr(rng.integers(0, 9, (48, 8)).astype(np.int32), y)),
    ]


@pytest.mark.parametrize("name", [n for n, _ in _plan_sets("port")])
def test_native_plan_equals_the_jax_rule(name):
    t = dict(_plan_sets("port"))[name]
    j = dict(_plan_sets("jax"))[name]
    assert tnative.native_plan(t) == jnative.native_plan(j)


@pytest.fixture(scope="module")
def dataless_trainers():
    """A JAX and a port Trainer built without datasets, per loader kind;
    each test builds their loaders through ``_build_loaders``."""
    return {kind: (J.Trainer(jget_model("mlmodel"), backend="cpu",
                             loader=kind),
                   mt.Trainer("mlmodel", device="cpu", loader=kind))
            for kind in ("auto", "native")}


@pytest.mark.parametrize("name", [n for n, _ in _plan_sets("port")])
@pytest.mark.parametrize("kind", ["auto", "native"])
def test_trainer_picks_the_jax_trainers_pipeline(name, kind,
                                                 dataless_trainers):
    t_set = dict(_plan_sets("port"))[name]
    j_set = dict(_plan_sets("jax"))[name]
    jtr, ttr = dataless_trainers[kind]
    try:
        jtr._build_loaders(j_set, j_set, 8, jtr.config)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            ttr._build_loaders(t_set, t_set, 8, ttr.config)
        assert str(got.value) == str(err)
        return
    ttr._build_loaders(t_set, t_set, 8, ttr.config)
    for t_loader, j_loader in ((ttr.train_loader, jtr.train_loader),
                               (ttr.val_loader, jtr.val_loader)):
        assert (isinstance(t_loader, tnative.NativeLoader)
                == isinstance(j_loader, jnative.NativeLoader))
        assert len(t_loader) == len(j_loader)


def test_unknown_loader_kind_is_refused_as_in_jax():
    with pytest.raises(ValueError, match="loader must be 'auto' | 'native'"):
        mt.Trainer("mlmodel", device="cpu", loader="torch")


MLP_KW = dict(epochs=2, batch_size=16, optimizer="adam", lr=1e-3,
              metric="accuracy", loader="native")


def test_native_fit_matches_the_jax_native_fit(tmp_path):
    jtr = J.Trainer(jget_model("mlmodel"), datasets=(
        JCIFAR(size=64, transform=jc()), JCIFAR(size=32, transform=jc(),
                                                seed=1)),
        backend="cpu", model_dir=str(tmp_path / "j"), **MLP_KW)
    model = mt.get_model("mlmodel", device="cpu")
    model.load_state_dict(mt.params_from_jax(
        {"params": jax.tree.map(np.asarray, jtr.state.params)}))
    t = mt.custom_pre_process_function()
    ttr = mt.Trainer(model, datasets=(
        mt.SyntheticCIFAR10(size=64, transform=t),
        mt.SyntheticCIFAR10(size=32, transform=t, seed=1)),
        device="cpu", model_dir=str(tmp_path / "t"), **MLP_KW)
    assert isinstance(ttr.train_loader, tnative.NativeLoader)
    assert isinstance(jtr.train_loader, jnative.NativeLoader)
    jtr.fit()
    ttr.fit()
    for key in ("train_loss", "val_loss", "train_metric", "val_metric"):
        np.testing.assert_allclose(ttr.history[key], jtr.history[key],
                                   rtol=1e-4, atol=1e-6, err_msg=key)


def _native_trainer(model_dir, **kw):
    t = mt.custom_pre_process_function()
    return mt.Trainer(
        mt.init_model("mlmodel", seed=0, device="cpu"),
        datasets=(mt.SyntheticCIFAR10(size=64, transform=t),
                  mt.SyntheticCIFAR10(size=32, seed=1, transform=t)),
        device="cpu", model_dir=str(model_dir), **dict(MLP_KW, **kw))


@pytest.mark.parametrize("k", [1, 2])
def test_native_preempt_and_resume_bit_for_bit(tmp_path, k):
    """K = 1: preempted at step 6 (epoch 2, with its batch cursor) and
    resumed, consuming the trained batches from the C++ worker; K = 2:
    resumed from checkpoint_1 alone.  Either ends with the uninterrupted
    run's parameters and history exactly."""
    import shutil

    kw = dict(save_every_steps=2) if k == 1 else dict(steps_per_execution=k)
    ref = _native_trainer(tmp_path / "ref", **kw)
    ref.fit()
    if k == 1:
        with faults.injected("preempt@step=6"):
            first = _native_trainer(tmp_path / "run", **kw)
            first.fit()
        assert first.preempted
    else:
        shutil.copytree(tmp_path / "ref" / "checkpoints" / "checkpoint_1",
                        tmp_path / "run" / "checkpoints" / "checkpoint_1")
    resumed = _native_trainer(tmp_path / "run", **kw)
    resumed.fit(resume=True)
    assert resumed.history == ref.history
    got, want = resumed.model.state_dict(), ref.model.state_dict()
    for name, w in want.items():
        assert got[name].equal(w), name

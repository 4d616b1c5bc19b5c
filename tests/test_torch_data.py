"""Port parity: the input pipeline of ``ml_trainer_tpu_torch`` against the
JAX package's.  Same seed and epoch, same batches: compared exactly.
"""

import importlib

import numpy as np
import pytest
import torch

jdata = importlib.import_module("ml_trainer_tpu.data")
tdata = importlib.import_module("ml_trainer_tpu_torch.data")


def _batches(loader, epoch):
    loader.set_epoch(epoch)
    return [(np.asarray(x), np.asarray(y)) for x, y in loader]


@pytest.mark.parametrize("num_classes", [None, 3])
def test_synthetic_tokens_equal(num_classes):
    a = jdata.SyntheticTokens(size=20, seq_len=16, vocab_size=50,
                              num_classes=num_classes, seed=4)
    b = tdata.SyntheticTokens(size=20, seq_len=16, vocab_size=50,
                              num_classes=num_classes, seed=4)
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.targets, b.targets)
    assert a.data.dtype == b.data.dtype and a.targets.dtype == b.targets.dtype


def test_synthetic_cifar10_equal():
    a = jdata.SyntheticCIFAR10(size=8, seed=2)
    b = tdata.SyntheticCIFAR10(size=8, seed=2)
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.targets, b.targets)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("epoch", [0, 1, 5])
def test_loader_batches_equal(shuffle, drop_last, epoch):
    j = jdata.Loader(jdata.SyntheticTokens(size=37, seq_len=8, seed=1),
                     batch_size=8, shuffle=shuffle, drop_last=drop_last,
                     seed=32)
    t = tdata.Loader(tdata.SyntheticTokens(size=37, seq_len=8, seed=1),
                     batch_size=8, shuffle=shuffle, drop_last=drop_last,
                     seed=32)
    assert len(j) == len(t)
    jb, tb = _batches(j, epoch), _batches(t, epoch)
    assert len(jb) == len(tb)
    for (jx, jy), (tx, ty) in zip(jb, tb):
        np.testing.assert_array_equal(jx, tx)
        np.testing.assert_array_equal(jy, ty)


def test_loader_applies_a_batched_transform_with_the_same_rng():
    def jitter(x, rng):
        return x + rng.integers(0, 3, size=x.shape).astype(x.dtype)

    data = np.arange(60, dtype=np.int32).reshape(20, 3)
    targets = np.arange(20, dtype=np.int32)
    j = jdata.Loader(jdata.ArrayDataset(data, targets, jitter),
                     batch_size=6, shuffle=True, seed=3)
    t = tdata.Loader(tdata.ArrayDataset(data, targets, jitter),
                     batch_size=6, shuffle=True, seed=3)
    for (jx, jy), (tx, ty) in zip(_batches(j, 2), _batches(t, 2)):
        np.testing.assert_array_equal(jx, tx)
        np.testing.assert_array_equal(jy, ty)


@pytest.mark.parametrize("drop_last", [True, False])
def test_sharded_sampler_indices_equal(drop_last):
    for rank in range(3):
        a = jdata.ShardedSampler(10, num_replicas=3, rank=rank, seed=5,
                                 drop_last=drop_last)
        b = tdata.ShardedSampler(10, num_replicas=3, rank=rank, seed=5,
                                 drop_last=drop_last)
        a.set_epoch(2)
        b.set_epoch(2)
        assert len(a) == len(b)
        np.testing.assert_array_equal(a.indices(), b.indices())


def test_loader_with_sampler_equal():
    ds = dict(size=30, seq_len=4, seed=7)
    j = jdata.Loader(jdata.SyntheticTokens(**ds), batch_size=4,
                     sampler=jdata.ShardedSampler(30, 2, 1, seed=9))
    t = tdata.Loader(tdata.SyntheticTokens(**ds), batch_size=4,
                     sampler=tdata.ShardedSampler(30, 2, 1, seed=9))
    for (jx, _), (tx, _) in zip(_batches(j, 1), _batches(t, 1)):
        np.testing.assert_array_equal(jx, tx)


def test_as_dataset_adapts_foreign_arrays():
    class Foreign:
        data = np.zeros((4, 3, 8, 8), np.uint8)  # NCHW
        targets = [0, 1, 2, 3]

    a, b = jdata.as_dataset(Foreign()), tdata.as_dataset(Foreign())
    assert a.data.shape == b.data.shape == (4, 8, 8, 3)
    Foreign.transform = lambda x: x
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tdata.as_dataset(Foreign())


def test_prefetch_on_cpu_yields_the_batches_as_tensors():
    loader = tdata.Loader(tdata.SyntheticTokens(size=12, seq_len=4),
                          batch_size=5)
    got = list(tdata.prefetch_to_device(loader, size=2, device="cpu"))
    want = list(loader)
    assert len(got) == len(want) == 3
    for (gx, gy), (wx, wy) in zip(got, want):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        np.testing.assert_array_equal(gx.numpy(), wx)
        np.testing.assert_array_equal(gy.numpy(), wy)

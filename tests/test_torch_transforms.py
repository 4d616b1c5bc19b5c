"""Port parity: the CIFAR-10 input path of ``ml_trainer_tpu_torch``
(``data/transforms.py``, ``custom_pre_process_function``, ``CIFAR10``,
``as_dataset``'s foreign transform) against the JAX package's.

Every transform is numpy on NHWC batches with an explicit generator, so
the two packages must agree bit for bit: same batch, same rng seed, same
output (``np.array_equal``, dtype included).
"""

import pickle

import numpy as np
import pytest
import torch

from ml_trainer_tpu.data import CIFAR10 as JCIFAR10
from ml_trainer_tpu.data import Loader as JLoader
from ml_trainer_tpu.data import transforms as jt
from ml_trainer_tpu.data.datasets import as_dataset as j_as_dataset
from ml_trainer_tpu.utils.functions import (
    custom_pre_process_function as j_custom,
)
from ml_trainer_tpu_torch.data import CIFAR10, Loader, as_dataset
from ml_trainer_tpu_torch.data import transforms as tt
from ml_trainer_tpu_torch.utils import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    custom_pre_process_function,
)


def _batch(seed=0, b=6, side=32, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, size=(b, side, side, 3), dtype=np.uint8)
    return rng.normal(size=(b, side, side, 3)).astype(dtype)


PAIRS = {
    "random_crop": (lambda m: m.RandomCrop(32, padding=4), np.uint8),
    "random_crop_no_pad": (lambda m: m.RandomCrop(24), np.uint8),
    "flip": (lambda m: m.RandomHorizontalFlip(), np.uint8),
    "flip_p0.9": (lambda m: m.RandomHorizontalFlip(0.9), np.float32),
    "to_float_u8": (lambda m: m.ToFloat(), np.uint8),
    "to_float_f64": (lambda m: m.ToFloat(), np.float64),
    "normalize": (lambda m: m.Normalize(CIFAR10_MEAN, CIFAR10_STD),
                  np.float32),
    "compose": (lambda m: m.Compose([m.RandomHorizontalFlip(),
                                     m.RandomCrop(28, padding=2),
                                     m.ToFloat()]), np.uint8),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_transform_is_bitwise_the_jax_one(name):
    make, dtype = PAIRS[name]
    batch = _batch(dtype=dtype)
    want = make(jt)(batch.copy(), np.random.default_rng(5))
    got = make(tt)(batch.copy(), np.random.default_rng(5))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_custom_pre_process_function_is_bitwise_the_jax_one(seed):
    assert (CIFAR10_MEAN, CIFAR10_STD) == ((0.4914, 0.4822, 0.4465),
                                           (0.2023, 0.1994, 0.2010))
    batch = _batch(seed, b=8)
    want = j_custom()(batch, np.random.default_rng(seed + 10))
    got = custom_pre_process_function()(batch, np.random.default_rng(seed + 10))
    assert got.dtype == np.float32 and np.array_equal(got, want)


def _to_chw_tensor(img):
    """A per-sample callable in torchvision's style: HWC image (PIL or
    array) -> CHW float tensor."""
    arr = np.asarray(img, np.float32) / 255.0
    return torch.from_numpy(arr.transpose(2, 0, 1).copy())


def test_foreign_transform_returns_nhwc_like_the_jax_one():
    batch = _batch(2, b=4)
    want = jt.ForeignTransform(_to_chw_tensor)(batch, None)
    got = tt.ForeignTransform(_to_chw_tensor)(batch, None)
    assert got.shape == (4, 32, 32, 3) and np.array_equal(got, want)
    np.testing.assert_array_equal(got, batch.astype(np.float32) / 255.0)


class _TorchvisionStyle:
    """A reference-style dataset: NCHW ``data``, ``targets`` and a
    per-sample ``transform``."""

    def __init__(self, n=12):
        rng = np.random.default_rng(3)
        self.data = rng.integers(0, 256, size=(n, 3, 32, 32), dtype=np.uint8)
        self.targets = list(rng.integers(0, 10, size=n))
        self.transform = _to_chw_tensor


def test_as_dataset_wraps_a_foreign_transform_and_loads_like_jax():
    ds = as_dataset(_TorchvisionStyle())
    assert isinstance(ds.transform, tt.ForeignTransform)
    want = list(JLoader(j_as_dataset(_TorchvisionStyle()), batch_size=5,
                        shuffle=True, seed=4))
    got = list(Loader(ds, batch_size=5, shuffle=True, seed=4))
    assert len(got) == len(want) == 3
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.shape[1:] == (32, 32, 3)
        assert np.array_equal(gx, np.asarray(wx))
        assert np.array_equal(gy, np.asarray(wy))


def _write_cifar(root, per_file=3):
    base = root / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.default_rng(9)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        entry = {"data": rng.integers(0, 256, size=(per_file, 3072),
                                      dtype=np.uint8),
                 "labels": [int(v) for v in rng.integers(0, 10, per_file)]}
        with open(base / name, "wb") as fp:
            pickle.dump(entry, fp)


@pytest.mark.parametrize("train", [True, False])
def test_cifar10_reads_the_pickles_like_jax(tmp_path, train):
    _write_cifar(tmp_path)
    want = JCIFAR10(str(tmp_path), train=train)
    got = CIFAR10(str(tmp_path), train=train,
                  transform=custom_pre_process_function())
    assert got.data.shape == ((15 if train else 3), 32, 32, 3)
    assert got.data.dtype == np.uint8 and got.targets.dtype == np.int32
    assert np.array_equal(got.data, want.data)
    assert np.array_equal(got.targets, want.targets)


def test_cifar10_missing_raises_the_jax_message(tmp_path):
    with pytest.raises(FileNotFoundError) as want:
        JCIFAR10(str(tmp_path))
    with pytest.raises(FileNotFoundError) as got:
        CIFAR10(str(tmp_path))
    assert str(got.value) == str(want.value)

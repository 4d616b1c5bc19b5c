"""Datasets (the JAX package's ``data/datasets.py``): array-backed
containers the ``Loader`` batches with numpy gathers.

The same seeds give the same arrays as the JAX package.  A transform is
any ``(batch, rng) -> batch`` callable applied per batch
(``data/transforms.py``); ``as_dataset`` wraps a foreign dataset's
per-sample (torchvision) transform in ``ForeignTransform``.  ``CIFAR10``
reads the ``cifar-10-batches-py`` pickles only when they are already on
disk.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Optional, Tuple

import numpy as np

from ml_trainer_tpu_torch.data.transforms import ForeignTransform, Transform


class Dataset:
    """Minimal dataset protocol: ``len`` and integer indexing -> (x, y)."""

    transform: Optional[Callable] = None

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Tuple[Any, Any]:
        raise NotImplementedError


class ArrayDataset(Dataset):
    """In-memory numpy arrays with an optional batched transform."""

    def __init__(self, data: np.ndarray, targets: np.ndarray,
                 transform: Optional[Callable] = None):
        if len(data) != len(targets):
            raise ValueError(
                f"data and targets differ in length: {len(data)} vs "
                f"{len(targets)}")
        self.data = np.asarray(data)
        self.targets = np.asarray(targets)
        self.transform = transform

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx], self.targets[idx]

    def batch(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Batched gather: the Loader's hot path."""
        return self.data[indices], self.targets[indices]


class CIFAR10(ArrayDataset):
    """CIFAR-10 from the ``cifar-10-batches-py`` pickle layout under
    ``root`` (the files torchvision unpacks); no download is attempted.
    Images are NHWC uint8."""

    def __init__(self, root: str, train: bool = True, transform=None):
        base = os.path.join(root, "cifar-10-batches-py")
        if not os.path.isdir(base):
            raise FileNotFoundError(
                f"CIFAR-10 pickle batches not found under {base!r}. "
                "Place the extracted 'cifar-10-batches-py' directory there "
                "(no download is attempted), or use SyntheticCIFAR10 for "
                "smoke tests and benchmarks."
            )
        files = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        xs, ys = [], []
        for name in files:
            with open(os.path.join(base, name), "rb") as fp:
                entry = pickle.load(fp, encoding="latin1")
            xs.append(entry["data"])
            ys.extend(entry["labels"])
        # The files pack NCHW; the batches are NHWC.
        data = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        super().__init__(data, np.asarray(ys, dtype=np.int32), transform)


class SyntheticCIFAR10(ArrayDataset):
    """Deterministic CIFAR-10-shaped random data (NHWC uint8)."""

    def __init__(self, size: int = 1024, transform=None, seed: int = 0):
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 256, size=(size, 32, 32, 3), dtype=np.uint8)
        targets = rng.integers(0, 10, size=(size,)).astype(np.int32)
        super().__init__(data, targets, transform)


class SyntheticTokens(ArrayDataset):
    """Deterministic token ids; with ``num_classes=None`` the targets are
    the next tokens (causal LM), else one class per sequence."""

    def __init__(self, size: int = 256, seq_len: int = 128,
                 vocab_size: int = 1024, num_classes: Optional[int] = None,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        data = rng.integers(0, vocab_size,
                            size=(size, seq_len)).astype(np.int32)
        if num_classes is None:
            targets = np.roll(data, -1, axis=1)
        else:
            targets = rng.integers(0, num_classes,
                                   size=(size,)).astype(np.int32)
        super().__init__(data, targets, None)


def as_dataset(ds: Any) -> Dataset:
    """Adapt a foreign dataset (``data``/``targets`` arrays, NCHW images
    turned NHWC, a foreign per-sample transform wrapped in
    ``ForeignTransform``; or item by item) into an ``ArrayDataset``."""
    if isinstance(ds, Dataset):
        return ds
    if hasattr(ds, "data") and hasattr(ds, "targets"):
        data = np.asarray(ds.data)
        if (data.ndim == 4 and data.shape[1] in (1, 3)
                and data.shape[-1] not in (1, 3)):
            data = data.transpose(0, 2, 3, 1)
        transform = getattr(ds, "transform", None)
        if transform is not None and not isinstance(transform, Transform):
            transform = ForeignTransform(transform)
        return ArrayDataset(data, np.asarray(ds.targets), transform)
    xs, ys = zip(*[ds[i] for i in range(len(ds))])
    return ArrayDataset(np.stack([np.asarray(x) for x in xs]), np.asarray(ys))

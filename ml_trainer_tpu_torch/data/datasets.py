"""Datasets (the JAX package's ``data/datasets.py``): array-backed
containers the ``Loader`` batches with numpy gathers.

The same seeds give the same arrays as the JAX package.  A transform is
any ``(batch, rng) -> batch`` callable applied per batch; the
reference's CIFAR-10 augmentation classes are not ported yet, so a
foreign (torchvision) transform is refused by ``as_dataset``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np


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
    turned NHWC, or item by item) into an ``ArrayDataset``."""
    if isinstance(ds, Dataset):
        return ds
    if hasattr(ds, "data") and hasattr(ds, "targets"):
        if getattr(ds, "transform", None) is not None:
            raise NotImplementedError(
                "per-sample (torchvision) transforms are not ported yet; "
                "see ROADMAP.md Queue A"
            )
        data = np.asarray(ds.data)
        if (data.ndim == 4 and data.shape[1] in (1, 3)
                and data.shape[-1] not in (1, 3)):
            data = data.transpose(0, 2, 3, 1)
        return ArrayDataset(data, np.asarray(ds.targets))
    xs, ys = zip(*[ds[i] for i in range(len(ds))])
    return ArrayDataset(np.stack([np.asarray(x) for x in xs]), np.asarray(ys))

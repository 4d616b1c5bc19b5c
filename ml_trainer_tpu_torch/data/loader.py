"""Loader and device prefetch (the JAX package's ``data/loader.py``).

``Loader`` batches by numpy gathers over the same epoch permutation
(``default_rng((seed, epoch))``), so it yields the JAX package's batches
exactly.  ``prefetch_to_device`` keeps ``size`` batches in flight: each
is copied from pinned host memory with ``non_blocking=True`` on a side
stream, and the compute stream waits on that copy's event before it
uses the batch.  On the CPU it only wraps the arrays as tensors.
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ml_trainer_tpu_torch.data.datasets import Dataset, as_dataset
from ml_trainer_tpu_torch.data.sampler import ShardedSampler


class _TrivialSampler:
    """Full-dataset sampler, so ``len(loader.sampler)`` always works."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n


class Loader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 sampler: Optional[ShardedSampler] = None,
                 drop_last: bool = False, seed: int = 0):
        self.dataset: Dataset = as_dataset(dataset)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._sampler = sampler
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    @property
    def sampler(self):
        return self._sampler if self._sampler is not None else \
            _TrivialSampler(len(self.dataset))

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if self._sampler is not None:
            self._sampler.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        if self._sampler is not None:
            return np.asarray(self._sampler.indices())
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            return rng.permutation(len(self.dataset))
        return np.arange(len(self.dataset))

    def __len__(self) -> int:
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self._indices()
        transform = getattr(self.dataset, "transform", None)
        rng = np.random.default_rng((self.seed, 1 + self._epoch))
        fast = callable(getattr(self.dataset, "batch", None))
        for b in range(len(self)):
            sel = idx[b * self.batch_size: (b + 1) * self.batch_size]
            if fast:
                x, y = self.dataset.batch(sel)
            else:
                xs, ys = zip(*[self.dataset[int(i)] for i in sel])
                x, y = np.stack(xs), np.asarray(ys)
            if transform is not None:
                x = transform(x, rng)
            yield x, y


class JoinedLoader:
    """The global batches of a multi-process run, for one process: batch
    ``b`` is the first part's batch ``b``, then the second's, and so on.
    ``parts`` are the processes' train loaders in rank order (each with
    its ``ShardedSampler`` split); a one-process trainer fed these
    batches takes the steps the processes take together."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.sampler = self.parts[0].sampler

    def set_epoch(self, epoch: int) -> None:
        for p in self.parts:
            p.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.parts[0])

    def __iter__(self):
        for batches in zip(*self.parts):
            yield (np.concatenate([b[0] for b in batches]),
                   np.concatenate([b[1] for b in batches]))


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def prefetch_to_device(iterator, size: int = 2, device=None):
    """Yield each batch of ``iterator`` as a tuple of tensors on
    ``device``, with up to ``size`` host-to-device copies in flight."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        for batch in iterator:
            yield tuple(_as_tensor(a) for a in batch)
        return
    copy_stream = torch.cuda.Stream(device)

    def put(batch):
        host = [_as_tensor(a).pin_memory() for a in batch]
        with torch.cuda.stream(copy_stream):
            out = tuple(t.to(device, non_blocking=True) for t in host)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def take(item):
        out, done = item
        compute = torch.cuda.current_stream(device)
        compute.wait_event(done)
        for t in out:
            # Allocated on the copy stream, used on the compute stream.
            t.record_stream(compute)
        return out

    it = iter(iterator)
    queue = collections.deque(put(b) for b in itertools.islice(it, size))
    while queue:
        yield take(queue.popleft())
        batch = next(it, None)
        if batch is not None:
            queue.append(put(batch))

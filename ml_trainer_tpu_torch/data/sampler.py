"""ShardedSampler (the JAX package's ``data/sampler.py``), the
DistributedSampler analog: epoch-seeded shuffle, wrap padding so every
replica sees the same count, ``set_epoch`` to reshuffle."""

from __future__ import annotations

import numpy as np


class ShardedSampler:
    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        if not 0 <= rank < num_replicas:
            raise ValueError(
                f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = -(-dataset_len // num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            order = rng.permutation(self.dataset_len)
        else:
            order = np.arange(self.dataset_len)
        if self.drop_last:
            order = order[: self.total_size]
        elif len(order) < self.total_size:
            order = np.concatenate(
                [order, order[: self.total_size - len(order)]])
        return order[self.rank: self.total_size: self.num_replicas]

    def __iter__(self):
        return iter(self.indices())

    def __len__(self):
        return self.num_samples

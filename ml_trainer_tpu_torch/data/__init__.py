"""Host-side input pipeline: datasets, the sharded sampler, the numpy
``Loader`` and a pinned-memory device prefetch."""

from ml_trainer_tpu_torch.data.datasets import (
    ArrayDataset,
    Dataset,
    SyntheticCIFAR10,
    SyntheticTokens,
    as_dataset,
)
from ml_trainer_tpu_torch.data.loader import Loader, prefetch_to_device
from ml_trainer_tpu_torch.data.sampler import ShardedSampler

__all__ = [
    "ArrayDataset", "Dataset", "Loader", "ShardedSampler",
    "SyntheticCIFAR10", "SyntheticTokens", "as_dataset",
    "prefetch_to_device",
]

"""Host-side input pipeline: datasets, batch transforms, the sharded
sampler, the numpy ``Loader`` and a pinned-memory device prefetch."""

from ml_trainer_tpu_torch.data.datasets import (
    CIFAR10,
    ArrayDataset,
    Dataset,
    SyntheticCIFAR10,
    SyntheticTokens,
    as_dataset,
)
from ml_trainer_tpu_torch.data.loader import Loader, prefetch_to_device
from ml_trainer_tpu_torch.data.sampler import ShardedSampler
from ml_trainer_tpu_torch.data.transforms import (
    Compose,
    ForeignTransform,
    Normalize,
    RandomCrop,
    RandomHorizontalFlip,
    ToFloat,
    Transform,
)

__all__ = [
    "CIFAR10", "ArrayDataset", "Compose", "Dataset", "ForeignTransform",
    "Loader", "Normalize", "RandomCrop", "RandomHorizontalFlip",
    "ShardedSampler", "SyntheticCIFAR10", "SyntheticTokens", "ToFloat",
    "Transform", "as_dataset", "prefetch_to_device",
]

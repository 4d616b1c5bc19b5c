"""User-extension hooks (the JAX package's ``utils/functions.py``): the
reference's CIFAR-10 preprocess as numpy batch transforms, and its custom
loss."""

from __future__ import annotations

import torch

from ml_trainer_tpu_torch.data.transforms import (
    Compose,
    Normalize,
    RandomCrop,
    RandomHorizontalFlip,
    ToFloat,
)

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2023, 0.1994, 0.2010)


def custom_pre_process_function() -> Compose:
    """The reference's augmentation, batched: RandomCrop(32, padding=4),
    RandomHorizontalFlip, uint8 -> [0, 1] floats (NHWC kept), Normalize
    with the CIFAR-10 mean and std."""
    return Compose([
        RandomCrop(32, padding=4),
        RandomHorizontalFlip(),
        ToFloat(),
        Normalize(CIFAR10_MEAN, CIFAR10_STD),
    ])


def custom_loss_function(output: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    """Mean squared error, the reference's custom loss."""
    return torch.mean((output - target) ** 2)

"""Utilities: the custom preprocess and loss hooks, logging, history and
model loading."""

from ml_trainer_tpu_torch.utils.functions import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    custom_loss_function,
    custom_pre_process_function,
)
from ml_trainer_tpu_torch.utils.logging import get_logger
from ml_trainer_tpu_torch.utils.utils import (
    LoadedModel,
    load_history,
    load_model,
)

__all__ = ["CIFAR10_MEAN", "CIFAR10_STD", "LoadedModel",
           "custom_loss_function", "custom_pre_process_function",
           "get_logger", "load_history", "load_model"]

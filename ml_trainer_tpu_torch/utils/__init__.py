"""Utilities: the custom loss hook, logging, history and model loading."""

from ml_trainer_tpu_torch.utils.functions import custom_loss_function
from ml_trainer_tpu_torch.utils.logging import get_logger
from ml_trainer_tpu_torch.utils.utils import (
    LoadedModel,
    load_history,
    load_model,
)

__all__ = ["LoadedModel", "custom_loss_function", "get_logger",
           "load_history", "load_model"]

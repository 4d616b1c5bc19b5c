"""The port's model zoo (GPT-2 family so far)."""

from ml_trainer_tpu_torch.models.gpt2 import GPT2
from ml_trainer_tpu_torch.models.layers import (
    MLP,
    ContiguousKVCache,
    MultiHeadAttention,
    PagedKVCache,
    TransformerBlock,
)
from ml_trainer_tpu_torch.models.registry import available_models, get_model

__all__ = [
    "GPT2", "MLP", "ContiguousKVCache", "MultiHeadAttention", "PagedKVCache",
    "TransformerBlock", "available_models", "get_model",
]

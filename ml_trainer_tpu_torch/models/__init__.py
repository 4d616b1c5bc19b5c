"""The port's model zoo: MLModel, ResNet, ViT, BERT and GPT-2."""

from ml_trainer_tpu_torch.models.bert import BertEncoder
from ml_trainer_tpu_torch.models.gpt2 import GPT2
from ml_trainer_tpu_torch.models.layers import (
    MLP,
    BatchNorm,
    ContiguousKVCache,
    Conv,
    MultiHeadAttention,
    PagedKVCache,
    TransformerBlock,
)
from ml_trainer_tpu_torch.models.mlmodel import MLModel
from ml_trainer_tpu_torch.models.registry import available_models, get_model
from ml_trainer_tpu_torch.models.resnet import ResNet
from ml_trainer_tpu_torch.models.vit import VisionTransformer

__all__ = [
    "GPT2", "MLP", "BatchNorm", "BertEncoder", "ContiguousKVCache", "Conv",
    "MLModel", "MultiHeadAttention", "PagedKVCache", "ResNet",
    "TransformerBlock", "VisionTransformer", "available_models",
    "get_model",
]

"""The port's model zoo: MLModel, ResNet, ViT, BERT, GPT-2 and Llama."""

from ml_trainer_tpu_torch.models.bert import BertEncoder
from ml_trainer_tpu_torch.models.gpt2 import GPT2
from ml_trainer_tpu_torch.models.layers import (
    MLP,
    BatchNorm,
    ContiguousKVCache,
    Conv,
    MultiHeadAttention,
    PagedKVCache,
    RMSNorm,
    TransformerBlock,
)
from ml_trainer_tpu_torch.models.llama import LlamaLM
from ml_trainer_tpu_torch.models.mlmodel import MLModel
from ml_trainer_tpu_torch.models.registry import available_models, get_model
from ml_trainer_tpu_torch.models.resnet import ResNet
from ml_trainer_tpu_torch.models.vit import VisionTransformer

__all__ = [
    "GPT2", "MLP", "BatchNorm", "BertEncoder", "ContiguousKVCache", "Conv",
    "LlamaLM", "MLModel", "MultiHeadAttention", "PagedKVCache", "RMSNorm",
    "ResNet", "TransformerBlock", "VisionTransformer", "available_models",
    "get_model",
]

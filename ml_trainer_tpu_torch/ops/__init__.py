"""Attention ops and the hand-written CUDA kernels."""

from ml_trainer_tpu_torch.ops.attention import (
    attention,
    dot_product_attention,
    flash_attention,
    flash_attention_reference,
)

__all__ = [
    "attention", "dot_product_attention", "flash_attention",
    "flash_attention_reference",
]

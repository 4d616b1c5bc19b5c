"""Vision Transformer (the JAX package's ``models/vit.py``): ViT-B/16,
``BASELINE.json`` configs[3].

The patch embedding is one strided conv with bias over the NHWC input
(seen as its channels-last NCHW view), its output flattened in (H', W')
row order; a zero ``cls_token`` of shape (1, 1, E) goes in front, then
``pos_embed`` (1, 1 + patches, E), pre-norm ``TransformerBlock``s
(``blocks.{i}``), ``ln_final`` and the ``head`` on token 0.

flax sizes ``pos_embed`` from the first input it sees; torch allocates at
construction, so the port takes ``image_size`` (224 for ``vit_b16``, 32
for ``vit_tiny``), and ``load_state_dict`` refuses flax variables made
for another size.  At 197 tokens (vit_tiny: 17) ``attention`` routes to
the plain path under "auto", as the JAX package does.  The JAX
``vit_b16`` computes in bf16 by default; bf16 is not ported, so a
``dtype`` other than float32 raises.
"""

from __future__ import annotations

import torch
from torch import nn

from ml_trainer_tpu_torch.device import resolve_device
from ml_trainer_tpu_torch.models.layers import (
    LN_EPS,
    Conv,
    TransformerBlock,
    _refuse_unported,
)
from ml_trainer_tpu_torch.models.registry import register_model


class VisionTransformer(nn.Module):
    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, dropout_rate: float = 0.0,
                 dtype=torch.float32, attention_impl: str = "auto",
                 remat: bool = False, image_size: int = 224, device=None):
        super().__init__()
        if dtype != torch.float32:
            raise NotImplementedError(
                f"dtype={dtype!r}: bf16 compute is not ported yet; see "
                "ROADMAP.md Queue A 2b.2 (pass dtype=torch.float32)")
        _refuse_unported(dropout_rate)
        if remat:
            raise NotImplementedError(
                "remat=True is not ported yet; see ROADMAP.md Queue A")
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.depth = depth
        self.embed_dim = embed_dim
        # 'auto' | 'xla' | 'flash', as in GPT2.
        self.attention_impl = attention_impl
        self.patch_embed = Conv(3, embed_dim, patch_size,
                                patch_size, padding="VALID", **kw)
        patches = (image_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, **kw))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + patches, embed_dim,
                                                  **kw))
        self.blocks = nn.ModuleList(
            TransformerBlock(embed_dim, num_heads, mlp_dim, **kw)
            for _ in range(depth))
        self.ln_final = nn.LayerNorm(embed_dim, eps=LN_EPS, **kw)
        self.head = nn.Linear(embed_dim, num_classes, **kw)

    def forward(self, x):
        b = x.shape[0]
        x = x.permute(0, 3, 1, 2).to(self.cls_token.dtype)
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # [B, P, E]
        if x.shape[1] + 1 != self.pos_embed.shape[1]:
            raise ValueError(
                f"{x.shape[1]} patches, but pos_embed holds "
                f"{self.pos_embed.shape[1] - 1}: build the model with the "
                "inputs' image_size")
        x = torch.cat([self.cls_token.expand(b, 1, self.embed_dim), x], dim=1)
        x = x + self.pos_embed
        for block in self.blocks:
            x = block(x, attention_impl=self.attention_impl)
        return self.head(self.ln_final(x[:, 0]))  # LayerNorm is per token


@register_model("vit_b16")
def vit_b16(num_classes: int = 1000, dtype=torch.bfloat16,
            **kw) -> VisionTransformer:
    """ViT-B/16: 12 layers, 768 wide, 12 heads, 224x224 inputs.  bf16 by
    default, as in the JAX package, which the port refuses."""
    return VisionTransformer(num_classes=num_classes, dtype=dtype, **kw)


@register_model("vit_tiny")
def vit_tiny(num_classes: int = 10, **kw) -> VisionTransformer:
    """Small ViT for tests: 2 layers, 128 wide, patch 8, 32x32 inputs."""
    kw.setdefault("patch_size", 8)
    kw.setdefault("embed_dim", 128)
    kw.setdefault("depth", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("mlp_dim", 256)
    kw.setdefault("image_size", 32)
    return VisionTransformer(num_classes=num_classes, **kw)

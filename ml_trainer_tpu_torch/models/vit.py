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
the plain path under "auto", as the JAX package does.

``dtype`` is the compute dtype (``models/layers.py``): the patch
embedding, the blocks and ``ln_final`` compute in it, the ``head`` in
float32, as in the JAX package; parameters stay float32.  ``vit_b16``
computes in bf16 by default, as the JAX ``vit_b16`` does.
``dropout_rate`` drops the patch and position embedding sum and each
block's attention and MLP outputs in training mode; ``remat`` runs each
block under ``layers.remat_call`` (``remat_policy`` 'none' or 'dots').
"""

from __future__ import annotations

import torch
from torch import nn

from ml_trainer_tpu_torch.device import resolve_device
from ml_trainer_tpu_torch.models.layers import (
    LN_EPS,
    Conv,
    Dense,
    Dropout,
    LayerNorm,
    TransformerBlock,
    attach_dropout,
    check_remat_policy,
    compute_dtype,
    remat_call,
)
from ml_trainer_tpu_torch.models.registry import register_model


class VisionTransformer(nn.Module):
    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, dropout_rate: float = 0.0,
                 dtype=torch.float32, attention_impl: str = "auto",
                 remat: bool = False, remat_policy: str = "none",
                 image_size: int = 224, device=None):
        super().__init__()
        if remat:
            check_remat_policy(remat_policy)
        self.remat, self.remat_policy = bool(remat), remat_policy
        device = resolve_device(device)
        self.dtype = dtype
        cdt = compute_dtype(dtype)
        kw = dict(device=device, dtype=cdt)
        self.depth = depth
        self.embed_dim = embed_dim
        # 'auto' | 'xla' | 'flash', as in GPT2.
        self.attention_impl = attention_impl
        self.patch_embed = Conv(3, embed_dim, patch_size,
                                patch_size, padding="VALID", **kw)
        patches = (image_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim,
                                                  device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + patches, embed_dim,
                                                  device=device))
        self.embed_drop = Dropout(dropout_rate)
        self.blocks = nn.ModuleList(
            TransformerBlock(embed_dim, num_heads, mlp_dim,
                             dropout_rate=dropout_rate, **kw)
            for _ in range(depth))
        self.ln_final = LayerNorm(embed_dim, eps=LN_EPS, **kw)
        # flax's Dense(dtype=float32); with no policy it casts nothing.
        self.head = Dense(embed_dim, num_classes, device=device,
                          dtype=None if cdt is None else torch.float32)
        attach_dropout(self)

    def forward(self, x):
        b = x.shape[0]
        x = x.permute(0, 3, 1, 2).to(self.cls_token.dtype)
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # [B, P, E]
        if x.shape[1] + 1 != self.pos_embed.shape[1]:
            raise ValueError(
                f"{x.shape[1]} patches, but pos_embed holds "
                f"{self.pos_embed.shape[1] - 1}: build the model with the "
                "inputs' image_size")
        x = torch.cat([self.cls_token.expand(b, 1, self.embed_dim).to(x.dtype),
                       x], dim=1)
        x = self.embed_drop(x + self.pos_embed.to(x.dtype))
        for block in self.blocks:
            x = remat_call(block, self.remat, self.remat_policy, x,
                           attention_impl=self.attention_impl)
        return self.head(self.ln_final(x[:, 0]))  # LayerNorm is per token


@register_model("vit_b16")
def vit_b16(num_classes: int = 1000, dtype=torch.bfloat16,
            **kw) -> VisionTransformer:
    """ViT-B/16: 12 layers, 768 wide, 12 heads, 224x224 inputs; computes
    in bf16 by default, as in the JAX package."""
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

"""GPT-2 causal LM in PyTorch: the JAX package's ``models/gpt2.py``.

Pre-LN decoder stack, learned position embeddings, weight-tied LM head
computed in fp32 (logits = h @ tok_embed^T).  ``forward`` runs a plain
full forward with ``cache=None``, and the decode semantics of the
reference's ``decode=True`` mode with a ``ContiguousKVCache`` or
``PagedKVCache`` (models/layers.py), whose per-row positions also place
the position embeddings (clipped at ``max_len``, like the reference's
``mode="clip"`` take).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ml_trainer_tpu_torch.device import resolve_device
from ml_trainer_tpu_torch.models.layers import (
    LN_EPS,
    ContiguousKVCache,
    PagedKVCache,
    TransformerBlock,
    _refuse_unported,
)
from ml_trainer_tpu_torch.models.registry import register_model


class GPT2(nn.Module):
    def __init__(self, vocab_size: int = 50257, max_len: int = 1024,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 attention_impl: str = "auto",
                 dropout_rate: float = 0.0, moe_experts: int = 0,
                 lora_rank: int = 0, quant_int8: bool = False,
                 loss_chunk: int = 0, device=None, dtype=torch.float32):
        super().__init__()
        _refuse_unported(dropout_rate, moe_experts, lora_rank, quant_int8)
        if loss_chunk:
            # The chunked LM head (ops.losses.chunked_lm_cross_entropy).
            raise NotImplementedError(
                f"loss_chunk={loss_chunk!r} is not ported yet; see "
                "ROADMAP.md Queue A")
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        # 'auto' | 'xla' | 'flash' for the full (prefill) attention; the
        # plain path is 'xla' (the JAX package's name).
        self.attention_impl = attention_impl
        self.tok_embed = nn.Embedding(vocab_size, embed_dim, device=device,
                                      dtype=dtype)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, max_len, embed_dim, device=device, dtype=dtype))
        self.blocks = nn.ModuleList(
            TransformerBlock(embed_dim, num_heads, 4 * embed_dim, causal=True,
                             device=device, dtype=dtype)
            for _ in range(depth)
        )
        self.ln_final = nn.LayerNorm(embed_dim, eps=LN_EPS, device=device,
                                     dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.pos_embed.device

    def _embed_input(self, input_ids, pos_start=None):
        """Token embedding plus learned positions.  ``pos_start`` ([B]
        per-row positions) offsets the position window per row, clipped
        at ``max_len``."""
        s = input_ids.shape[1]
        x = self.tok_embed(input_ids)
        pos = self.pos_embed[0]
        if pos_start is None:
            return x + pos[:s][None]
        rows = pos_start[:, None] + torch.arange(s, device=x.device)[None, :]
        return x + pos[torch.clamp(rows, 0, self.max_len - 1)]

    def _tied_head(self, x):
        x = self.ln_final(x)
        return x.float() @ self.tok_embed.weight.float().T

    def new_cache(self, batch: int, max_len: Optional[int] = None
                  ) -> ContiguousKVCache:
        return ContiguousKVCache(
            self.depth, batch, self.num_heads, max_len or self.max_len,
            self.head_dim, dtype=self.pos_embed.dtype, device=self.device)

    def new_paged_cache(self, batch: int, num_pages: int, page_size: int,
                        paged_kernel: bool = False) -> PagedKVCache:
        return PagedKVCache(
            self.depth, num_pages, self.num_heads, page_size, self.head_dim,
            batch, self.max_len, paged_kernel=paged_kernel,
            dtype=self.pos_embed.dtype, device=self.device)

    def forward(self, input_ids, cache=None, select=None):
        """Logits [B, S, V]; with ``select`` ([B] position per row) only
        those rows' logits [B, V].  With a cache, the call writes its K/V
        there and advances the cache's positions by S."""
        if cache is None:
            x = self._embed_input(input_ids)
        else:
            x = self._embed_input(input_ids, pos_start=cache.index)
        for i, block in enumerate(self.blocks):
            x = block(x, cache, i, attention_impl=self.attention_impl)
        if cache is not None:
            cache.advance(input_ids.shape[1])
        if select is not None:
            x = x[torch.arange(x.shape[0], device=x.device), select][:, None]
            return self._tied_head(x)[:, 0]
        return self._tied_head(x)


@register_model("gpt2")
def gpt2(**kw) -> GPT2:
    """GPT-2 124M: 12 layers, 768 wide, 12 heads, 50257 vocab."""
    return GPT2(**kw)


@register_model("gpt2_tiny")
def gpt2_tiny(**kw) -> GPT2:
    """Small GPT-2 for tests: 2 layers, 128 wide, 1k vocab."""
    kw.setdefault("vocab_size", 1024)
    kw.setdefault("embed_dim", 128)
    kw.setdefault("depth", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("max_len", 256)
    return GPT2(**kw)


@register_model("gpt2_mini")
def gpt2_mini(**kw) -> GPT2:
    """Mid-size GPT-2 (~29M params): 4 layers, 512 wide, 8k vocab."""
    kw.setdefault("vocab_size", 8192)
    kw.setdefault("embed_dim", 512)
    kw.setdefault("depth", 4)
    kw.setdefault("num_heads", 8)
    kw.setdefault("max_len", 512)
    return GPT2(**kw)

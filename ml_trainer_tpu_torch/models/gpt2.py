"""GPT-2 causal LM in PyTorch: the JAX package's ``models/gpt2.py``.

Pre-LN decoder stack, learned position embeddings, weight-tied LM head
computed in fp32 (logits = h @ tok_embed^T).  ``dtype`` is the compute
dtype (``models/layers.py``): the embedding sum is cast to it, the blocks
and ``ln_final`` compute in it, the parameters stay float32, and the
decode caches hold K/V in it (a bf16 model serves from bf16 caches and
page pools).  ``forward`` runs a plain
full forward with ``cache=None``, and the decode semantics of the
reference's ``decode=True`` mode with a ``ContiguousKVCache`` or
``PagedKVCache`` (models/layers.py), whose per-row positions also place
the position embeddings (clipped at ``max_len``, like the reference's
``mode="clip"`` take).  Given the "quant" collection
(``ops.kernels.quantize_tree``), ``forward`` runs the four projections of
every block as int8 matmuls, with or without a cache: the JAX package's
``model.clone(quant_int8=True)`` with its "quant" variables.  With
``loss_chunk`` > 0, ``forward(input_ids, targets=...)`` returns the mean
LM loss through the same tied head without ever holding the [B, S, V]
logits (``ops.losses.chunked_lm_cross_entropy``); the Trainer then feeds
the labels through the forward.  ``dropout_rate`` drops the embedding sum
(after the cast to the compute dtype) and each block's attention and MLP
outputs in training mode, never with a cache; ``remat`` runs each block
under ``layers.remat_call`` with ``remat_policy`` 'none' or 'dots'.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ml_trainer_tpu_torch.device import resolve_device
from ml_trainer_tpu_torch.models.layers import (
    LN_EPS,
    ContiguousKVCache,
    Dropout,
    LayerNorm,
    PagedKVCache,
    TransformerBlock,
    _cast,
    _refuse_unported,
    attach_dropout,
    check_remat_policy,
    compute_dtype,
    remat_call,
)
from ml_trainer_tpu_torch.models.registry import register_model
from ml_trainer_tpu_torch.ops.losses import chunked_lm_cross_entropy


class GPT2(nn.Module):
    def __init__(self, vocab_size: int = 50257, max_len: int = 1024,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 attention_impl: str = "auto",
                 dropout_rate: float = 0.0, moe_experts: int = 0,
                 lora_rank: int = 0, loss_chunk: int = 0,
                 remat: bool = False, remat_policy: str = "none",
                 device=None, dtype=torch.float32):
        super().__init__()
        _refuse_unported(moe_experts, lora_rank)
        if remat:
            check_remat_policy(remat_policy)
        self.remat, self.remat_policy = bool(remat), remat_policy
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
        # > 0: with targets, the chunked LM loss (a divisor of S).
        self.loss_chunk = int(loss_chunk)
        self.dtype = dtype
        cdt = compute_dtype(dtype)
        self.tok_embed = nn.Embedding(vocab_size, embed_dim, device=device)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, max_len, embed_dim, device=device))
        self.embed_drop = Dropout(dropout_rate)
        self.blocks = nn.ModuleList(
            TransformerBlock(embed_dim, num_heads, 4 * embed_dim, causal=True,
                             device=device, dtype=cdt,
                             dropout_rate=dropout_rate)
            for _ in range(depth)
        )
        self.ln_final = LayerNorm(embed_dim, eps=LN_EPS, device=device,
                                  dtype=cdt)
        attach_dropout(self)

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
        cdt = compute_dtype(self.dtype)
        if pos_start is None:
            return _cast(x + pos[:s][None], cdt)
        rows = pos_start[:, None] + torch.arange(s, device=x.device)[None, :]
        return _cast(x + pos[torch.clamp(rows, 0, self.max_len - 1)], cdt)

    def _tied_head(self, x, targets=None):
        """Final LayerNorm, then the weight-tied head's float32 logits, or
        with ``targets`` the chunked LM loss through the same weights."""
        x = self.ln_final(x)
        if targets is not None:
            if not self.loss_chunk:
                raise ValueError(
                    "targets requires loss_chunk > 0 (set loss_chunk to a "
                    "divisor of the sequence length to enable the chunked "
                    "LM loss)")
            return chunked_lm_cross_entropy(x, self.tok_embed.weight,
                                            targets, self.loss_chunk)
        return x.float() @ self.tok_embed.weight.float().T

    def _cache_dtype(self) -> torch.dtype:
        """The caches' dtype: the compute dtype, or the parameters' (float32;
        float64 after ``model.to(torch.float64)``) when that is None."""
        return compute_dtype(self.dtype) or self.pos_embed.dtype

    def new_cache(self, batch: int, max_len: Optional[int] = None
                  ) -> ContiguousKVCache:
        return ContiguousKVCache(
            self.depth, batch, self.num_heads, max_len or self.max_len,
            self.head_dim, dtype=self._cache_dtype(), device=self.device)

    def new_paged_cache(self, batch: int, num_pages: int, page_size: int,
                        paged_kernel: bool = False) -> PagedKVCache:
        return PagedKVCache(
            self.depth, num_pages, self.num_heads, page_size, self.head_dim,
            batch, self.max_len, paged_kernel=paged_kernel,
            dtype=self._cache_dtype(), device=self.device)

    def forward(self, input_ids, cache=None, select=None, quant=None,
                quant_impl: str = "auto", targets=None):
        """Logits [B, S, V]; with ``select`` ([B] position per row) only
        those rows' logits [B, V]; with ``targets`` ([B, S] next-token
        labels; needs ``loss_chunk``) the mean LM loss instead.  With a
        cache, the call writes its K/V there and advances the cache's
        positions by S.  With ``quant`` the projections are int8
        (``quant_impl``: "auto" or "reference", see
        ``ops.kernels.int8_matmul``); the embeddings and the tied head
        stay fp32."""
        if cache is None:
            x = self.embed_drop(self._embed_input(input_ids))
        else:
            x = self._embed_input(input_ids, pos_start=cache.index)
        q_blocks = None if quant is None else quant["blocks"]
        remat = self.remat and cache is None
        for i, block in enumerate(self.blocks):
            x = remat_call(
                block, remat, self.remat_policy, x, cache, i,
                attention_impl=self.attention_impl,
                quant=None if q_blocks is None else q_blocks[str(i)],
                quant_impl=quant_impl)
        if cache is not None:
            cache.advance(input_ids.shape[1])
        if targets is not None:
            return self._tied_head(x, targets)
        if select is not None:
            x = x[torch.arange(x.shape[0], device=x.device), select][:, None]
            return self._tied_head(x)[:, 0]
        return self._tied_head(x)


@register_model("gpt2")
def gpt2(**kw) -> GPT2:
    """GPT-2 124M: 12 layers, 768 wide, 12 heads, 50257 vocab."""
    return GPT2(**kw)


@register_model("gpt2_medium")
def gpt2_medium(**kw) -> GPT2:
    """GPT-2 355M: 24 layers, 1024 wide, 16 heads."""
    kw.setdefault("embed_dim", 1024)
    kw.setdefault("depth", 24)
    kw.setdefault("num_heads", 16)
    return GPT2(**kw)


@register_model("gpt2_large")
def gpt2_large(**kw) -> GPT2:
    """GPT-2 774M: 36 layers, 1280 wide, 20 heads."""
    kw.setdefault("embed_dim", 1280)
    kw.setdefault("depth", 36)
    kw.setdefault("num_heads", 20)
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


@register_model("gpt2_nano")
def gpt2_nano(**kw) -> GPT2:
    """Draft-model config paired with ``gpt2_mini``: 1 layer, 128 wide,
    the same 8k vocabulary (speculative decoding compares token ids, so
    the vocabulary is the contract between the two)."""
    kw.setdefault("vocab_size", 8192)
    kw.setdefault("embed_dim", 128)
    kw.setdefault("depth", 1)
    kw.setdefault("num_heads", 4)
    kw.setdefault("max_len", 512)
    return GPT2(**kw)

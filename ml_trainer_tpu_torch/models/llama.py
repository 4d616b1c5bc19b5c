"""Llama-family decoder in PyTorch: the JAX package's ``models/llama.py``.

Pre-RMSNorm blocks, rotary position embeddings on q and k (rotate-half,
not interleaved pairs), grouped-query attention, a SwiGLU feed-forward
``down(silu(gate(y)) * up(y))``, no biases anywhere and an untied
float32 ``lm_head`` of shape [E, V] (the flax layout, a bare parameter).
The full-width ``llama`` is 124,668,672 parameters: 24.6M each for the
token embedding and the head, and 12 blocks of 6.29M.

Grouped-query attention.  ``num_heads`` query heads share
``num_kv_heads`` key/value heads; K and V are repeated up to H only at
the attention call, query head i reading kv head ``i // rep``
(``repeat_interleave``, the JAX package's ``jnp.repeat(..., axis=1)``;
``Tensor.repeat`` would tile).  The full forward goes through
``ops.attention.attention(causal=True)``: the flash kernels K1 forward
and K2/K3 backward on tile-aligned shapes, autograd summing each
group's dK/dV.  The projections and the decode cache stay at the Hkv
width: ``new_cache`` holds [B, Hkv, L, D] per layer.

Decode (``forward(ids, cache)`` with a ``ContiguousKVCache``): RoPE at
each row's positions ``cache.index + arange(S)``, applied before K is
written, so cached keys carry their absolute positions.  S > 1 is the
prefill of an empty cache, causal over the prompt (K1 from the aligned
buckets up); a prefill of a warm cache raises (the JAX module returns
NaN for it).  S == 1 is plain masked attention over the repeated cache
(``implementation="xla"``): the JAX Llama has no paged cache and no K6
path, and no slot-indexed mode, so the serving engine refuses it.

RoPE's frequencies and angles are float32, and so are x's two halves
whatever x's dtype; the result is cast back.  The frequencies are
``theta ** (-arange(half) / half)`` rounded once from float64, which is
what XLA's float32 power gives (``torch.pow`` in float32 is an ulp off
at some entries, and at position 2047 an ulp of a frequency moves the
angle by 1e-4).  The tables are computed once a forward and are no
buffer, so a Llama checkpoint's leaves are exactly the JAX package's.

``dtype`` is the compute dtype (``models/layers.py``): the embedding is
cast to it, the blocks and ``ln_final`` compute in it, the parameters
stay float32, and the caches hold K/V in it.  The logits are
``x.float() @ lm_head.float()``; with ``loss_chunk`` > 0,
``forward(ids, targets=...)`` returns the mean LM loss through
``ops.losses.chunked_lm_cross_entropy(x, lm_head.T, ...)`` without the
[B, S, V] logits.  ``remat`` runs each block under
``layers.remat_call`` (``remat_policy`` 'none' or 'dots'); ``mesh`` is
not ported and is refused.  Llama has no dropout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ml_trainer_tpu_torch.device import resolve_device
from ml_trainer_tpu_torch.models.layers import (
    ContiguousKVCache,
    Dense,
    RMSNorm,
    _cast,
    check_remat_policy,
    compute_dtype,
    remat_call,
)
from ml_trainer_tpu_torch.models.registry import register_model
from ml_trainer_tpu_torch.ops.attention import attention
from ml_trainer_tpu_torch.ops.losses import chunked_lm_cross_entropy

Rope = Tuple[torch.Tensor, torch.Tensor]


def rope_tables(positions: torch.Tensor, half: int,
                theta: float = 10000.0) -> Rope:
    """``(cos, sin)`` of the rotary angles, float32, shaped to broadcast
    over [B, H, S, half]: positions [S] give [1, 1, S, half], per-row
    positions [B, S] give [B, 1, S, half]."""
    expo = -torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = (theta ** expo.double()).float()
    angles = positions.float()[..., None] * freqs
    angles = angles[None, None] if angles.ndim == 2 else angles[:, None]
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, rope: Rope) -> torch.Tensor:
    cos, sin = rope
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding, rotate-half convention: x [B, H, S, D]
    (D even); positions [S], or [B, S] for a position per row."""
    return _rotate(x, rope_tables(positions, x.shape[-1] // 2, theta))


class GQAttention(nn.Module):
    """Grouped-query attention: bias-free ``q``/``k``/``v``/``proj``; K
    and V repeated to ``num_heads`` only at the attention call."""

    def __init__(self, embed_dim: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by "
                             f"num_kv_heads {num_kv_heads}")
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.head_dim = head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q = Dense(embed_dim, num_heads * head_dim, **kw)
        self.k = Dense(embed_dim, num_kv_heads * head_dim, **kw)
        self.v = Dense(embed_dim, num_kv_heads * head_dim, **kw)
        self.proj = Dense(num_heads * head_dim, embed_dim, **kw)

    def forward(self, x, rope: Rope, cache=None, layer: int = 0,
                attention_impl: str = "auto"):
        b, s, _ = x.shape
        h, hk, d = self.num_heads, self.num_kv_heads, self.head_dim

        def heads(t, n):  # [B, S, n * D] -> [B, n, S, D]
            return t.reshape(b, s, n, d).transpose(1, 2)

        q = _rotate(heads(self.q(x), h), rope)
        k = _rotate(heads(self.k(x), hk), rope)
        v = heads(self.v(x), hk)
        rep = h // hk
        if cache is not None and s == 1:
            out = self._decode_step(q, k, v, cache, layer, rep)
        else:
            if cache is not None:
                # The prefill of an empty cache (LlamaLM.forward refuses a
                # warm one): K/V land at [0, s).
                ck, cv = cache.k[layer], cache.v[layer]
                ck[:, :, :s] = k.to(ck.dtype)
                cv[:, :, :s] = v.to(cv.dtype)
            out = attention(q, k.repeat_interleave(rep, dim=1),
                            v.repeat_interleave(rep, dim=1), causal=True,
                            implementation=attention_impl)
        return self.proj(out.transpose(1, 2).reshape(b, s, h * d))

    @staticmethod
    def _decode_step(q, k, v, cache, layer, rep):
        """S == 1: this token's K/V written at each row's position, then
        masked attention over the valid prefix of the repeated cache."""
        b = q.shape[0]
        idx, L = cache.index, cache.max_len
        ck, cv = cache.k[layer], cache.v[layer]
        rows = torch.arange(b, device=q.device)
        # Clamped like lax.dynamic_update_slice.
        pos = torch.clamp(idx, max=L - 1)
        ck[rows, :, pos] = k[:, :, 0].to(ck.dtype)
        cv[rows, :, pos] = v[:, :, 0].to(cv.dtype)
        valid = (torch.arange(L, device=q.device)[None, :]
                 <= idx[:, None])[:, None, None, :]
        return attention(q, ck.repeat_interleave(rep, dim=1),
                         cv.repeat_interleave(rep, dim=1), causal=False,
                         mask=valid, implementation="xla")


class LlamaBlock(nn.Module):
    """Pre-RMSNorm block: ``x + attn(ln1(x))``, then ``x + down(silu(
    gate(y)) * up(y))`` with ``y = ln2(x)``."""

    def __init__(self, embed_dim: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, hidden_dim: int, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = RMSNorm(embed_dim, **kw)
        self.attn = GQAttention(embed_dim, num_heads, num_kv_heads,
                                head_dim, **kw)
        self.ln2 = RMSNorm(embed_dim, **kw)
        self.gate = Dense(embed_dim, hidden_dim, bias=False, **kw)
        self.up = Dense(embed_dim, hidden_dim, bias=False, **kw)
        self.down = Dense(hidden_dim, embed_dim, bias=False, **kw)

    def forward(self, x, rope: Rope, cache=None, layer: int = 0,
                attention_impl: str = "auto"):
        x = x + self.attn(self.ln1(x), rope, cache, layer, attention_impl)
        y = self.ln2(x)
        return x + self.down(F.silu(self.gate(y)) * self.up(y))


class LlamaLM(nn.Module):
    """Causal Llama-style LM; ``forward`` has ``GPT2.forward``'s contract
    (logits, ``select``'s rows, or with ``targets`` the chunked loss)."""

    def __init__(self, vocab_size: int = 32000, max_len: int = 2048,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 num_kv_heads: int = 4, hidden_dim: int = 0,
                 rope_theta: float = 10000.0, attention_impl: str = "auto",
                 remat: bool = False, remat_policy: str = "none",
                 loss_chunk: int = 0, mesh=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError(
                f"mesh={mesh!r} is not ported yet; see ROADMAP.md Queue A")
        if remat:
            check_remat_policy(remat_policy)
        self.remat, self.remat_policy = bool(remat), remat_policy
        device = resolve_device(device)
        # The Llama default: ~8/3 of the width, rounded up to 128.
        hidden = hidden_dim or ((8 * embed_dim // 3) + 127) // 128 * 128
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.head_dim = embed_dim // num_heads
        self.rope_theta = rope_theta
        # 'auto' | 'xla' | 'flash', as in GPT2.
        self.attention_impl = attention_impl
        self.loss_chunk = int(loss_chunk)
        self.dtype = dtype
        cdt = compute_dtype(dtype)
        self.tok_embed = nn.Embedding(vocab_size, embed_dim, device=device)
        self.blocks = nn.ModuleList(
            LlamaBlock(embed_dim, num_heads, num_kv_heads, self.head_dim,
                       hidden, device=device, dtype=cdt)
            for _ in range(depth))
        self.ln_final = RMSNorm(embed_dim, device=device, dtype=cdt)
        self.lm_head = nn.Parameter(
            torch.zeros(embed_dim, vocab_size, device=device))

    @property
    def device(self) -> torch.device:
        return self.lm_head.device

    def new_cache(self, batch: int, max_len: Optional[int] = None
                  ) -> ContiguousKVCache:
        """A contiguous cache at the ``num_kv_heads`` width, in the
        compute dtype (the parameters' when that is None)."""
        return ContiguousKVCache(
            self.depth, batch, self.num_kv_heads, max_len or self.max_len,
            self.head_dim,
            dtype=compute_dtype(self.dtype) or self.lm_head.dtype,
            device=self.device)

    def _head(self, x, targets=None):
        x = self.ln_final(x)
        if targets is not None:
            if not self.loss_chunk:
                raise ValueError(
                    "targets requires loss_chunk > 0 (a divisor of the "
                    "sequence length)")
            return chunked_lm_cross_entropy(x, self.lm_head.T, targets,
                                            self.loss_chunk)
        return x.float() @ self.lm_head.float()

    def forward(self, input_ids, cache=None, select=None, targets=None):
        """Logits [B, S, V]; with ``select`` ([B] position per row) only
        those rows' logits [B, V]; with ``targets`` ([B, S] next-token
        labels; needs ``loss_chunk``) the mean LM loss.  With a cache,
        the call writes its K/V there and advances the positions by S."""
        s = input_ids.shape[1]
        x = _cast(self.tok_embed(input_ids), compute_dtype(self.dtype))
        steps = torch.arange(s, device=x.device)
        if cache is None:
            positions = steps
        else:
            if s > 1 and bool((cache.index != 0).any()):
                raise ValueError(
                    "a multi-token call is the prefill of an empty cache; "
                    "this cache already holds tokens")
            if s > cache.max_len:
                raise ValueError(f"prefill of {s} tokens exceeds the cache "
                                 f"length {cache.max_len}")
            positions = cache.index[:, None] + steps[None, :]
        rope = rope_tables(positions, self.head_dim // 2, self.rope_theta)
        remat = self.remat and cache is None
        for i, block in enumerate(self.blocks):
            x = remat_call(block, remat, self.remat_policy, x, rope, cache, i,
                           self.attention_impl)
        if cache is not None:
            cache.advance(s)
        if targets is not None:
            return self._head(x, targets)
        if select is not None:
            x = x[torch.arange(x.shape[0], device=x.device), select][:, None]
            return self._head(x)[:, 0]
        return self._head(x)


@register_model("llama")
def llama(**kw) -> LlamaLM:
    """Llama-style 124.7M (GQA 12 query over 4 kv heads, SwiGLU 2048,
    RoPE; vocab 32000, max_len 2048, 768 wide, 12 deep)."""
    return LlamaLM(**kw)


@register_model("llama_tiny")
def llama_tiny(**kw) -> LlamaLM:
    """Small Llama for tests: 2 layers, 64 wide, 4 heads over 2 kv heads,
    1k vocab."""
    kw.setdefault("vocab_size", 1024)
    kw.setdefault("max_len", 128)
    kw.setdefault("embed_dim", 64)
    kw.setdefault("depth", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("num_kv_heads", 2)
    return LlamaLM(**kw)

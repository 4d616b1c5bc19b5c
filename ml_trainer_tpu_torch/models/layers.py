"""Transformer building blocks in PyTorch, with the JAX package's two
decode caches.

All attention goes through ``ops.attention``, so the flash kernel and
the plain path sit behind one module.  Numerics follow flax's defaults,
which differ from PyTorch's: LayerNorm epsilon is 1e-6 (PyTorch: 1e-5)
and GELU is the tanh approximation (PyTorch: exact erf).  Weights are
``nn.Linear``'s [out, in]; ``convert.params_from_jax`` transposes the
flax [in, out] kernels.

Decode caches.  The JAX package keeps K/V in a flax ``cache``
collection that every call returns anew; here the cache is an explicit
object of tensors that the forward UPDATES IN PLACE (writes at each
row's position, then ``advance``).  Two layouts, as in the reference:

* ``ContiguousKVCache``: per layer [B, H, L, D] and a per-row position
  vector.  A call with S > 1 is the PREFILL of an empty cache (plain
  causal attention over the prompt itself, the flash kernel's route);
  S == 1 is the decode step over the valid prefix ``arange(L) <= idx``.
* ``PagedKVCache``: per layer one pool [N, H, page, D] shared by every
  row, a per-row page table [B, P] and positions.  Writes scatter the
  length-S window at each row's own offset (positions at or past L go
  to the trash page 0); reads either gather the pages back into logical
  order for the plain path, or, when the cache's ``paged_kernel`` is
  set and S == 1, run the paged-attention kernel on the pool directly.

Int8 projections.  A layer given its entries of the "quant" collection
(``ops/kernels/int8_matmul.quantize_tree``) computes qkv / proj / fc_in /
fc_out as ``int8_matmul(x, w, scale) + b`` at its compute dtype instead
of its ``nn.Linear``; ``quant_impl="reference"`` takes the plain version
on either device.

Both caches hold K/V at the model's compute dtype (float32 when it is
None), as the JAX package's ``cached_key``/``cached_value``; the writes
cast to it and the reads attend the cached tensors as they are.

Compute dtype.  A module's ``dtype`` is the dtype it COMPUTES in, as
flax's ``dtype=``; its parameters stay float32 (flax's ``param_dtype``).
``Dense`` casts its input, weight and bias to ``dtype``; ``LayerNorm``
and ``RMSNorm`` (Llama's) normalise in float32 and return ``dtype``, as
flax's ``nn.LayerNorm(dtype=...)`` and ``nn.RMSNorm(dtype=...)``.
``dtype=None`` casts nothing and computes in the dtype the tensors
already have: the pre-policy float32 program,
bit for bit (and float64 after ``model.to(torch.float64)``).  The model
families map their public ``dtype`` knob through ``compute_dtype``:
float32 -> None.

Convolutions and BatchNorm (the image families).  ``Conv`` is flax's
``nn.Conv`` over an NCHW-shaped tensor, with flax's "SAME" padding for
any stride (the odd pixel of an uneven split goes to the high side, which
``nn.Conv2d(padding=k // 2)`` does not reproduce at stride 2).
``BatchNorm`` is flax's ``nn.BatchNorm(momentum=0.9)``: batch mean and
BIASED batch variance in train mode, running statistics updated as
``r = 0.9 r + 0.1 batch`` (torch's ``BatchNorm2d`` updates the variance
with the unbiased one), epsilon 1e-5.  With a compute dtype, ``Conv``
casts like ``Dense`` and ``BatchNorm`` normalises in float32 (batch
statistics included) and returns ``dtype``; the running statistics stay
float32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from ml_trainer_tpu_torch.ops.attention import attention
from ml_trainer_tpu_torch.ops.kernels.int8_matmul import int8_matmul
from ml_trainer_tpu_torch.ops.kernels.paged_attention import paged_attention

# flax.linen.LayerNorm's default epsilon.
LN_EPS = 1e-6
# flax.linen.BatchNorm's epsilon, and the momentum the JAX package's
# image families pass it (the weight of the old running value).
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def compute_dtype(dtype: torch.dtype) -> Optional[torch.dtype]:
    """A family's ``dtype`` knob as its layers' compute dtype: None (cast
    nothing, the pre-policy program) for float32."""
    return None if dtype == torch.float32 else dtype


def _cast(t, dtype: Optional[torch.dtype]):
    return t if dtype is None or t is None else t.to(dtype)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)`` as an ``nn.Linear``: float32 weight
    [out, in] and bias; input, weight and bias cast to ``dtype`` for the
    product (None: no cast)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.dtype = dtype

    def forward(self, x):
        return F.linear(*(_cast(t, self.dtype)
                          for t in (x, self.weight, self.bias)))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: float32 scale and bias; with a
    compute dtype the statistics and the normalisation run in float32
    and the result is cast to ``dtype`` (None: no cast)."""

    def __init__(self, features: int, eps: float = 1e-6, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(features, eps=eps, device=device)
        self.dtype = dtype

    def forward(self, x):
        if self.dtype is None:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(self.dtype)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(dtype=...)``: a float32 ``weight`` (flax's
    ``scale``) and flax's order of operations, which ``F.rms_norm`` does
    not keep: ``var = mean(x^2)`` in at least float32, ``mul = rsqrt(var +
    eps) * scale``, ``y = x * mul``, then the cast to ``dtype`` (None: to
    the promoted dtype of ``x`` and the weight, as ``LayerNorm``)."""

    def __init__(self, features: int, eps: float = 1e-6, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * (torch.rsqrt(var + self.eps) * self.weight)
        out = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return y.to(out)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` (approximate=True): the tanh form."""
    return F.gelu(x, approximate="tanh")


def _dense(linear: "Dense", name: str, x, quant, quant_impl: str):
    """``linear(x)``, or with the layer's quant entries the int8
    projection ``int8_matmul(x, <name>_w, <name>_scale) + <name>_b`` at the
    layer's compute dtype (the JAX package's ``_quant_dense``: the product
    rounded to that dtype, then the bias added in it; the bias add is
    fused)."""
    if quant is None:
        return linear(x)
    return int8_matmul(_cast(x, linear.dtype),
                       quant[f"{name}_w"], quant[f"{name}_scale"],
                       bias=quant[f"{name}_b"], implementation=quant_impl)


class ContiguousKVCache:
    """Per-row contiguous K/V ([B, H, L, D] per layer) plus each row's
    position; the model's forward writes and advances it in place."""

    paged = False

    def __init__(self, depth: int, batch: int, heads: int, max_len: int,
                 head_dim: int, dtype=torch.float32, device=None):
        shape = (batch, heads, max_len, head_dim)
        self.k: List[torch.Tensor] = [
            torch.zeros(shape, dtype=dtype, device=device) for _ in range(depth)
        ]
        self.v: List[torch.Tensor] = [
            torch.zeros(shape, dtype=dtype, device=device) for _ in range(depth)
        ]
        self.max_len = max_len
        self.index = torch.zeros(batch, dtype=torch.long, device=device)

    def advance(self, s: int) -> None:
        self.index += s


class PagedKVCache:
    """One K/V page pool per layer ([N, H, page, D], page 0 the trash
    page), a per-row page table and per-row positions; updated in place."""

    paged = True

    def __init__(self, depth: int, num_pages: int, heads: int,
                 page_size: int, head_dim: int, batch: int, max_len: int,
                 paged_kernel: bool = False, dtype=torch.float32,
                 device=None):
        if max_len % page_size:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of page_size "
                f"({page_size})"
            )
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the trash page), got "
                f"{num_pages}"
            )
        shape = (num_pages, heads, page_size, head_dim)
        self.k = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(depth)]
        self.v = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(depth)]
        self.page_size = page_size
        self.max_len = max_len
        # S == 1 reads go through the paged-attention kernel.
        self.paged_kernel = paged_kernel
        self.table = torch.zeros((batch, max_len // page_size),
                                 dtype=torch.int32, device=device)
        self.index = torch.zeros(batch, dtype=torch.long, device=device)

    def view(self, table: torch.Tensor, index: torch.Tensor) -> "PagedKVCache":
        """A cache over the SAME pools with other rows' table and
        positions (the engine's batch-1 continuation prefill): writes
        through the view land in the shared pools."""
        out = PagedKVCache.__new__(PagedKVCache)
        out.k, out.v = self.k, self.v
        out.page_size, out.max_len = self.page_size, self.max_len
        out.paged_kernel = self.paged_kernel
        out.table, out.index = table, index
        return out

    def advance(self, s: int) -> None:
        self.index += s


class MultiHeadAttention(nn.Module):
    """Self-attention over [B, S, E] with a fused QKV projection."""

    def __init__(self, embed_dim: int, num_heads: int, causal: bool = False,
                 device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.qkv = Dense(embed_dim, 3 * embed_dim, device=device, dtype=dtype)
        self.proj = Dense(embed_dim, embed_dim, device=device, dtype=dtype)

    def forward(self, x, cache=None, layer: int = 0, mask=None,
                kv_lens=None, attention_impl: str = "auto", quant=None,
                quant_impl: str = "auto"):
        b, s, e = x.shape
        qkv = _dense(self.qkv, "qkv", x, quant, quant_impl)
        q, k, v = qkv.split(e, dim=-1)

        def heads(t):  # [B, S, E] -> [B, H, S, D]
            return t.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        if cache is None:
            out = attention(q, k, v, causal=self.causal, mask=mask,
                            kv_lens=kv_lens, implementation=attention_impl)
        else:
            if mask is not None or kv_lens is not None:
                raise ValueError(
                    "decode mode attends the cached prefix; mask/kv_lens "
                    "are not supported"
                )
            if cache.paged:
                out = self._paged_step(q, k, v, cache, layer)
            else:
                out = self._contiguous_step(q, k, v, cache, layer,
                                            attention_impl)
        out = out.transpose(1, 2).reshape(b, s, e)
        return _dense(self.proj, "proj", out, quant, quant_impl)

    def _contiguous_step(self, q, k, v, cache, layer, attention_impl):
        b, h, s, d = q.shape
        idx = cache.index
        L = cache.max_len
        ck, cv = cache.k[layer], cache.v[layer]
        if s > 1:
            # Prefill of an EMPTY cache: causal attention over the prompt
            # itself, K/V landing at positions [0, s).  A warm-cache
            # multi-token call would ignore the cached prefix, so its
            # output is poisoned to NaN, as in the JAX package.
            if s > L:
                raise ValueError(f"prefill of {s} tokens exceeds the cache "
                                 f"length {L}")
            ck[:, :, :s] = k.to(ck.dtype)
            cv[:, :, :s] = v.to(cv.dtype)
            q = torch.where((idx == 0)[:, None, None, None], q,
                            torch.full_like(q, float("nan")))
            return attention(q, k, v, causal=True,
                             implementation=attention_impl)
        rows = torch.arange(b, device=q.device)
        # Clamped like lax.dynamic_update_slice: rows that ran past the
        # end (inactive slots) rewrite the last position nobody reads.
        pos = torch.clamp(idx, max=L - 1)
        ck[rows, :, pos] = k[:, :, 0].to(ck.dtype)
        cv[rows, :, pos] = v[:, :, 0].to(cv.dtype)
        valid = (torch.arange(L, device=q.device)[None, :]
                 <= idx[:, None])[:, None, None, :]
        return attention(q, ck, cv, causal=False, mask=valid,
                         implementation="xla")

    def _paged_step(self, q, k, v, cache, layer):
        b, h, s, d = q.shape
        ps, L = cache.page_size, cache.max_len
        P = L // ps
        idx, table = cache.index, cache.table
        pool_k, pool_v = cache.k[layer], cache.v[layer]

        # -- write: scatter the window at each row's own offset ----------
        positions = idx[:, None] + torch.arange(s, device=q.device)[None, :]
        page_slot = torch.clamp(positions // ps, 0, P - 1)
        page_ids = torch.where(
            positions < L,
            torch.gather(table.long(), 1, page_slot),
            torch.zeros_like(positions),
        ).reshape(-1)
        offs = (positions % ps).reshape(-1)
        pool_k[page_ids, :, offs] = (
            k.transpose(1, 2).reshape(b * s, h, d).to(pool_k.dtype))
        pool_v[page_ids, :, offs] = (
            v.transpose(1, 2).reshape(b * s, h, d).to(pool_v.dtype))

        # -- read ---------------------------------------------------------
        if cache.paged_kernel and s == 1:
            # This step's token is included: lengths = idx + 1.
            out = paged_attention(q[:, :, 0, :], pool_k, pool_v, table,
                                  (idx + 1).to(torch.int32))
            return out[:, :, None, :]
        tl = table.long()

        def gather(pool):  # [B, P, H, page, D] -> [B, H, L, D]
            return pool[tl].permute(0, 2, 1, 3, 4).reshape(b, h, L, d)

        valid = (
            torch.arange(L, device=q.device)[None, None, :]
            <= positions[:, :, None]
        )[:, None, :, :]
        return attention(q, gather(pool_k), gather(pool_v), causal=False,
                         mask=valid, implementation="xla")


class MLP(nn.Module):
    """Transformer feed-forward block (tanh GELU, as flax's nn.gelu)."""

    def __init__(self, embed_dim: int, hidden_dim: int, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc_in = Dense(embed_dim, hidden_dim, device=device, dtype=dtype)
        self.fc_out = Dense(hidden_dim, embed_dim, device=device, dtype=dtype)

    def forward(self, x, quant=None, quant_impl: str = "auto"):
        h = gelu(_dense(self.fc_in, "fc_in", x, quant, quant_impl))
        return _dense(self.fc_out, "fc_out", h, quant, quant_impl)


def _refuse_unported(dropout_rate=0.0, moe_experts=0, lora_rank=0) -> None:
    for knob, value in (("dropout_rate", dropout_rate),
                        ("moe_experts", moe_experts),
                        ("lora_rank", lora_rank)):
        if value:
            raise NotImplementedError(
                f"{knob}={value!r} is not ported yet; see ROADMAP.md "
                "Queue A"
            )


class TransformerBlock(nn.Module):
    """Pre-LN transformer block (GPT-2); ``post_norm`` is the BERT
    arrangement.  Dropout, MoE and LoRA are not ported yet and are
    refused.  ``quant`` is the block's entry of the "quant" collection
    (``{"attn": ..., "mlp": ...}``), threaded to its projections."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int,
                 causal: bool = False, post_norm: bool = False, device=None,
                 dtype: Optional[torch.dtype] = None,
                 dropout_rate: float = 0.0, moe_experts: int = 0,
                 lora_rank: int = 0):
        super().__init__()
        _refuse_unported(dropout_rate, moe_experts, lora_rank)
        self.post_norm = post_norm
        self.ln1 = LayerNorm(embed_dim, eps=LN_EPS, device=device,
                             dtype=dtype)
        self.ln2 = LayerNorm(embed_dim, eps=LN_EPS, device=device,
                             dtype=dtype)
        self.attn = MultiHeadAttention(embed_dim, num_heads, causal=causal,
                                       device=device, dtype=dtype)
        self.mlp = MLP(embed_dim, mlp_dim, device=device, dtype=dtype)

    def forward(self, x, cache=None, layer: int = 0, mask=None, kv_lens=None,
                attention_impl: str = "auto", quant=None,
                quant_impl: str = "auto"):
        q_attn = q_mlp = None
        if quant is not None:
            q_attn, q_mlp = quant["attn"], quant["mlp"]

        def attn(y):
            return self.attn(y, cache, layer, mask=mask, kv_lens=kv_lens,
                             attention_impl=attention_impl, quant=q_attn,
                             quant_impl=quant_impl)

        def mlp(y):
            return self.mlp(y, quant=q_mlp, quant_impl=quant_impl)

        if self.post_norm:
            x = self.ln1(x + attn(x))
            return self.ln2(x + mlp(x))
        x = x + attn(self.ln1(x))
        return x + mlp(self.ln2(x))


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one spatial dim: ``ceil(size / stride)``
    outputs, the total padding split low/high with the odd pixel high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` on an NCHW-shaped tensor (a channels-last view of
    the NHWC batch is fine): ``weight`` [out, in, kh, kw] is flax's HWIO
    ``kernel`` transposed.  ``padding``: "SAME" (flax's split, computed
    from each input's size), "VALID", or ``((top, bottom), (left,
    right))``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1,
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                 bias: bool = True, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel, kernel, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if bias else None)

    def _pads(self, h: int, w: int):
        if self.padding == "SAME":
            return (same_pads(h, self.kernel, self.stride),
                    same_pads(w, self.kernel, self.stride))
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x):
        (top, bottom), (left, right) = self._pads(*x.shape[-2:])
        x, w, b = (_cast(t, self.dtype) for t in (x, self.weight, self.bias))
        if top == bottom and left == right:
            return F.conv2d(x, w, b, self.stride, (top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b,
                        self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over dim 1 of an NCHW-shaped (or [B, C])
    tensor: ``weight``/``bias`` are flax's ``scale``/``bias``,
    ``running_mean``/``running_var`` its ``batch_stats`` ``mean``/``var``.

    Train mode normalises with the batch mean and biased variance and
    updates the running statistics as ``momentum * r + (1 - momentum) *
    batch`` with the BIASED variance; eval mode normalises with the
    running statistics.  ``F.batch_norm`` does the normalising (cuDNN on
    the card); its own running update, which takes the unbiased variance,
    writes only to scratch buffers at momentum 1, whose variance is turned
    biased before the flax update."""

    def __init__(self, num_features: int, momentum: float = BN_MOMENTUM,
                 eps: float = BN_EPS, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(
            num_features, device=device))
        self.register_buffer("running_var", torch.ones(
            num_features, device=device))

    def forward(self, x):
        if self.dtype is None:
            return self._normalize(x, self.weight, self.bias)
        return self._normalize(x.float(), self.weight.float(),
                               self.bias.float()).to(self.dtype)

    def _normalize(self, x, weight, bias):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                weight, bias, False, 0.0, self.eps)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        out = F.batch_norm(x, mean, var, weight, bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var
                                   + (1 - m) * (var * ((n - 1) / n)))
        return out

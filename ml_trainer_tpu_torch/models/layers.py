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

LoRA (the JAX package's ``lora_delta``).  A ``MultiHeadAttention`` or
``MLP`` built with ``lora_rank`` > 0 adds a low-rank delta AFTER the base
projection of each of its ``lora_targets`` (``LORA_TARGETS``), so the
base product is the same op on the same shapes as without LoRA.  Train
mode (``lora_slots == 0``): float32 parameters ``<target>_lora_A`` [in,
r] and ``<target>_lora_B`` [r, out] (flax's layout; ``init_lora`` draws
A from N(0, 0.01^2) and zeroes B) and the delta ``(x A B) * alpha / r``
with x, A and B cast to the compute dtype.  Serve mode (``lora_slots``
S > 0): buffers of stacks ``A`` [S, in, r] and ``B`` [S, r, out] at the
compute dtype (float32 when it is None), written in place by the
serving engine's adapter pool with ``alpha / r`` folded into B, and
each row's delta ``(x A[idx]) B[idx]`` from the per-row
``adapter_idx`` ([B] int64, a device tensor; None reads slot 0): a
gather on the device, so that a CUDA graph of the decode step serves
whatever the rows point at when it is replayed.  Slot 0 stays zero, so
a row with no adapter adds an exact zero.

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

Dropout.  ``Dropout`` is flax's ``nn.Dropout``: ``where(keep, x /
(1 - rate), 0)``, only in training mode and never in decode mode (the
JAX package's decode modules run ``train=False``).  Its mask is no draw
from a generator but a counter-based integer hash (``DropoutStream``) of
the seed, the step, the site (the module's place among the model's
dropout modules) and the element's index in the step's global batch:
the same key gives the same bits on every device, a replayed CUDA graph
reads the step from a device tensor, a recompute under remat redraws the
same mask, and the microbatches and replicas of a step see the masks of
the whole batch at once.  ``jax.random`` is not reproduced.

Rematerialisation.  ``remat_call`` runs a block under
``torch.utils.checkpoint`` (non-reentrant): policy 'none' recomputes
everything in the backward, 'dots' keeps the 2-D matmul outputs (the
``Dense`` projections, the JAX package's ``dots_with_no_batch_dims``)
and recomputes the rest, attention included.  The flash kernels are
launched outside PyTorch's dispatcher, so under either policy the
forward kernel K1 runs again in the backward.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils import checkpoint as _checkpoint

from ml_trainer_tpu_torch.ops.attention import attention
from ml_trainer_tpu_torch.ops.kernels.int8_matmul import int8_matmul
from ml_trainer_tpu_torch.ops.kernels.paged_attention import paged_attention

# flax.linen.LayerNorm's default epsilon.
LN_EPS = 1e-6
# flax.linen.BatchNorm's epsilon, and the momentum the JAX package's
# image families pass it (the weight of the old running value).
BN_EPS = 1e-5
BN_MOMENTUM = 0.9

# Dense targets a LoRA adapter may attach to: the attention and MLP
# projections.  Embeddings and the tied LM head stay base-only.
LORA_TARGETS = ("qkv", "proj", "fc_in", "fc_out")


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


def _add_lora(mdl: nn.Module, dims: Dict[str, Tuple[int, int]],
              lora_rank: int, lora_alpha: float, lora_slots: int,
              lora_targets: Sequence[str], device, dtype) -> None:
    """Give ``mdl`` the LoRA fields and, for each of its projections
    ``dims`` (name -> (in, out)) among ``lora_targets``, the train-mode
    parameters or the serve-mode stack buffers (zeros)."""
    mdl.lora_rank, mdl.lora_alpha = int(lora_rank), float(lora_alpha)
    mdl.lora_slots = int(lora_slots)
    mdl.lora_targets = tuple(lora_targets)
    if not mdl.lora_rank:
        return
    r, s = mdl.lora_rank, mdl.lora_slots
    for name, (n_in, n_out) in dims.items():
        if name not in mdl.lora_targets:
            continue
        if s:
            stack = dtype or torch.float32
            mdl.register_buffer(f"{name}_lora_A", torch.zeros(
                (s, n_in, r), dtype=stack, device=device), persistent=False)
            mdl.register_buffer(f"{name}_lora_B", torch.zeros(
                (s, r, n_out), dtype=stack, device=device), persistent=False)
        else:
            setattr(mdl, f"{name}_lora_A", nn.Parameter(
                torch.zeros((n_in, r), device=device)))
            setattr(mdl, f"{name}_lora_B", nn.Parameter(
                torch.zeros((r, n_out), device=device)))


def lora_delta(mdl: nn.Module, name: str, x, adapter_idx=None):
    """The low-rank delta of target ``name`` on the projection input
    ``x`` [B, S, in], or None when ``name`` carries no adapter."""
    if not (mdl.lora_rank and name in mdl.lora_targets):
        return None
    A = getattr(mdl, f"{name}_lora_A")
    B = getattr(mdl, f"{name}_lora_B")
    if mdl.lora_slots:
        if adapter_idx is None:
            adapter_idx = torch.zeros(x.shape[0], dtype=torch.long,
                                      device=x.device)
        a = A.index_select(0, adapter_idx)           # [B, in, r]
        b = B.index_select(0, adapter_idx)           # [B, r, out]
        return torch.bmm(torch.bmm(x.to(a.dtype), a), b)
    dt = mdl.dtype
    return (_cast(x, dt) @ _cast(A, dt) @ _cast(B, dt)) * (
        mdl.lora_alpha / mdl.lora_rank)


def _plus(y, delta):
    return y if delta is None else y + delta


@torch.no_grad()
def init_lora(model: nn.Module, seed: int = 0) -> None:
    """Draw every train-mode adapter of ``model``: A from N(0, 0.01^2)
    by a seeded CPU generator (in the parameters' order), B zero, so
    that the model starts as its base."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        if name.endswith("_lora_A"):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.01)
        elif name.endswith("_lora_B"):
            p.zero_()


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
                 device=None, dtype: Optional[torch.dtype] = None,
                 lora_rank: int = 0, lora_alpha: float = 1.0,
                 lora_slots: int = 0, lora_targets: Sequence[str] = ()):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.dtype = dtype
        self.qkv = Dense(embed_dim, 3 * embed_dim, device=device, dtype=dtype)
        self.proj = Dense(embed_dim, embed_dim, device=device, dtype=dtype)
        _add_lora(self, {"qkv": (embed_dim, 3 * embed_dim),
                         "proj": (embed_dim, embed_dim)},
                  lora_rank, lora_alpha, lora_slots, lora_targets, device,
                  dtype)

    def forward(self, x, cache=None, layer: int = 0, mask=None,
                kv_lens=None, attention_impl: str = "auto", quant=None,
                quant_impl: str = "auto", adapter_idx=None):
        b, s, e = x.shape
        qkv = _plus(_dense(self.qkv, "qkv", x, quant, quant_impl),
                    lora_delta(self, "qkv", x, adapter_idx))
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
        return _plus(_dense(self.proj, "proj", out, quant, quant_impl),
                     lora_delta(self, "proj", out, adapter_idx))

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
                 dtype: Optional[torch.dtype] = None, lora_rank: int = 0,
                 lora_alpha: float = 1.0, lora_slots: int = 0,
                 lora_targets: Sequence[str] = ()):
        super().__init__()
        self.dtype = dtype
        self.fc_in = Dense(embed_dim, hidden_dim, device=device, dtype=dtype)
        self.fc_out = Dense(hidden_dim, embed_dim, device=device, dtype=dtype)
        _add_lora(self, {"fc_in": (embed_dim, hidden_dim),
                         "fc_out": (hidden_dim, embed_dim)},
                  lora_rank, lora_alpha, lora_slots, lora_targets, device,
                  dtype)

    def forward(self, x, quant=None, quant_impl: str = "auto",
                adapter_idx=None):
        h = gelu(_plus(_dense(self.fc_in, "fc_in", x, quant, quant_impl),
                       lora_delta(self, "fc_in", x, adapter_idx)))
        return _plus(_dense(self.fc_out, "fc_out", h, quant, quant_impl),
                     lora_delta(self, "fc_out", h, adapter_idx))


def _refuse_unported(moe_experts=0) -> None:
    if moe_experts:
        raise NotImplementedError(
            f"moe_experts={moe_experts!r} is not ported yet; see ROADMAP.md "
            "Queue A"
        )


# The hash works on 32-bit words held in int64 tensors.
_M32 = 0xFFFFFFFF


def _mix32(x):
    """A bijective 32-bit mixer (xor-shift, multiply; the shape of
    lowbias32) on int64 tensors or ints holding 32-bit words.  Both
    multipliers are below 2**31, so no product of a 32-bit word reaches
    2**63: the int64 arithmetic is exact on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


class DropoutStream:
    """Where one model's dropout masks come from: a counter-based hash,
    no generator state.

    An element is kept when ``mix32(index ^ key) >= rate * 2**32``, with
    ``index`` its place in the step's global batch (``row0`` rows before
    the microbatch, row-major within it) and ``key`` the site's word of
    the step: ``mix32((step mod 2**32) ^ mix32(mix32(seed) ^ site))``.
    ``begin_step(step)`` computes every site's key from ``step``, a
    device tensor (int64), in a few device ops, so a CUDA graph of the
    step reads the step it replays; the keys stay until the next
    ``begin_step``.  The Trainer sets ``seed`` (the config's), calls
    ``begin_step`` at each step and sets ``row0`` before each
    microbatch's forward; a model used outside a Trainer drops with the
    keys of step 0.

    ``forced`` (a test hook): site -> a bool keep mask that replaces the
    hash's for that site."""

    def __init__(self, sites: int, seed: int = 0):
        self.sites = sites
        self.seed = seed
        self.row0 = 0
        self.keys: Optional[torch.Tensor] = None
        self._site_words: Dict[torch.device, torch.Tensor] = {}
        self.forced: Dict[int, torch.Tensor] = {}

    def reseed(self, seed: int) -> None:
        self.seed = int(seed)
        self._site_words.clear()
        self.keys = None

    def begin_step(self, step: torch.Tensor) -> None:
        words = self._site_words.get(step.device)
        if words is None:
            base = _mix32(self.seed & _M32)
            words = torch.tensor([_mix32(base ^ s) for s in range(self.sites)],
                                 dtype=torch.int64, device=step.device)
            self._site_words[step.device] = words
        self.keys = _mix32((step.to(torch.int64) & _M32) ^ words)

    def keep(self, site: int, shape, rate: float, device) -> torch.Tensor:
        """The bool keep mask of ``site`` for a tensor of ``shape``."""
        if site in self.forced:
            return self.forced[site].to(device)
        if (self.keys is None
                or self.keys.device.type != torch.device(device).type):
            self.begin_step(torch.zeros((), dtype=torch.int64,
                                        device=device))
        n = 1
        for d in shape:
            n *= int(d)
        start = self.row0 * (n // int(shape[0]))
        if start + n > 2 ** 32:
            raise ValueError(
                f"dropout indexes a step's elements in 32 bits; this one "
                f"reaches {start + n}")
        idx = torch.arange(start, start + n, dtype=torch.int64,
                           device=device)
        h = _mix32(idx ^ self.keys[site])
        return (h >= int(rate * 2 ** 32)).reshape(shape)


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: ``where(keep, x / (1 - rate), 0)`` in
    training mode, the identity in eval mode; the mask from the model's
    ``DropoutStream`` at this module's ``site`` (``attach_dropout``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.site = 0
        self.stream: Optional[DropoutStream] = None

    def forward(self, x):
        if not (self.training and self.rate):
            return x
        keep = self.stream.keep(self.site, x.shape, self.rate, x.device)
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


def attach_dropout(model: nn.Module) -> Optional[DropoutStream]:
    """Number the model's ``Dropout`` modules in registration order (the
    forward's order in every family) and give them one shared
    ``DropoutStream``; None when the model has none that drops."""
    drops = [m for m in model.modules()
             if isinstance(m, Dropout) and m.rate]
    if not drops:
        return None
    stream = DropoutStream(len(drops))
    for site, m in enumerate(drops):
        m.site, m.stream = site, stream
    return stream


def dropout_stream(model: nn.Module) -> Optional[DropoutStream]:
    """The model's ``DropoutStream`` (``attach_dropout``), or None."""
    for m in model.modules():
        if isinstance(m, Dropout) and m.stream is not None:
            return m.stream
    return None


def _save_dots(ctx, op, *args, **kwargs):
    """The 'dots' policy: keep the 2-D matmuls' outputs."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _checkpoint.CheckpointPolicy.MUST_SAVE
    return _checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def check_remat_policy(name: str) -> None:
    """Raise for a policy that is neither 'none' nor 'dots'."""
    if name not in ("none", "dots"):
        raise ValueError(
            f"Unknown remat_policy {name!r}; expected 'none' or 'dots'")


def remat_call(block: nn.Module, remat: bool, policy: str, *args,
               **kwargs):
    """``block(*args, **kwargs)``, under ``torch.utils.checkpoint`` when
    ``remat`` and autograd records (no checkpoint in eval or decode).
    The masks are a hash of device state, so no RNG state is kept for
    the recompute (a captured CUDA graph could not read it).  The
    recompute runs in the backward, after a ``functional_call`` (the
    precision policy's bf16 copies) has put the float32 parameters back:
    so the block runs on the parameters it holds now, passed in by name,
    and the recompute repeats the forward's ops on the same tensors."""
    if not (remat and torch.is_grad_enabled()):
        return block(*args, **kwargs)
    params = dict(block.named_parameters())

    def run(*a, **k):
        return torch.func.functional_call(block, params, a, k)

    extra = {}
    if policy == "dots":
        extra["context_fn"] = functools.partial(
            _checkpoint.create_selective_checkpoint_contexts, _save_dots)
    return _checkpoint.checkpoint(run, *args, use_reentrant=False,
                                  preserve_rng_state=False, **extra,
                                  **kwargs)


class TransformerBlock(nn.Module):
    """Pre-LN transformer block (GPT-2); ``post_norm`` is the BERT
    arrangement.  ``dropout_rate`` drops the attention's and the MLP's
    outputs (after ``proj`` and ``fc_out``, as the JAX package's
    ``MultiHeadAttention`` and ``MLP`` do) in training mode, never with a
    cache.  MoE is not ported yet and is refused.  The ``lora_*`` knobs
    go to the attention and the MLP (``lora_delta``), ``adapter_idx`` to
    their serve-mode gathers.  ``quant`` is the block's entry of the
    "quant" collection (``{"attn": ..., "mlp": ...}``), threaded to its
    projections."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int,
                 causal: bool = False, post_norm: bool = False, device=None,
                 dtype: Optional[torch.dtype] = None,
                 dropout_rate: float = 0.0, moe_experts: int = 0,
                 lora_rank: int = 0, lora_alpha: float = 1.0,
                 lora_slots: int = 0, lora_targets: Sequence[str] = ()):
        super().__init__()
        _refuse_unported(moe_experts)
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha,
                    lora_slots=lora_slots, lora_targets=lora_targets)
        self.post_norm = post_norm
        self.ln1 = LayerNorm(embed_dim, eps=LN_EPS, device=device,
                             dtype=dtype)
        self.ln2 = LayerNorm(embed_dim, eps=LN_EPS, device=device,
                             dtype=dtype)
        self.attn = MultiHeadAttention(embed_dim, num_heads, causal=causal,
                                       device=device, dtype=dtype, **lora)
        self.mlp = MLP(embed_dim, mlp_dim, device=device, dtype=dtype,
                       **lora)
        # Registered after attn and mlp: sites in the forward's order.
        self.attn_drop = Dropout(dropout_rate)
        self.mlp_drop = Dropout(dropout_rate)

    def forward(self, x, cache=None, layer: int = 0, mask=None, kv_lens=None,
                attention_impl: str = "auto", quant=None,
                quant_impl: str = "auto", adapter_idx=None):
        q_attn = q_mlp = None
        if quant is not None:
            q_attn, q_mlp = quant["attn"], quant["mlp"]

        def drop(module, y):
            return y if cache is not None else module(y)

        def attn(y):
            return drop(self.attn_drop, self.attn(
                y, cache, layer, mask=mask, kv_lens=kv_lens,
                attention_impl=attention_impl, quant=q_attn,
                quant_impl=quant_impl, adapter_idx=adapter_idx))

        def mlp(y):
            return drop(self.mlp_drop,
                        self.mlp(y, quant=q_mlp, quant_impl=quant_impl,
                                 adapter_idx=adapter_idx))

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

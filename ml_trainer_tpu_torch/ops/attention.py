"""Attention ops: the plain PyTorch path and the flash-attention forward
kernel (``csrc/flash_fwd.cu``), with the JAX package's auto/xla/flash
routing.

* ``dot_product_attention`` is the plain path: one score matrix, an
  ADDED ``finfo.min`` mask bias, softmax, the value product.  Its causal
  mask is bottom-right aligned, so it also serves cross-length shapes.
* ``flash_attention`` is the online-softmax forward kernel over
  [B, H, S, D] and returns ``(out, lse)``.  Its causal mask is
  diagonal-aligned; masked scores are REPLACED by ``finfo.min`` (never
  ``-inf``), and an optional ``kv_lens`` [B] masks the right-padded key
  tail.  On a CUDA tensor it launches the kernel; on a CPU tensor it
  runs ``flash_attention_reference``, its plain twin.  The backward
  kernels are not ported yet (ROADMAP.md Queue B, K2/K3).
* ``attention`` routes between the two exactly as the JAX package does
  on a TPU: the kernel for tile-aligned ``s_q == s_k`` with
  ``head_dim % 64 == 0``, the padded kernel from 1024 tokens up, the
  plain path otherwise.

Shapes follow the JAX package: [batch, heads, seq, head_dim].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ml_trainer_tpu_torch.device import count_launch


def _mask_bias(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    neg = torch.full((), torch.finfo(dtype).min, dtype=dtype,
                     device=mask.device)
    return torch.where(mask, zero, neg)


def dot_product_attention(q, k, v, *, causal: bool = False,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention.  q, k, v: [B, H, S, D] (k/v may have S_kv)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s_q, s_k = scores.shape[-2], scores.shape[-1]
    if causal:
        row = torch.arange(s_q, device=q.device)[:, None]
        col = torch.arange(s_k, device=q.device)[None, :]
        scores = scores + _mask_bias(row + (s_k - s_q) >= col, scores.dtype)
    if mask is not None:
        scores = scores + _mask_bias(mask, scores.dtype)
    weights = torch.softmax(scores, dim=-1)
    out = torch.matmul(weights.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# --------------------------------------------------------------------- flash
def flash_attention_reference(q, k, v, kv_lens=None, causal: bool = False,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash kernel's function in plain PyTorch: ``(out [B,H,S,D],
    lse [B,H,S])``.  Masked scores are replaced by ``finfo.min`` as in
    the kernel (key 0 is always kept, so no row is fully masked)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s_q, s_k = q.shape[-2], k.shape[-2]
    scores = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    keep = None
    if causal:
        row = torch.arange(s_q, device=q.device)[:, None]
        col = torch.arange(s_k, device=q.device)[None, :]
        keep = (row >= col)[None, None]
    if kv_lens is not None:
        col = torch.arange(s_k, device=q.device)
        pad = (col[None, :] < kv_lens.to(q.device)[:, None])[:, None, None, :]
        keep = pad if keep is None else keep & pad
    if keep is not None:
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    lse = torch.logsumexp(scores, dim=-1)
    weights = torch.exp(scores - lse[..., None])
    out = torch.matmul(weights, v.float()).to(q.dtype)
    return out, lse


def _flash_kernel(q, k, v, kv_lens, causal, scale):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors."""
    from ml_trainer_tpu_torch.ops.kernels._build import check, load

    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    if q.dtype != torch.float32 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernel takes float32 q/k/v, got {q.dtype}/{k.dtype}/"
            f"{v.dtype}"
        )
    if d not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {d}")
    if k.shape != (b, h, s_k, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {k.shape}/{v.shape} do not match q")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    lens_ptr = None
    if kv_lens is not None:
        kv_lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
        lens_ptr = kv_lens.data_ptr()
    lib = load("flash_fwd")
    count_launch("flash_fwd")
    check(lib.flash_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens_ptr,
        out.data_ptr(), lse.data_ptr(), b * h, h, s_q, s_k, d,
        int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    ), "flash_fwd_f32")
    return out, lse


def flash_attention(q, k, v, kv_lens=None, causal: bool = False,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward, [B, H, S, D] -> ``(out, lse)``.

    A CUDA tensor launches the kernel; a CPU tensor takes
    ``flash_attention_reference``.  ``block_q``/``block_k`` are the
    routing tile of the JAX package (``attention`` pads to them); the
    CUDA kernel picks its own tiles, which do not change the result.
    ``kv_lens`` entries must be >= 1.
    """
    del block_q, block_k
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return _flash_kernel(q, k, v, kv_lens, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_lens, causal, scale)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def _flash_supported(q, k, block_q, block_k) -> bool:
    s_q, d = q.shape[-2], q.shape[-1]
    s_k = k.shape[-2]
    return (
        s_q == s_k  # the kernel's causal mask is diagonal-aligned
        and s_q % block_q == 0
        and s_k % block_k == 0
        and d % 64 == 0
    )


# In 'auto' mode the padded kernel only engages from this length up, as
# in the JAX package (ops/attention.py, _AUTO_PAD_MIN_SEQ).
_AUTO_PAD_MIN_SEQ = 1024


def _flash_padded(q, k, v, kv_lens, causal, scale, block_q, block_k):
    """Run the kernel on shapes it cannot take directly, by zero-padding
    head_dim to a multiple of 64 and seq to a multiple of
    lcm(block_q, block_k), with the padded keys masked through
    ``kv_lens``.  Exact math; ``scale`` is taken from the ORIGINAL
    head_dim.  Requires s_q == s_k."""
    b, h, s, d = q.shape
    if scale is None:
        scale = d ** -0.5
    block = math.lcm(block_q, block_k)
    s_pad = -(-s // block) * block
    d_pad = -(-d // 64) * 64
    pad = (0, d_pad - d, 0, s_pad - s)
    qp, kp, vp = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    if kv_lens is None and s_pad == s:
        lens = None
    elif kv_lens is None:
        lens = torch.full((b,), s, dtype=torch.int32, device=q.device)
    else:
        lens = torch.clamp(kv_lens.to(torch.int32), max=s)
    out, _ = flash_attention(qp, kp, vp, lens, causal, scale, block_q,
                             block_k)
    return out[..., :s, :d]


def attention(q, k, v, *, causal: bool = False,
              mask: Optional[torch.Tensor] = None,
              kv_lens: Optional[torch.Tensor] = None,
              scale: Optional[float] = None,
              implementation: str = "auto", block_q: int = 128,
              block_k: int = 128) -> torch.Tensor:
    """Route between the flash kernel and the plain path.

    ``implementation``: 'auto' | 'xla' | 'flash' (the names of the JAX
    package; 'xla' is the plain path here).  Arbitrary masks take the
    plain path; the ``kv_lens`` right-pad family is fused into the
    kernel.  Lengths are clamped to >= 1 on both paths.
    """
    if implementation in ("ring", "ulysses"):
        raise NotImplementedError(
            f"implementation={implementation!r} (sequence parallelism) is "
            "not ported yet; see ROADMAP.md Queue A"
        )
    if implementation not in ("auto", "xla", "flash"):
        raise ValueError(
            f"unknown attention implementation {implementation!r}; "
            "expected 'auto', 'xla' or 'flash'"
        )
    if kv_lens is not None:
        kv_lens = torch.clamp(kv_lens, min=1)
    if implementation == "flash":
        if mask is not None and kv_lens is None:
            raise ValueError(
                "flash attention supports the causal mask and kv_lens "
                "right-padding only; pass implementation='xla' (or "
                "'auto') for arbitrary masks"
            )
        if q.shape[-2] != k.shape[-2]:
            raise ValueError(
                "flash attention requires equal query/key lengths "
                f"(got {q.shape[-2]} vs {k.shape[-2]}); use the plain path"
            )
        if (q.shape[-2] % block_q or k.shape[-2] % block_k
                or q.shape[-1] % 64):
            return _flash_padded(q, k, v, kv_lens, causal, scale, block_q,
                                 block_k)
        return flash_attention(q, k, v, kv_lens, causal, scale, block_q,
                               block_k)[0]
    if implementation == "auto" and (mask is None or kv_lens is not None):
        if _flash_supported(q, k, block_q, block_k):
            return flash_attention(q, k, v, kv_lens, causal, scale,
                                   block_q, block_k)[0]
        if q.shape[-2] == k.shape[-2] and q.shape[-2] >= _AUTO_PAD_MIN_SEQ:
            return _flash_padded(q, k, v, kv_lens, causal, scale, block_q,
                                 block_k)
    if mask is None and kv_lens is not None:
        mask = (torch.arange(k.shape[-2], device=k.device)[None, None, None, :]
                < kv_lens.to(k.device)[:, None, None, None])
    return dot_product_attention(q, k, v, causal=causal, mask=mask,
                                 scale=scale)

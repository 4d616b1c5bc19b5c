"""Attention ops: the plain PyTorch path and the flash-attention forward
kernel (``csrc/flash_fwd.cu``), with the JAX package's auto/xla/flash
routing.

* ``dot_product_attention`` is the plain path: one score matrix, an
  ADDED ``finfo.min`` mask bias, softmax, the value product.  Its causal
  mask is bottom-right aligned, so it also serves cross-length shapes.
* ``flash_attention`` is flash attention over [B, H, S, D] and returns
  ``(out, lse)``; ``out`` carries a gradient, ``lse`` does not.  Its
  causal mask is diagonal-aligned; masked scores are REPLACED by
  ``finfo.min`` (never ``-inf``), and an optional ``kv_lens`` [B] masks
  the right-padded key tail.  Forward and backward are one
  ``torch.autograd.Function`` (``_FlashAttention``, the JAX package's
  ``custom_vjp``): on CUDA tensors the forward launches
  ``csrc/flash_fwd.cu`` (K1) and the backward ``csrc/flash_bwd.cu``
  (K2 for dQ, K3 for dK/dV); on CPU tensors they run the plain twins
  ``flash_attention_reference`` and
  ``flash_attention_backward_reference``.  The backward recomputes P
  from the saved ``lse``, so training memory stays O(S).
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
def _compute_dtype(q) -> torch.dtype:
    # float32 at least; float64 stays float64 (the gradient check).
    return torch.promote_types(q.dtype, torch.float32)


def _keep_mask(s_q, s_k, kv_lens, causal, device):
    """The score-keep mask of all three kernels (the JAX package's
    ``_keep_mask``): the diagonal-aligned causal mask and/or the padded
    key tail, broadcastable to [B, H, S_q, S_k]; None keeps everything."""
    keep = None
    if causal:
        row = torch.arange(s_q, device=device)[:, None]
        col = torch.arange(s_k, device=device)[None, :]
        keep = (row >= col)[None, None]
    if kv_lens is not None:
        col = torch.arange(s_k, device=device)
        pad = (col[None, :] < kv_lens.to(device)[:, None])[:, None, None, :]
        keep = pad if keep is None else keep & pad
    return keep


def flash_attention_reference(q, k, v, kv_lens=None, causal: bool = False,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash kernel's function in plain PyTorch: ``(out [B,H,S,D],
    lse [B,H,S])``.  Masked scores are replaced by ``finfo.min`` as in
    the kernel (key 0 is always kept, so no row is fully masked)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    ct = _compute_dtype(q)
    scores = torch.matmul(q.to(ct) * scale, k.to(ct).transpose(-1, -2))
    keep = _keep_mask(q.shape[-2], k.shape[-2], kv_lens, causal, q.device)
    if keep is not None:
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    lse = torch.logsumexp(scores, dim=-1)
    weights = torch.exp(scores - lse[..., None])
    out = torch.matmul(weights, v.to(ct)).to(q.dtype)
    return out, lse


def _backward_plain(q, k, v, kv_lens, lse, delta, dout, causal, scale):
    """dq, dk, dv from ``delta`` = rowsum(dO * O) [B, H, S]: the function
    of both backward kernels in plain PyTorch."""
    ct = _compute_dtype(q)
    q, k, v, dout = (t.to(ct) for t in (q, k, v, dout))
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale
                  - lse.to(ct)[..., None])
    keep = _keep_mask(q.shape[-2], k.shape[-2], kv_lens, causal, q.device)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), dtype=ct, device=p.device))
    dv = torch.matmul(p.transpose(-1, -2), dout)
    dp = torch.matmul(dout, v.transpose(-1, -2))
    ds = p * (dp - delta.to(ct)[..., None]) * scale
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return dq, dk, dv


def _row_delta(out, dout) -> torch.Tensor:
    """delta = rowsum(dO * O), [B, H, S]: a plain PyTorch reduction, as
    the JAX package leaves it to XLA rather than adding a kernel pass."""
    ct = _compute_dtype(out)
    return (dout.to(ct) * out.to(ct)).sum(-1).contiguous()


def flash_attention_backward_reference(q, k, v, kv_lens, out, lse, dout,
                                       causal: bool, scale: float
                                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """The backward kernels' function in plain PyTorch: ``(dq, dk, dv)``
    from the forward's ``out`` and ``lse`` and the output cotangent,
    as the JAX package's ``_flash_backward``: P is recomputed from
    ``lse`` with the scale applied after QK^T, masked P is exactly 0,
    ``delta = rowsum(dO * O)`` and ``dS = P * (dP - delta) * scale``."""
    return _backward_plain(q, k, v, kv_lens, lse, _row_delta(out, dout),
                           dout, causal, scale)


def _check_kernel_inputs(q, k, v, what: str) -> None:
    b, h, _, d = q.shape
    if q.dtype != torch.float32 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{what} takes float32 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d not in (64, 128):
        raise ValueError(f"{what} takes head_dim 64 or 128, got {d}")
    if k.shape != (b, h, k.shape[2], d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {k.shape}/{v.shape} do not match q")


def _check_backward_inputs(q, k, v, lse, delta, dout) -> None:
    _check_kernel_inputs(q, k, v, "flash backward kernel")
    if dout.shape != q.shape or dout.dtype != torch.float32:
        raise ValueError(
            f"dout must be float32 {tuple(q.shape)}, got {dout.dtype} "
            f"{tuple(dout.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 {tuple(q.shape[:3])}, got "
                f"{t.dtype} {tuple(t.shape)}")


def _lens_arg(kv_lens, device):
    """``kv_lens`` as the kernels read it: int32 on the card, or None."""
    if kv_lens is None:
        return None
    return kv_lens.to(device=device, dtype=torch.int32).contiguous()


def _flash_kernel(q, k, v, kv_lens, causal, scale):
    """Launch ``csrc/flash_fwd.cu`` (K1) on contiguous CUDA tensors."""
    from ml_trainer_tpu_torch.ops.kernels._build import check, load

    _check_kernel_inputs(q, k, v, "flash kernel")
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    lens = _lens_arg(kv_lens, q.device)
    lib = load("flash_fwd")
    count_launch("flash_fwd")
    check(lib.flash_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b * h, h, s_q, s_k, d,
        int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    ), "flash_fwd_f32")
    return out, lse


def flash_bwd_dq(q, k, v, kv_lens, lse, delta, dout, causal, scale):
    """dQ of flash attention, [B, H, S, D]; ``delta`` [B, H, S] is
    ``rowsum(dO * O)``.  CUDA tensors launch ``csrc/flash_bwd.cu``'s dQ
    kernel (K2); CPU tensors take the plain twin."""
    if _device_kind(q) == "cpu":
        return _backward_plain(q, k, v, kv_lens, lse, delta, dout, causal,
                               scale)[0]
    from ml_trainer_tpu_torch.ops.kernels._build import check, load

    _check_backward_inputs(q, k, v, lse, delta, dout)
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    b, h, s_q, d = q.shape
    dq = torch.empty_like(q)
    lens = _lens_arg(kv_lens, q.device)
    lib = load("flash_bwd")
    count_launch("flash_bwd_dq")
    check(lib.flash_bwd_dq_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(), dout.data_ptr(),
        lse.contiguous().data_ptr(), delta.contiguous().data_ptr(),
        dq.data_ptr(), b * h, h, s_q, k.shape[2], d, int(causal),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    ), "flash_bwd_dq_f32")
    return dq


def flash_bwd_dkv(q, k, v, kv_lens, lse, delta, dout, causal, scale):
    """``(dk, dv)`` of flash attention.  CUDA tensors launch
    ``csrc/flash_bwd.cu``'s dK/dV kernel (K3); CPU tensors take the plain
    twin."""
    if _device_kind(q) == "cpu":
        return _backward_plain(q, k, v, kv_lens, lse, delta, dout, causal,
                               scale)[1:]
    from ml_trainer_tpu_torch.ops.kernels._build import check, load

    _check_backward_inputs(q, k, v, lse, delta, dout)
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    b, h, s_q, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lens = _lens_arg(kv_lens, q.device)
    lib = load("flash_bwd")
    count_launch("flash_bwd_dkv")
    check(lib.flash_bwd_dkv_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(), dout.data_ptr(),
        lse.contiguous().data_ptr(), delta.contiguous().data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b * h, h, s_q, k.shape[2], d,
        int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    ), "flash_bwd_dkv_f32")
    return dk, dv


def _device_kind(q) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(
            f"flash_attention runs on cuda or cpu, not {q.device}")
    return q.device.type


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: kernels K1 | K2 + K3 on CUDA
    tensors, the plain twins on CPU tensors.  Saves ``q, k, v, kv_lens,
    out, lse`` as the JAX package's ``_flash_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal, scale):
        if _device_kind(q) == "cuda":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = _flash_kernel(q, k, v, kv_lens, causal, scale)
        else:
            out, lse = flash_attention_reference(q, k, v, kv_lens, causal,
                                                 scale)
        ctx.save_for_backward(q, k, v, kv_lens, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, kv_lens, out, lse = ctx.saved_tensors
        args = (q, k, v, kv_lens, lse, _row_delta(out, dout), dout,
                ctx.causal, ctx.scale)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, \
            None


def flash_attention(q, k, v, kv_lens=None, causal: bool = False,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention, [B, H, S, D] -> ``(out, lse)``, differentiable in
    ``out`` (``lse`` carries no gradient).

    CUDA tensors launch the kernels (K1 forward, K2/K3 backward); CPU
    tensors take the plain twins.  ``block_q``/``block_k`` are the
    routing tile of the JAX package (``attention`` pads to them); the
    CUDA kernels pick their own tiles, which do not change the result.
    ``kv_lens`` entries must be >= 1.
    """
    del block_q, block_k
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, kv_lens, causal, float(scale))


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

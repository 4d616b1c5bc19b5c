"""Int8 weight-quantized matmul with per-output-channel scales.

Backs the opt-in quantized decode path (``Server(quant_int8=True)``):
the four projections of every block (qkv / proj / fc_in / fc_out) read
int8 weights and f32 per-column scales from a "quant" collection built
once by :func:`quantize_tree` from the fp32 weights, which stay as they
are.  The prefill stays fp32; only the engine's S == 1 decode step is
given the collection.  The embeddings and the tied LM head stay fp32.

This is not a bit-parity path against fp32: quantization changes the
math by construction.  What is pinned:

* ``quantize_per_channel`` is bitwise the JAX package's (symmetric per
  output channel: ``scale[n] = max(|w[:, n]|) / 127`` in f32, 1 for an
  all-zero column, ``w_q = clip(round_half_even(w / scale), -127, 127)``
  with a true f32 division);
* the kernel (``csrc/int8_matmul.cu``) and the plain version compute the
  same function: x and the int8 weights upcast to f32, the full-K f32
  sum, THEN the column scale (not a per-weight dequantize, which rounds
  differently), then the optional bias, each a separate f32 rounding;
  for a bfloat16 x (a bf16 model's decode step) the scaled sum is
  rounded to bf16 first and the bias, rounded to bf16, is added in bf16:
  the JAX package's ``_quant_dense`` (``int8_matmul(x, w, s)`` in x's
  dtype, then ``+ b.astype(y.dtype)``), two roundings;
* fp32 quality is gated end to end (argmax agreement and relative logit
  error against the fp32 model).

Layout: ``w_q`` is [K, N] (the JAX package's Dense kernel layout, the
transpose of ``nn.Linear.weight``), so a JAX-built collection crosses
unchanged; the kernel copies 16 adjacent output columns of a k row at a
time along the contiguous N axis.  It splits K over the blocks of a
thread block cluster (``k_slice``); the cluster's first block adds the
partial sums in slice order, then scales and adds the bias.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ml_trainer_tpu_torch.device import count_launch

# The four projections the quantized decode path covers (the same four
# the JAX package's LoRA adapters attach to).
QUANT_TARGETS = ("qkv", "proj", "fc_in", "fc_out")


def quantize_per_channel(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float weights -> (int8 [K, N], f32 scales [N]), per output
    column N."""
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    # torch.round is round-half-to-even, as jnp.round.
    w_q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w_q, scale


def int8_matmul_reference(x, w_q, scale, bias=None) -> torch.Tensor:
    """Plain version: ``(x_f32 @ f32(w_q)) * scale`` rounded to x.dtype,
    then ``+ bias`` rounded to x.dtype, added in x.dtype (float32: one f32
    sum after another).  x: [..., K]; w_q: [K, N] int8; scale, bias: [N]
    f32."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    y = ((x2 @ w_q.float()) * scale).to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y.reshape(*x.shape[:-1], w_q.shape[-1])


# The slice: rows of K per block of the CUDA kernel, a multiple of 64.  The
# slices of a column tile run as one thread block cluster, so there are at
# most 8; about 256 rows each, and no more slices than keep the grid within
# two blocks per SM (132 SMs), measured fastest at GPT-2's projections
# (PERF.md).  Static shapes only.
SLICE_ROWS, SLICE_STEP, MAX_SLICES, TILE_N, MAX_BLOCKS = 256, 64, 8, 32, 264


def k_slice(k: int, n: int) -> int:
    """Rows of K each block of the kernel sums, from the static shapes: K
    over min(8, ceil(K / 256), 264 // column tiles) slices (at least one),
    rounded up to a multiple of 64.  M does not change the grid: a block
    loops over passes of 8 rows of x."""
    tiles = -(-n // TILE_N)
    slices = max(1, min(MAX_SLICES, -(-k // SLICE_ROWS), MAX_BLOCKS // tiles))
    rows = -(-k // slices)
    return max(SLICE_STEP, -(-rows // SLICE_STEP) * SLICE_STEP)


# x's dtypes -> the C entry points' suffix (as ops/attention.py's).
_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def check_kernel_inputs(x, w_q, scale, bias) -> str:
    """Refuse what the kernel does not take, before any launch; returns
    the C entry point's dtype suffix."""
    n = w_q.shape[1]
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"int8 matmul kernel takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.shape != (n,) or t.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 [{n}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    return _KERNEL_DTYPES[x.dtype]


def _int8_kernel(x, w_q, scale, bias, slice_k=None):
    from ml_trainer_tpu_torch.ops.kernels._build import check, load

    k, n = w_q.shape
    x2 = x.reshape(-1, k)
    fn = f"int8_matmul_{check_kernel_inputs(x2, w_q, scale, bias)}"
    m = x2.shape[0]
    if slice_k is None:
        slice_k = k_slice(k, n)
    x2, w_q, scale = x2.contiguous(), w_q.contiguous(), scale.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((m, n), dtype=x2.dtype, device=x.device)
    lib = load("int8_matmul")
    count_launch("int8_matmul")
    check(getattr(lib, fn)(
        x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, k, n,
        int(slice_k), torch.cuda.current_stream(x.device).cuda_stream,
    ), fn)
    return out.reshape(*x.shape[:-1], n)


def int8_matmul(x, w_q, scale, *, bias: Optional[torch.Tensor] = None,
                implementation: str = "auto") -> torch.Tensor:
    """``x @ dequant(w_q, scale)`` computed as the f32 product of x and
    the int8 weights, scaled per output column and rounded to x.dtype,
    plus ``bias`` (rounded to x.dtype, added in it); returns x.dtype.
    x: [..., K], w_q: [K, N] int8, scale and bias: [N] f32.

    ``implementation``: "auto" launches the CUDA kernel for a CUDA tensor
    and takes the plain version for a CPU tensor; "reference" takes the
    plain version on either device."""
    if w_q.dtype != torch.int8:
        raise ValueError(f"w_q must be int8, got {w_q.dtype}")
    if w_q.ndim != 2 or x.shape[-1] != w_q.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not contract with w_q "
                         f"{tuple(w_q.shape)}")
    if implementation == "reference":
        return int8_matmul_reference(x, w_q, scale, bias)
    if implementation != "auto":
        raise ValueError(
            f"Unknown int8_matmul implementation {implementation!r}")
    if x.device.type == "cuda":
        return _int8_kernel(x, w_q, scale, bias)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scale, bias)
    raise ValueError(f"int8_matmul runs on cuda or cpu, not {x.device}")


@torch.no_grad()
def quantize_tree(model: nn.Module, targets=QUANT_TARGETS) -> dict:
    """Build the "quant" collection from a model's fp32 weights.

    Walks the module tree; every ``nn.Linear`` child named in ``targets``
    contributes ``<name>_w`` (int8 [K, N]), ``<name>_scale`` (f32 [N]) and
    ``<name>_b`` (the Linear's bias in f32 [N], zeros without one) at its
    PARENT's place in a nested dict keyed by child names, on the
    weights' device.  For GPT-2: ``{"blocks": {"0": {"attn": {qkv_*,
    proj_*}, "mlp": {fc_in_*, fc_out_*}}, ...}}``, the JAX package's
    ``block{i}/attn|mlp`` scopes.  Returns ``{}`` when nothing matched
    (the caller refuses rather than serve un-quantized)."""
    if not isinstance(model, nn.Module):
        raise TypeError(f"quantize_tree expects an nn.Module, got "
                        f"{type(model).__name__}")

    def walk(mod):
        out = {}
        for name, sub in mod.named_children():
            if name in targets and isinstance(sub, nn.Linear):
                w_q, scale = quantize_per_channel(sub.weight.T)
                out[f"{name}_w"] = w_q.contiguous()
                out[f"{name}_scale"] = scale
                out[f"{name}_b"] = (
                    torch.zeros_like(scale) if sub.bias is None
                    else sub.bias.detach().float().clone())
            else:
                inner = walk(sub)
                if inner:
                    out[name] = inner
        return out

    return walk(model)

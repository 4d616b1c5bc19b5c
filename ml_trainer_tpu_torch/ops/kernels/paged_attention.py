"""Paged-attention decode: the page-table gather fused into attention.

The serving engine's paged decode step attends each row's single query
against K/V scattered across a shared page pool.  The plain path
(``paged_attention_reference``) materializes ``pool[table]`` in logical
order and runs ``dot_product_attention`` under the validity mask; the
CUDA kernel (``csrc/paged_attention.cu``) streams the pages straight
from the pool instead, each row's positions split over blocks of
``split_positions`` positions whose partial softmax sums the row's last
block merges in split order (deterministic).  In bfloat16 the function
rounds the NORMALISED softmax weights to bf16 before the PV product (the
JAX kernel's ``weights.astype(v.dtype)``), which needs the row's final
max and sum first: the bf16 kernel runs a row's ``cluster_split``
splits as one thread block cluster that exchanges them (no workspace).

Layout contract (owned by serving/kv_pool.py and models/layers.py, the
same as the JAX package's): ``k_pool``/``v_pool`` are [N, H, page, D]
in q's dtype (float32, or bfloat16 for a bf16 model) with page 0 the
trash page; ``table`` is [B, P] int32; ``lengths`` is
[B] int32 with ``lengths[b] >= 1`` (the engine passes
``cache_index + 1``).  Positions at or past ``lengths[b]`` are masked.
"""

from __future__ import annotations

from typing import Optional

import torch

from ml_trainer_tpu_torch.device import count_launch
from ml_trainer_tpu_torch.ops.attention import (
    _KERNEL_DTYPES,
    dot_product_attention,
)


def paged_attention_reference(q, k_pool, v_pool, table, lengths, *,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Gather + masked dot-product attention.  q: [B, H, D]; pools:
    [N, H, page, D]; table: [B, P]; lengths: [B].  Returns [B, H, D]."""
    b, h, d = q.shape
    ps = k_pool.shape[2]
    L = table.shape[-1] * ps
    table = table.long()

    def gather(pool):  # [B, P, H, page, D] -> [B, H, L, D]
        return pool[table].permute(0, 2, 1, 3, 4).reshape(b, h, L, d)

    pos = torch.arange(L, device=q.device)
    valid = (pos[None, :] < lengths.to(q.device)[:, None])[:, None, None, :]
    out = dot_product_attention(q[:, :, None, :], gather(k_pool),
                                gather(v_pool), mask=valid, scale=scale)
    return out[:, :, 0, :]


# The split: positions per block of the CUDA kernel, at most 64 (whole
# pages at page 16), halved while a decode batch would put fewer than two
# blocks per SM (132) in flight when every row is full.  Static shapes
# only: reading ``lengths`` here would synchronise.
SPLIT_MAX, SPLIT_MIN, TARGET_BLOCKS = 64, 16, 2 * 132


def split_positions(batch: int, heads: int, pages: int, page_size: int) -> int:
    """Positions each block of the kernel owns, from the static shapes."""
    L = pages * page_size
    split = SPLIT_MAX
    while split > SPLIT_MIN and batch * heads * -(-L // split) < TARGET_BLOCKS:
        split //= 2
    return split


# The bf16 kernel's split: the splits of a row run as one thread block
# cluster, at most 8 (the portable cluster size) while 128 positions a
# split cover the row, else up to 16 (the non-portable size).
SPLIT_MAX_BF16, CLUSTER_PORTABLE, CLUSTER_MAX = 128, 8, 16


def cluster_split(pages: int, page_size: int) -> int:
    """Positions each block of the bf16 kernel owns: the least power of
    two from 16 to 128 that splits a row into at most 8 blocks (at most
    16 past 1024 positions)."""
    L = pages * page_size
    split = SPLIT_MIN
    while split < SPLIT_MAX_BF16 and -(-L // split) > CLUSTER_PORTABLE:
        split *= 2
    if -(-L // split) > CLUSTER_MAX:
        raise ValueError(
            f"the bf16 paged attention kernel takes at most "
            f"{CLUSTER_MAX * SPLIT_MAX_BF16} positions a row, got {L}")
    return split


def check_kernel_inputs(q, k_pool, v_pool, table, lengths) -> str:
    """Refuse what the kernel does not take, before any launch; returns
    the C entry point's dtype suffix."""
    b, h, d = q.shape
    _, h_pool, _, d_pool = k_pool.shape
    if (h_pool, d_pool) != (h, d):
        raise ValueError(f"pool shape {k_pool.shape} does not match q {q.shape}")
    if q.dtype not in _KERNEL_DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(
            f"paged attention kernel takes float32 or bfloat16 q and pools, "
            f"all alike; got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if d not in (32, 64, 128):
        raise ValueError(f"paged attention kernel takes head_dim 32, 64 or "
                         f"128, got {d}")
    if table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"table {tuple(table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {b}")
    return _KERNEL_DTYPES[q.dtype]


def _paged_kernel(q, k_pool, v_pool, table, lengths, scale, split=None):
    from ml_trainer_tpu_torch.ops.kernels import _split
    from ml_trainer_tpu_torch.ops.kernels._build import check, load

    kind = check_kernel_inputs(q, k_pool, v_pool, table, lengths)
    b, h, d = q.shape
    ps = k_pool.shape[2]
    pages = table.shape[1]
    if split is None:
        split = (cluster_split(pages, ps) if kind == "bf16"
                 else split_positions(b, h, pages, ps))
    q, k_pool, v_pool = q.contiguous(), k_pool.contiguous(), v_pool.contiguous()
    table = table.to(device=q.device, dtype=torch.int32).contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device)
    if kind == "bf16":  # a cluster per row: no workspace, no ticket
        lib = load("paged_attention")
        count_launch("paged_attention")
        check(lib.paged_attention_bf16(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h, pages,
            ps, d, int(split), float(scale), stream.cuda_stream,
        ), "paged_attention_bf16")
        return out
    n_splits = -(-pages * ps // split)
    work = tick = None
    if n_splits > 1:  # partials (acc [D], m, l) per (b, h, split)
        work = torch.empty(b * h * n_splits * (d + 2), dtype=torch.float32,
                           device=q.device)
        tick = _split.tickets(q.device, stream, b * h)
    lib = load("paged_attention")
    count_launch("paged_attention")
    check(lib.paged_attention_f32(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(),
        None if tick is None else tick.data_ptr(), b, h, pages, ps, d,
        int(split), float(scale), stream.cuda_stream,
    ), "paged_attention_f32")
    return out


def paged_attention(q, k_pool, v_pool, table, lengths, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused paged-attention decode step (see module docstring).  A CUDA
    tensor launches the kernel; a CPU tensor takes the plain gather."""
    if q.ndim != 3:
        raise ValueError(f"q must be [B, H, D], got {tuple(q.shape)}")
    if k_pool.shape != v_pool.shape:
        raise ValueError(f"k_pool/v_pool shapes differ: {tuple(k_pool.shape)}"
                         f" vs {tuple(v_pool.shape)}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return _paged_kernel(q, k_pool, v_pool, table, lengths, scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, table, lengths,
                                         scale=scale)
    raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")

"""Port parity: the paged-attention decode's plain version (what the
wrapper runs for a CPU tensor) against the JAX package's Pallas kernel in
interpret mode, at float32 atol/rtol 1e-5: trash pages, partial last
pages and length-1 rows.

The CUDA kernel splits each row's positions over blocks and merges the
blocks' partial softmax sums in split order.  ``_split_merge`` emulates
that arithmetic in float32 on the CPU (per split the local max m_s,
l_s = sum exp(s - m_s) and acc_s = sum exp(s - m_s) v; then m = max m_s,
out = sum acc_s e^(m_s - m) / sum l_s e^(m_s - m)) and is held against
the plain version and the JAX kernel at split sizes of 1, 4 and P pages,
lengths at the split boundaries and a trash row."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_trainer_tpu.ops.kernels import paged_attention as j_paged
from ml_trainer_tpu_torch.ops.kernels import (
    paged_attention,
    paged_attention_reference,
)
from ml_trainer_tpu_torch.ops.kernels.paged_attention import split_positions

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, b, h, d, ps, P, lengths, trash_rows=()):
    rng = np.random.default_rng(seed)
    n_pages = b * P + 1
    q = (rng.normal(size=(b, h, d)) * 0.5).astype(np.float32)
    kp, vp = ((rng.normal(size=(n_pages, h, ps, d)) * 0.5).astype(np.float32)
              for _ in range(2))
    table = (1 + rng.permutation(n_pages - 1).reshape(b, P)).astype(np.int32)
    for r in trash_rows:
        table[r, 1:] = 0
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _both(q, kp, vp, table, lens):
    want = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(table), jnp.asarray(lens),
                   implementation="pallas", interpret=True)
    got = paged_attention(*(torch.from_numpy(x)
                            for x in (q, kp, vp, table, lens)))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("b,h,d,ps,P", [(3, 2, 8, 8, 2), (3, 4, 32, 16, 4)])
def test_paged_matches_jax_interpret(b, h, d, ps, P):
    """Full row, length 1 (only token 0 of the first page), partial last
    page."""
    lengths = [ps * P, 1, ps + 1]
    got, want = _both(*_case(0, b, h, d, ps, P, lengths))
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_trash_row_and_exact_pool():
    """Every non-trash page referenced once, and a row whose table is
    trash past its first page: the mask, not the table, decides."""
    case = _case(1, 4, 2, 16, 8, 3, [24, 24, 7, 1], trash_rows=(3,))
    got, want = _both(*case)
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_wrapper_takes_plain_on_cpu_and_checks_shapes():
    q, kp, vp, table, lens = (torch.from_numpy(x) for x in
                              _case(2, 2, 2, 8, 4, 2, [8, 3]))
    got = paged_attention(q, kp, vp, table, lens)
    want = paged_attention_reference(q, kp, vp, table, lens)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match=r"\[B, H, D\]"):
        paged_attention(q[None], kp, vp, table, lens)
    with pytest.raises(ValueError, match="shapes differ"):
        paged_attention(q, kp, vp[:, :1], table, lens)


def _split_merge(q, kp, vp, table, lengths, split):
    """The CUDA kernel's split arithmetic in float32 (test-only): each live
    split of ``split`` positions reduced to (m_s, l_s, acc_s), then the
    merge in split order.  Dead splits (first position >= len) are never
    read."""
    b, h, d = q.shape
    ps, L = kp.shape[2], table.shape[1] * kp.shape[2]
    scale = np.float32(d ** -0.5)
    out = torch.empty_like(q)
    for r in range(b):
        n = min(max(int(lengths[r]), 1), L)
        pos = torch.arange(n)
        page = table[r, pos // ps].long()
        k, v = kp[page, :, pos % ps], vp[page, :, pos % ps]  # [n, H, D]
        parts = []
        for p0 in range(0, n, split):
            kk, vv = k[p0:p0 + split], v[p0:p0 + split]
            sc = torch.einsum("hd,nhd->hn", q[r], kk) * scale
            m = sc.max(-1).values
            p = torch.exp(sc - m[:, None])
            parts.append((m, p.sum(-1), torch.einsum("hn,nhd->hd", p, vv)))
        mm = torch.stack([m for m, _, _ in parts]).max(0).values
        num, den = torch.zeros(h, d), torch.zeros(h)
        for m, l, acc in parts:  # split order
            w = torch.exp(m - mm)
            num = num + acc * w[:, None]
            den = den + l * w
        out[r] = num / den[:, None]
    return out


SPLIT_PS, SPLIT_P = 16, 8  # page 16, 8 pages: L = 128
# Length 1, the 4-page split boundary (63, 64, 65), a full row, and a row
# whose table is trash past its first page.
SPLIT_LENGTHS = [1, 63, 64, 65, SPLIT_PS * SPLIT_P, 40]


@functools.lru_cache(maxsize=None)
def _split_case(d):
    case = _case(10 + d, len(SPLIT_LENGTHS), 2, d, SPLIT_PS, SPLIT_P,
                 SPLIT_LENGTHS, trash_rows=(5,))
    _, want_jax = _both(*case)
    return case, want_jax


@pytest.mark.parametrize("split_pages", [1, 4, SPLIT_P])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_split_merge_matches_plain_and_jax(d, split_pages):
    (q, kp, vp, table, lens), want_jax = _split_case(d)
    t = [torch.from_numpy(x) for x in (q, kp, vp, table, lens)]
    got = _split_merge(*t, split=split_pages * SPLIT_PS).numpy()
    np.testing.assert_allclose(got, paged_attention_reference(*t).numpy(),
                               **TOL)
    np.testing.assert_allclose(got, want_jax, **TOL)


@pytest.mark.parametrize("b,h,pages,ps", [(8, 12, 64, 16), (1, 12, 64, 16),
                                          (4, 3, 8, 16), (8, 12, 128, 8)])
def test_split_positions_fill_the_card(b, h, pages, ps):
    """The split is 16-64 positions (whole pages at page 8 or 16), halved
    only while a batch of full rows would put fewer than 2 x 132 blocks
    in flight."""
    split = split_positions(b, h, pages, ps)
    assert split in (16, 32, 64) and split % ps == 0
    blocks = b * h * -(-pages * ps // split)
    assert blocks >= 2 * 132 or split == 16
    if split < 64:
        assert b * h * -(-pages * ps // (2 * split)) < 2 * 132

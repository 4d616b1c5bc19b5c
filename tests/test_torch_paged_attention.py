"""Port parity: the paged-attention decode's plain version (what the
wrapper runs for a CPU tensor) against the JAX package's Pallas kernel in
interpret mode, at float32 atol/rtol 1e-5: trash pages, partial last
pages and length-1 rows; in bfloat16 bitwise (q and pools in bf16, the
normalised weights rounded to bf16 before PV, the output in bf16).

The CUDA kernel splits each row's positions over blocks and merges the
blocks' partial softmax sums in split order.  ``_split_merge`` emulates
that arithmetic in float32 on the CPU (per split the local max m_s,
l_s = sum exp(s - m_s) and acc_s = sum exp(s - m_s) v; then m = max m_s,
out = sum acc_s e^(m_s - m) / sum l_s e^(m_s - m)) and is held against
the plain version and the JAX kernel at split sizes of 1, 4 and P pages,
lengths at the split boundaries and a trash row.

The bf16 kernel runs a row's splits as one thread block cluster that
exchanges each split's (m_s, l_s) before any PV product, so that every
block rounds the NORMALISED weights with the row's final max and sum.
``_cluster_bf16`` emulates that arithmetic on the CPU and is held within
2 bf16 ulps of the plain version; a planted row (two positions, values
of opposite sign large against the output) shows that rounding the
normalised weights, rounding unnormalised partials and not rounding give
results more than that bar apart, so the bar tells the designs apart."""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_trainer_tpu.ops.kernels import paged_attention as j_paged
from ml_trainer_tpu_torch.ops.kernels import (
    paged_attention,
    paged_attention_reference,
)
from ml_trainer_tpu_torch.ops.kernels import _build
from ml_trainer_tpu_torch.ops.kernels.paged_attention import (
    check_kernel_inputs,
    cluster_split,
    split_positions,
)

# The module (the package's ``paged_attention`` is the function).
pa = importlib.import_module("ml_trainer_tpu_torch.ops.kernels.paged_attention")

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


# ------------------------------------------------------------------ bf16
def _bf16_case(seed, b, h, d, ps, P, lengths, trash_rows=()):
    """``_case`` rounded to bf16: (numpy f32 copies of the bf16 values,
    for JAX) and (bf16 torch tensors)."""
    q, kp, vp, table, lens = _case(seed, b, h, d, ps, P, lengths, trash_rows)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, kp, vp))
    return tq, tk, tv, torch.from_numpy(table), torch.from_numpy(lens)


def _jax_bf16(tq, tk, tv, table, lens, implementation="pallas"):
    kw = dict(interpret=True) if implementation == "pallas" else {}
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (tq, tk, tv))
    out = j_paged(jq, jk, jv, jnp.asarray(table.numpy()),
                  jnp.asarray(lens.numpy()), implementation=implementation,
                  **kw)
    assert out.dtype == jnp.bfloat16
    return np.array(out.astype(jnp.float32))


def bf16_gate(got, want) -> float:
    """max |got - want| / (2^-7 |want| + 1e-3 max|want|): at most 1 within
    2 bf16 ulps of ``want`` (the chip gate of the bf16 kernel rows)."""
    got, want = got.float(), want.float()
    bar = 2 ** -7 * want.abs() + 1e-3 * want.abs().max()
    return ((got - want).abs() / bar).max().item()


@pytest.mark.parametrize("b,h,d,ps,P", [(2, 2, 8, 8, 2), (3, 4, 32, 16, 4)])
def test_paged_bf16_is_bitwise_the_jax_kernel(b, h, d, ps, P):
    """The JAX package's bf16 pin's shapes (tests/test_kernels.py): a
    full row, a length-1 row, a partial last page, and an extra row whose
    table is all trash (an inactive slot) at length 1."""
    lengths = ([ps * P, 1, ps + 1][:b]) + [1]
    case = _bf16_case(20 + d, b + 1, h, d, ps, P, lengths)
    case[3][b] = 0
    got = paged_attention(*case)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _jax_bf16(*case))


def test_paged_bf16_at_the_serving_shape():
    """The serving decode batch (B=8, H=12, D=64, page 16, 64 pages):
    ragged lengths and an all-trash row, against the JAX reference.  Over
    rows of up to 1024 positions the two packages' f32 dot products sum
    in other orders, and a few outputs (2 of 6144 here) land one bf16 ulp
    apart: within one ulp, all but 0.1% bitwise."""
    case = _bf16_case(30, 8, 12, 64, 16, 64, [1, 16, 17, 1024, 300, 777, 64, 1])
    case[3][7] = 0
    got = paged_attention(*case)
    want = torch.from_numpy(_jax_bf16(*case, implementation="reference"))
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert ((got.float() - want).abs() <= ulp).all()
    assert (got.float() != want).float().mean().item() < 1e-3


def _cluster_bf16(q, kp, vp, table, lengths, split):
    """The bf16 kernel's cluster arithmetic in float32 (test-only): per
    split of ``split`` positions the local max m_s and l_s = sum exp(s -
    m_s) (a dead split: (-inf, 0)); then, in split order, m = max m_s and
    l = sum l_s e^(m_s - m); each split's weights bf16(exp(s - m) / l)
    times V summed in f32; the partials added in split order; one
    rounding to bf16."""
    b, h, d = q.shape
    ps, L = kp.shape[2], table.shape[1] * kp.shape[2]
    scale = d ** -0.5
    out = torch.empty(b, h, d, dtype=torch.bfloat16)
    for r in range(b):
        n = min(max(int(lengths[r]), 1), L)
        pos = torch.arange(n)
        page = table[r, pos // ps].long()
        k = kp[page, :, pos % ps].float()  # [n, H, D]
        v = vp[page, :, pos % ps].float()
        sc = torch.einsum("hd,nhd->hn", q[r].float(), k) * scale
        spans = [(p0, min(p0 + split, n)) for p0 in range(0, L, split)]
        ml = []
        for p0, p1 in spans:
            if p0 >= n:
                ml.append((torch.full((h,), -torch.inf), torch.zeros(h)))
                continue
            m_s = sc[:, p0:p1].max(-1).values
            ml.append((m_s, torch.exp(sc[:, p0:p1] - m_s[:, None]).sum(-1)))
        m = torch.stack([m_s for m_s, _ in ml]).max(0).values
        l = torch.zeros(h)
        for m_s, l_s in ml:
            l = l + l_s * torch.exp(m_s - m)
        tot = torch.zeros(h, d)
        for p0, p1 in spans:
            if p0 < n:
                w = (torch.exp(sc[:, p0:p1] - m[:, None]) / l[:, None])
                w = w.to(torch.bfloat16).float()
                tot = tot + torch.einsum("hn,nhd->hd", w, v[p0:p1])
        out[r] = tot.to(torch.bfloat16)
    return out


@pytest.mark.parametrize("split", [16, 64, 128, None])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_cluster_bf16_within_two_ulps_of_plain_and_jax(d, split):
    """Lengths at the split boundaries (1, 63-65, 127-129, 1024) and a
    row whose table is trash past its first page, over 1024 positions
    (8 splits of 128 at the wrapper's choice)."""
    lengths = [1, 63, 64, 65, 128, 129, 1024, 40]
    case = _bf16_case(40 + d, 8, 2, d, 16, 64, lengths, trash_rows=(7,))
    split = split or cluster_split(64, 16)
    got = _cluster_bf16(*case, split=split)
    assert bf16_gate(got, paged_attention_reference(*case)) <= 1.0
    assert bf16_gate(got, torch.from_numpy(
        _jax_bf16(*case, implementation="reference"))) <= 1.0


# The planted row: scores (0.828125, 0) from q = 6.625 e_0 against k rows
# e_0 and 0 (scale 1/8 at D = 64), values +16 and -36.25 on every
# channel: the output (0.080) is small against the values, and the
# weights' f32 values lie over 0.16 of a bf16 ulp from a rounding
# midpoint, so a float32-level difference in exp or the sum cannot flip
# their rounding.
PLANTED = dict(q=6.625, v=(16.0, -36.25), d=64)


def planted_case(h=12):
    """B = 1 row of two live positions (one page of 16, lengths [2])."""
    d = PLANTED["d"]
    q = torch.zeros(1, h, d)
    q[..., 0] = PLANTED["q"]
    kp = torch.zeros(2, h, 16, d)
    vp = torch.zeros(2, h, 16, d)
    kp[1, :, 0, 0] = 1.0
    vp[1, :, 0], vp[1, :, 1] = PLANTED["v"]
    bf = torch.bfloat16
    return (q.to(bf), kp.to(bf), vp.to(bf), torch.tensor([[1]], dtype=torch.int32),
            torch.tensor([2], dtype=torch.int32))


def planted_designs(q, kp, vp, table, lengths):
    """The planted row through the two other designs: (rounding the
    unnormalised exp(s - m) before PV and dividing by l after, not
    rounding the weights at all), each rounded once to bf16 at the end."""
    n = int(lengths[0])
    page = table[0, torch.arange(n) // kp.shape[2]].long()
    k = kp[page, :, torch.arange(n) % kp.shape[2]].float()
    v = vp[page, :, torch.arange(n) % kp.shape[2]].float()
    sc = torch.einsum("bhd,nhd->bhn", q.float(), k) * q.shape[-1] ** -0.5
    p = torch.exp(sc - sc.max(-1, keepdim=True).values)
    l = p.sum(-1, keepdim=True)
    unnorm = torch.einsum("bhn,nhd->bhd", p.to(torch.bfloat16).float(), v) / l
    exact = torch.einsum("bhn,nhd->bhd", p, v) / l
    return unnorm.to(torch.bfloat16), exact.to(torch.bfloat16)


def test_planted_row_tells_the_rounding_designs_apart():
    """Plain (= JAX, bitwise) and the cluster emulation within 2 bf16 ulps
    of each other; rounding unnormalised partials, or not rounding, more
    than 5 bars away from it and from each other."""
    case = planted_case()
    plain = paged_attention_reference(*case)
    np.testing.assert_array_equal(plain.float().numpy(), _jax_bf16(*case))
    assert bf16_gate(_cluster_bf16(*case, split=16), plain) <= 1.0
    unnorm, exact = planted_designs(*case)
    assert bf16_gate(unnorm, plain) > 5 and bf16_gate(exact, plain) > 5
    assert bf16_gate(unnorm, exact) > 5
    assert abs(plain.float().max().item() - 0.080078125) < 1e-9


@pytest.mark.parametrize("pages,ps,want", [(4, 16, 16), (16, 16, 32),
                                           (64, 16, 128), (128, 8, 128),
                                           (128, 16, 128), (1, 8, 16)])
def test_cluster_split_rule(pages, ps, want):
    """The least split of 16-128 positions giving at most 8 splits a row
    (the portable cluster), 9-16 splits of 128 past 1024 positions."""
    split = cluster_split(pages, ps)
    assert split == want
    assert -(-pages * ps // split) <= (8 if pages * ps <= 1024 else 16)


def test_cluster_split_refuses_rows_past_the_cluster():
    with pytest.raises(ValueError, match="at most 2048 positions"):
        cluster_split(129, 16)


def test_kernel_dtype_checks_raise_before_any_launch():
    """The checks the CUDA wrapper runs before it loads or launches
    anything: float32 or bf16 q and pools, all alike."""
    q, kp, vp, table, lens = _bf16_case(3, 2, 2, 32, 8, 2, [8, 3])
    assert check_kernel_inputs(q, kp, vp, table, lens) == "bf16"
    assert check_kernel_inputs(q.float(), kp.float(), vp.float(), table,
                               lens) == "f32"
    half = torch.float16
    for args in ((q.to(half), kp.to(half), vp.to(half)), (q.float(), kp, vp),
                 (q, kp.float(), vp), (q, kp, vp.float())):
        with pytest.raises(TypeError, match="all alike"):
            check_kernel_inputs(*args, table, lens)


class _FakeLib:
    """A built library that records its calls and returns ``status``."""

    def __init__(self, status=0):
        self.status, self.calls = status, []

    def __getattr__(self, fn):
        def call(*args):
            self.calls.append((fn, args))
            return self.status
        return call


@pytest.fixture
def fake_lib(monkeypatch):
    class _Stream:
        cuda_stream = 0

    loads = []
    lib = _FakeLib()

    def load(name):
        loads.append(name)
        return lib

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream)
    lib.loads = loads
    return lib


def test_bf16_wrapper_launches_the_bf16_entry_and_never_falls_back(fake_lib):
    """The CUDA path (``_paged_kernel``) on bf16 inputs calls
    ``paged_attention_bf16`` with the cluster split and no workspace; a
    refused launch raises (no plain fallback); fp16 raises before any
    load."""
    q, kp, vp, table, lens = _bf16_case(4, 3, 2, 64, 16, 64, [5, 1024, 1])
    out = pa._paged_kernel(q, kp, vp, table, lens, 0.125)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    (fn, args), = fake_lib.calls
    assert fn == "paged_attention_bf16" and len(args) == 14
    assert args[6:12] == (3, 2, 64, 16, 64, 128)
    fake_lib.status = 700
    with pytest.raises(RuntimeError, match="paged_attention_bf16"):
        pa._paged_kernel(q, kp, vp, table, lens, 0.125)
    fake_lib.loads.clear()
    with pytest.raises(TypeError):
        pa._paged_kernel(q.half(), kp.half(), vp.half(), table, lens, 0.125)
    assert fake_lib.loads == []

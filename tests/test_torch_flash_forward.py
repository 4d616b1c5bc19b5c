"""The flash-attention forward kernels' arithmetic (K1,
``ml_trainer_tpu_torch/csrc/flash_fwd.cu``) emulated on the CPU, and the
build cache key of the port's CUDA kernels.

float32 K1 runs the JAX kernel's online-softmax recurrence over 32-key
tiles, with q.k^T and p.v as TF32 tensor-core products in the 3-product
split (big*small + small*big + big*big; operands rounded as
cvt.rna.tf32.f32 rounds, float32 sums).  ``_forward_tiles`` runs that
recurrence in float32 with one, three or exact products; it is held
against the plain ``flash_attention_reference`` and the JAX
``_flash_forward`` in interpret mode, both float32.  The chip gate of K1
is 1e-4 absolute on out and lse (``chip_smoke.py``'s ``TOL``).

bf16 K1 (``flash_fwd_bf16_kernel``) runs the recurrence over tiles of
64 keys (32 at d 128) with one bf16 product for q.k^T, the scale applied
after it in log2 units, P split in hi + lo bf16 terms for P.v, and O
rounded once to bf16: ``_forward_bf16`` emulates it, held to the bf16
chip gate (2 bf16 ulps) against the float64 function of the same inputs.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_trainer_tpu_torch.ops.kernels import _build
from test_torch_flash_backward import (_arrays, _bf16_gate, _mm_bf16,
                                       _mm_tf32, _tf32)
from test_torch_package import bf16_steps

jatt = importlib.import_module("ml_trainer_tpu.ops.attention")
tatt = importlib.import_module("ml_trainer_tpu_torch.ops.attention")

GATE = 1e-4  # K1 vs its plain version on the card, abs on out and lse
TILE = 32    # keys per K1 tile
FMIN = torch.finfo(torch.float32).min


def _forward_tiles(q, k, v, kv_lens, causal, scale, products):
    """K1's recurrence over 32-key tiles: m from finfo.min, masked scores
    replaced by finfo.min, ``products`` 3 or 1 TF32 products per product,
    or None for exact float32 products.  Tiles wholly past a row's keys
    add p = 0 with alpha = 1 (exactly), so running them for every row
    equals K1's skipping them."""
    b, h, s_q, _ = q.shape
    s_k = k.shape[2]
    if products is None:
        mm = torch.matmul
    else:
        def mm(x, y):
            return _mm_tf32(x, y, products)
    live = (torch.full((b,), s_k) if kv_lens is None
            else kv_lens.clamp(1, s_k))[:, None, None, None]
    qs = q * scale
    m = torch.full((b, h, s_q, 1), FMIN)
    l = torch.zeros((b, h, s_q, 1))
    o = torch.zeros_like(q)
    row = torch.arange(s_q)[:, None]
    for kv0 in range(0, int(live.max()), TILE):
        kt, vt = k[:, :, kv0:kv0 + TILE], v[:, :, kv0:kv0 + TILE]
        col = kv0 + torch.arange(kt.shape[2])[None, :]
        keep = col < live
        if causal:
            keep = keep & (row >= col)
        s = torch.where(keep, mm(qs, kt.transpose(-1, -2)), FMIN)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm(p, vt)
        m = m_new
    return o / l, (m + torch.log(l))[..., 0]


def _err(got, want):
    return max((a - b).abs().max().item() for a, b in zip(got, want))


@pytest.mark.parametrize("causal,lens", [(True, None), (True, [173]),
                                         (False, [173])])
@pytest.mark.parametrize("d", [64, 128])
def test_three_tf32_products_keep_the_forward_gate(d, causal, lens):
    """At [1, 2, 256, d]: the recurrence with exact products is the plain
    forward's and the JAX kernel's function (1e-5); with three TF32
    products it stays under 1/10 of the chip gate against both; one TF32
    product is at least 10x further off, which is why K1 splits."""
    q, k, v = (torch.tensor(x) for x in _arrays(7, 1, 2, 256, d, n=3))
    t_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    scale = d ** -0.5
    plain = tatt.flash_attention_reference(q, k, v, t_lens, causal, scale)
    j_out, j_lse = jatt._flash_forward(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()),
        None if lens is None else jnp.asarray(lens, jnp.int32),
        causal=causal, scale=scale, block_q=128, block_k=128,
        interpret=True)
    jax_ref = (torch.tensor(np.asarray(j_out)),
               torch.tensor(np.asarray(j_lse)))
    exact = _forward_tiles(q, k, v, t_lens, causal, scale, None)
    assert _err(exact, plain) <= 1e-5
    assert _err(exact, jax_ref) <= 1e-5
    three = _forward_tiles(q, k, v, t_lens, causal, scale, 3)
    one = _forward_tiles(q, k, v, t_lens, causal, scale, 1)
    errs = {3: _err(three, plain), 1: _err(one, plain)}
    assert errs[3] <= GATE / 10, errs
    assert _err(three, jax_ref) <= GATE / 10
    assert errs[1] >= 10 * errs[3], errs


@pytest.mark.parametrize("causal,lens", [(True, None), (True, [173]),
                                         (False, [173])])
@pytest.mark.parametrize("d", [64, 128])
def test_three_tf32_products_keep_the_forward_gate_in_bf16(d, causal, lens):
    """The float32 K1 on widened bf16 inputs, emulated at [1, 2, 256, d]
    (``chip_smoke.py`` holds bf16 K1 within one bf16 step of it): the
    widened bf16 K and V (and q * scale at d = 64, a power-of-two scale)
    are their own TF32 big parts; the 3xTF32 recurrence on the widened
    values, its out rounded once to bf16, is within the bf16 chip gate
    (2 bf16 ulps) of the plain bf16 forward, and its lse within the
    float32 gate."""
    q, k, v = (torch.tensor(x).to(torch.bfloat16)
               for x in _arrays(8, 1, 2, 256, d, n=3))
    t_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    scale = d ** -0.5
    for t in (k, v) + ((q.float() * scale,) if d == 64 else ()):
        w = t.float()
        assert torch.equal(_tf32(w - _tf32(w)), torch.zeros_like(w))
    out, lse = tatt.flash_attention_reference(q, k, v, t_lens, causal, scale)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got_out, got_lse = _forward_tiles(q.float(), k.float(), v.float(),
                                      t_lens, causal, scale, 3)
    assert _bf16_gate(got_out.to(torch.bfloat16), out) <= 0
    assert (got_lse - lse).abs().max().item() <= GATE


LOG2E = 1.4426950408889634


def _forward_bf16(q, k, v, kv_lens, causal, scale, terms):
    """bf16 K1's arithmetic on bf16 q, k, v: tiles of 64 keys (32 at d
    128), s = q.k^T as one bf16 product (exact products, float32 sums),
    scaled after it into log2 units, the running max from -inf and
    masked scores at -inf (P = 0: every row keeps key 0 in its first
    tile), P = 2^(s - m) and alpha = 2^(m_old - m) in float32, l summed
    from the unsplit P, P.v with P split in ``terms`` bf16 terms, O =
    acc / l rounded once to bf16, lse = (m + log2 l) ln 2 in float32.
    Tiles wholly past a row's keys add P = 0 with alpha = 1 (exactly),
    so running them for every row equals the kernel's skipping them."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    bn = 64 if d == 64 else 32
    live = (torch.full((b,), s_k) if kv_lens is None
            else kv_lens.clamp(1, s_k))[:, None, None, None]
    scale2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full((b, h, s_q, 1), -math.inf)
    l = torch.zeros((b, h, s_q, 1))
    o = torch.zeros((b, h, s_q, d))
    row = torch.arange(s_q)[:, None]
    for kv0 in range(0, s_k, bn):
        kt, vt = k[:, :, kv0:kv0 + bn], v[:, :, kv0:kv0 + bn]
        col = kv0 + torch.arange(kt.shape[2])[None, :]
        keep = col < live
        if causal:
            keep = keep & (row >= col)
        s = q.float() @ kt.float().transpose(-1, -2) * scale2
        s = torch.where(keep, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _mm_bf16(p, vt, terms)
        m = m_new
    lse = (m + torch.log2(l)) * math.log(2)
    return (o / l).to(torch.bfloat16), lse[..., 0]


def _bf16_case(seed, shape, lens):
    """bf16 q, k, v from numpy and kv_lens (or None)."""
    q, k, v = (torch.tensor(x).to(torch.bfloat16)
               for x in _arrays(seed, *shape, n=3))
    return q, k, v, (None if lens is None
                     else torch.tensor(lens, dtype=torch.int32))


def _ratio64(got, want):
    """The 2-ulp gate as a ratio against float64 values: at most 1 within
    2^-7 |want| + 1e-3 max|want|."""
    got = got.double()
    return float(((got - want).abs()
                  / (2 ** -7 * want.abs() + 1e-3 * want.abs().max())).max())


def _bf16_steps(a, b):
    """The most bf16 steps between two bf16 tensors over the elements
    that differ by more than 1e-3 x max|b|, as
    ``chip_smoke.f32_kernel_ulps`` counts them: near 0, float32 sums in
    another order move a value by several steps of its own size."""
    far = (a.float() - b.float()).abs() > 1e-3 * b.float().abs().max()
    steps = bf16_steps(a, b)[far]
    return int(steps.max()) if steps.numel() else 0


BF16_ROWS = {  # name: (shape at d = 64, causal, kv_lens)
    "causal": ((2, 2, 256, 64), True, None),
    "causal_kv_lens": ((2, 2, 256, 64), True, [173, 1]),
    "kv_lens": ((2, 2, 256, 64), False, [173, 1]),
    "ragged": ((2, 2, 200, 64), True, None),
}


@pytest.mark.parametrize("row", sorted(BF16_ROWS))
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_forward_keeps_half_the_chip_gate(d, row):
    """bf16 K1's arithmetic (``_forward_bf16``, P in two bf16 terms):
    out within half the 2-ulp gate of the float64 function of the same
    inputs and within the gate of the plain bf16 forward (the chip's
    check), lse within 1e-4 of float64.  With P in three terms (P.v as
    good as float32) the recurrence gives the plain forward's out to
    one bf16 step and its lse to 1e-5: the emulation computes the
    kernel's function, and the gate reads only its rounding.  Two
    terms too sit within one bf16 step of the plain forward (the bar
    that ``chip_smoke.py`` holds bf16 K1 to against the float32
    kernel)."""
    shape, causal, lens = BF16_ROWS[row]
    q, k, v, t_lens = _bf16_case(13, shape[:3] + (d,), lens)
    scale = d ** -0.5
    exact = tatt.flash_attention_reference(q.double(), k.double(),
                                           v.double(), t_lens, causal, scale)
    plain = tatt.flash_attention_reference(q, k, v, t_lens, causal, scale)
    out, lse = _forward_bf16(q, k, v, t_lens, causal, scale, 2)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _ratio64(out, exact[0]) < 0.5
    assert _bf16_gate(out, plain[0]) <= 0
    assert (lse.double() - exact[1]).abs().max().item() <= GATE
    three, three_lse = _forward_bf16(q, k, v, t_lens, causal, scale, 3)
    assert _bf16_steps(three, plain[0]) <= 1
    assert _bf16_steps(out, plain[0]) <= 1
    assert (three_lse - plain[1]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape,causal,lens", [
    ((2, 12, 512, 64), True, None),
    ((4, 12, 128, 64), False, [128, 50, 1, 97]),
])
def test_one_bf16_term_for_p_reads_more_of_the_forward_gate(shape, causal,
                                                            lens):
    """Why bf16 K1 splits P in two bf16 terms although one would pass
    here: with one (P rounded to bf16 before P.v, as SDPA does) out reads
    0.50-0.62 of the 2-ulp gate against float64 at these rows, with two
    under 0.4, the output rounding alone (the plain bf16 forward's own
    reading).  On a bf16 GPT-2 step the per-call check reads 0.87 of
    the gate for K1 with f32 P: one term would leave no margin."""
    q, k, v, t_lens = _bf16_case(0, shape, lens)
    scale = shape[-1] ** -0.5
    exact = tatt.flash_attention_reference(q.double(), k.double(),
                                           v.double(), t_lens, causal,
                                           scale)[0]
    plain = _ratio64(tatt.flash_attention_reference(q, k, v, t_lens, causal,
                                                    scale)[0], exact)
    one, two = (_ratio64(_forward_bf16(q, k, v, t_lens, causal, scale,
                                       terms)[0], exact) for terms in (1, 2))
    assert two < 0.4 and abs(two - plain) < 0.05, (two, plain)
    assert 0.45 < one < 1.0, one


def _fake_csrc(tmp_path, monkeypatch):
    """A csrc-like tree: kern.cu includes a.cuh, which includes
    sub/b.cuh, which includes a.cuh again (a cycle); other.cuh is
    included by nothing."""
    csrc = tmp_path / "csrc"
    (csrc / "sub").mkdir(parents=True)
    (csrc / "kern.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\nint f() { return B; }\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "sub/b.cuh"\n')
    (csrc / "sub" / "b.cuh").write_text(
        '#pragma once\n  #  include "../a.cuh"\n#define B 1\n')
    (csrc / "other.cuh").write_text("#define C 1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_build_key_follows_included_headers(tmp_path, monkeypatch):
    """The library's name changes when a header the source includes
    (directly or through another header) changes, and stays when nothing
    it includes does."""
    csrc = _fake_csrc(tmp_path, monkeypatch)
    key = _build._lib_path("kern")
    assert key.parent == tmp_path / "build"
    assert key.name.startswith("libkern-") and key.suffix == ".so"
    assert [p.name for p in _build._sources(csrc / "kern.cu")] == [
        "kern.cu", "a.cuh", "b.cuh"]
    assert _build._lib_path("kern") == key
    (csrc / "other.cuh").write_text("#define C 2\n")
    assert _build._lib_path("kern") == key
    (csrc / "sub" / "b.cuh").write_text(
        '#pragma once\n#include "../a.cuh"\n#define B 2\n')
    edited = _build._lib_path("kern")
    assert edited != key
    (csrc / "a.cuh").write_text('#pragma once\n#include "sub/b.cuh"\n\n')
    assert _build._lib_path("kern") not in (key, edited)


def test_build_key_follows_flags(tmp_path, monkeypatch):
    _fake_csrc(tmp_path, monkeypatch)
    key = _build._lib_path("kern")
    monkeypatch.setattr(_build, "FLAGS", _build.FLAGS + ["-DEXTRA"])
    assert _build._lib_path("kern") != key


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_kernel_sources_hash_their_headers(name):
    """Every kernel source's key covers the shared headers exactly where
    the source includes them (the 3xTF32 helpers and the bf16 wgmma
    primitives in K1 and K2/K3, the split merge's ticket in K6 and K7),
    and is stable."""
    files = [p.name for p in _build._sources(_build.CSRC / f"{name}.cu")]
    want = [f"{name}.cu"]
    if name in ("flash_fwd", "flash_bwd"):
        want += ["tf32_mma.cuh", "wgmma_bf16.cuh"]
    if name in ("paged_attention", "int8_matmul"):
        want.append("split_merge.cuh")
    assert files == want
    assert _build._lib_path(name) == _build._lib_path(name)

"""The flash-attention forward kernel's arithmetic (K1,
``ml_trainer_tpu_torch/csrc/flash_fwd.cu``) emulated on the CPU, and the
build cache key of the port's CUDA kernels.

K1 runs the JAX kernel's online-softmax recurrence over 32-key tiles,
with q.k^T and p.v as TF32 tensor-core products in the 3-product split
(big*small + small*big + big*big; operands rounded as cvt.rna.tf32.f32
rounds, float32 sums).  ``_forward_tiles`` runs that recurrence in float32
with one, three or exact products; it is held against the plain
``flash_attention_reference`` and the JAX ``_flash_forward`` in interpret
mode, both float32.  The chip gate of K1 is 1e-4 absolute on out and lse
(``chip_smoke.py``'s ``TOL``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_trainer_tpu_torch.ops.kernels import _build
from test_torch_flash_backward import _arrays, _bf16_gate, _mm_tf32, _tf32

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
    """K1 on bf16 inputs, emulated at [1, 2, 256, d]: the widened bf16
    K and V (and q * scale at d = 64, a power-of-two scale) are their own
    TF32 big parts; the 3xTF32 recurrence on the widened values, its out
    rounded once to bf16, is within the bf16 chip gate (2 bf16 ulps) of
    the plain bf16 forward, and its lse within the float32 gate."""
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
    the source includes them (the 3xTF32 helpers in K1 and K2/K3, the
    split merge's ticket in K6 and K7), and is stable."""
    files = [p.name for p in _build._sources(_build.CSRC / f"{name}.cu")]
    want = [f"{name}.cu"]
    if name in ("flash_fwd", "flash_bwd"):
        want.append("tf32_mma.cuh")
    if name in ("paged_attention", "int8_matmul"):
        want.append("split_merge.cuh")
    assert files == want
    assert _build._lib_path(name) == _build._lib_path(name)

"""Port parity: ``ml_trainer_tpu_torch.ops.attention`` against the JAX
package's attention on the CPU.

The port's plain flash twin (``flash_attention_reference``, what the
wrapper runs for a CPU tensor) must match the JAX Pallas flash forward
run in interpret mode, output AND logsumexp, at float32 atol/rtol 1e-5
(the two sum in different orders).  Inputs are made with numpy from a
seed and cross as numpy arrays.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The ops packages re-export the ``attention`` function under the module's
# name, so the modules are fetched by their full names.
jatt = importlib.import_module("ml_trainer_tpu.ops.attention")
tatt = importlib.import_module("ml_trainer_tpu_torch.ops.attention")

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, b, h, s_q, s_k, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, n, d)).astype(np.float32)
            for n in (s_q, s_k, s_k)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("causal,lens", [
    (True, None), (False, None), (True, [20, 1]), (False, [9, 32]),
])
def test_flash_reference_matches_jax_interpret(causal, lens):
    q, k, v = _qkv(0, 2, 2, 32, 32, 16)
    j_lens = None if lens is None else jnp.asarray(lens, jnp.int32)
    j_out, j_lse = jatt._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_lens,
        causal=causal, scale=16 ** -0.5, block_q=16, block_k=16,
        interpret=True)
    t_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out, lse = tatt.flash_attention(_t(q), _t(k), _t(v), t_lens, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_padded_matches_jax(causal):
    """Off-tile S and head_dim through the zero-padding wrapper."""
    q, k, v = _qkv(1, 1, 2, 20, 20, 24)
    want = jatt._flash_padded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None, causal, None, 16, 16, interpret=True)
    got = tatt._flash_padded(_t(q), _t(k), _t(v), None, causal, None, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s_q,s_k,with_mask", [
    (12, 12, False), (4, 12, False), (4, 12, True),
])
def test_dot_product_attention_matches_jax(s_q, s_k, with_mask):
    """Bottom-right causal alignment for cross-length shapes, plus an
    ADDED boolean mask bias."""
    q, k, v = _qkv(2, 2, 3, s_q, s_k, 8)
    mask = None
    if with_mask:
        mask = np.random.default_rng(3).random((2, 1, s_q, s_k)) > 0.3
        mask[..., 0] = True
    want = jatt.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        mask=None if mask is None else jnp.asarray(mask))
    got = tatt.dot_product_attention(
        _t(q), _t(k), _t(v), causal=True,
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s,d,impl,route", [
    (256, 64, "auto", "flash"),     # tile-aligned: the kernel
    (200, 64, "auto", "plain"),     # off-tile and short: plain path
    (1024, 32, "auto", "padded"),   # off-tile from 1024 up: padded kernel
    (100, 40, "flash", "padded"),   # explicit flash pads at any length
    (256, 64, "xla", "plain"),
])
def test_attention_routing(monkeypatch, s, d, impl, route):
    """``attention`` takes the kernel exactly where the JAX package takes
    it on a TPU, and every route computes the same function."""
    calls = []
    real_flash = tatt.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real_flash(*a, **kw)

    monkeypatch.setattr(tatt, "flash_attention", spy)
    q, k, v = (_t(x) for x in _qkv(4, 1, 1, s, s, d))
    got = tatt.attention(q, k, v, causal=True, implementation=impl)
    if route == "plain":
        assert calls == []
    elif route == "flash":
        assert calls == [(1, 1, s, d)]
    else:
        assert len(calls) == 1 and calls[0] != (1, 1, s, d)
    want = tatt.dot_product_attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_attention_kv_lens_clamped_and_refusals():
    q, k, v = (_t(x) for x in _qkv(5, 2, 1, 128, 128, 64))
    lens = torch.tensor([0, 50])
    got = tatt.attention(q, k, v, kv_lens=lens)  # auto -> kernel route
    mask = (torch.arange(128)[None, :] < torch.tensor([1, 50])[:, None])
    want = tatt.dot_product_attention(q, k, v, mask=mask[:, None, None, :])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tatt.attention(q, k, v, implementation=impl)
    with pytest.raises(ValueError, match="arbitrary masks"):
        tatt.attention(q, k, v, mask=mask[:, None, None, :],
                       implementation="flash")
    with pytest.raises(ValueError, match="equal query/key"):
        tatt.attention(q[:, :, :64], k, v, implementation="flash")


@pytest.mark.parametrize("causal,with_mask", [(True, False), (False, True),
                                              (True, True)])
def test_dot_product_attention_bf16_matches_jax(causal, with_mask):
    """The plain path in bf16 follows JAX ``dot_product_attention``:
    f32 scores, the weights cast to v's dtype before PV, the result in
    q's dtype.  Output and gradients (bf16) within 2e-2, the JAX
    package's own bf16 bar."""
    q, k, v = _qkv(4, 2, 2, 24, 24, 16)
    g = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    mask = (np.random.default_rng(6).random((2, 1, 24, 24)) > 0.3
            if with_mask else None)
    if mask is not None:
        mask[..., 0] = True
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    jm = None if mask is None else jnp.asarray(mask)
    j_out, vjp = jax.vjp(
        lambda q, k, v: jatt.dot_product_attention(q, k, v, causal=causal,
                                                   mask=jm), jq, jk, jv)
    leaves = [_t(x).to(torch.bfloat16).requires_grad_(True)
              for x in (q, k, v)]
    tm = None if mask is None else _t(mask)
    out = tatt.dot_product_attention(*leaves, causal=causal, mask=tm)
    grads = torch.autograd.grad(out, leaves, _t(g).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 == grads[0].dtype
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=2e-2, rtol=2e-2)
    for name, a, b in zip("qkv", grads, vjp(jg)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=2e-2, rtol=2e-2, err_msg=f"d{name}")

"""Port parity: the flash-attention backward of ``ml_trainer_tpu_torch``
against the JAX package's on the CPU.

The port's gradient goes through its ``torch.autograd.Function``, which
on CPU tensors runs the plain twins of the backward kernels (K2, K3);
the JAX gradient is ``jax.vjp`` of the Pallas ``flash_attention`` run in
interpret mode.  Tolerance: atol = rtol = 2e-4, the JAX package's own
for its flash backward (``tests/test_attention.py``): float32 sums taken
in a different order.  Inputs and cotangents are made with numpy from a
seed and cross as numpy arrays.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jatt = importlib.import_module("ml_trainer_tpu.ops.attention")
tatt = importlib.import_module("ml_trainer_tpu_torch.ops.attention")

TOL = dict(atol=2e-4, rtol=2e-4)


def _arrays(seed, b, h, s, d, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32)
            for _ in range(n)]


def _jax_grads(q, k, v, g, lens, causal, block_q, block_k):
    j_lens = None if lens is None else jnp.asarray(lens, jnp.int32)

    def f(q, k, v):
        return jatt.flash_attention(q, k, v, j_lens, causal, None, block_q,
                                    block_k, True)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _torch_grads(q, k, v, g, lens, causal, fn=None):
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    t_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    if fn is None:
        out = tatt.flash_attention(*leaves, t_lens, causal)[0]
    else:
        out = fn(*leaves, t_lens)
    return [x.numpy() for x in torch.autograd.grad(out, leaves,
                                                   torch.tensor(g))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [(64, 64), (32, 32), (64, 32)])
def test_flash_backward_matches_jax_interpret(causal, blocks):
    q, k, v, g = _arrays(0, 2, 2, 128, 64)
    want = _jax_grads(q, k, v, g, None, causal, *blocks)
    got = _torch_grads(q, k, v, g, None, causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_kv_lens_matches_jax(causal):
    """kv_lens [128, 50]: gradients match, and dK/dV past each length are
    exactly zero in both packages."""
    lens = [128, 50]
    q, k, v, g = _arrays(1, 2, 2, 128, 64)
    want = _jax_grads(q, k, v, g, lens, causal, 64, 32)
    got = _torch_grads(q, k, v, g, lens, causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **TOL)
    for grads in (got, want):
        assert np.all(grads[1][1, :, 50:] == 0.0)
        assert np.all(grads[2][1, :, 50:] == 0.0)
        assert np.any(grads[1][1, :, :50] != 0.0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_padded_backward_matches_jax(causal):
    """Off-tile S = 100 and head_dim 32 through the padding wrapper: the
    padded query rows get a zero cotangent from the slice and the padded
    keys are masked through kv_lens."""
    q, k, v, g = _arrays(2, 1, 2, 100, 32)

    def j(q, k, v):
        return jatt._flash_padded(q, k, v, None, causal, None, 64, 32,
                                  interpret=True)

    _, vjp = jax.vjp(j, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = _torch_grads(q, k, v, g, None, causal,
                       fn=lambda q, k, v, _: tatt._flash_padded(
                           q, k, v, None, causal, None, 64, 32))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("causal,lens", [(True, None), (False, [5, 8]),
                                         (True, [3, 8])])
def test_flash_attention_function_gradcheck(causal, lens):
    """float64 finite differences of the autograd Function (its plain
    backward, the function of K2/K3) at a tiny size."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.normal(size=(2, 2, 8, 4)),
                            dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    t_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32)

    def f(q, k, v):
        return tatt.flash_attention(q, k, v, t_lens, causal)[0]

    assert torch.autograd.gradcheck(f, (q, k, v), eps=1e-6, atol=1e-6)


def test_flash_attention_output_carries_the_function():
    q = torch.randn(1, 2, 16, 8, requires_grad=True)
    out, lse = tatt.flash_attention(q, q, q, None, True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    assert not lse.requires_grad
    # The routing entry point reaches it too, padded or not.
    x = torch.randn(1, 2, 128, 64, requires_grad=True)
    routed = tatt.attention(x, x, x, causal=True, implementation="flash")
    assert type(routed.grad_fn).__name__ == "_FlashAttentionBackward"


def _tf32(x):
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest on
    the 10 kept mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, products):
    """a @ b as the tensor cores take it: TF32 operands, float32 sums;
    three products (big*small + small*big + big*big) or one (big*big)."""
    a_big, b_big = _tf32(a), _tf32(b)
    if products == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_big @ b_small + a_small @ b_big + a_big @ b_big


def _backward_tf32(q, k, v, lse, delta, dout, causal, scale, products):
    """K2/K3's arithmetic: every product of the backward through
    ``_mm_tf32``, the rest in float32."""
    s = q.shape[-2]
    p = torch.exp(_mm_tf32(q, k.transpose(-1, -2), products) * scale
                  - lse[..., None])
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool).tril()
        p = torch.where(keep, p, torch.zeros(()))
    dp = _mm_tf32(dout, v.transpose(-1, -2), products)
    ds = p * (dp - delta[..., None]) * scale
    return (_mm_tf32(ds, k, products),
            _mm_tf32(ds.transpose(-1, -2), q, products),
            _mm_tf32(p.transpose(-1, -2), dout, products))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_three_tf32_products_keep_the_chip_gate(d, causal):
    """The backward kernels' 3xTF32 split, emulated on the CPU at
    [1, 2, 256, d], is within the chip gate (atol 2e-4, rtol 1e-4) of
    the float32 plain backward; one TF32 product is at least 10x
    further off, which is why the kernels split."""
    q, k, v, g = (torch.tensor(x) for x in _arrays(5, 1, 2, 256, d))
    scale = d ** -0.5
    out, lse = tatt.flash_attention_reference(q, k, v, None, causal, scale)
    want = tatt.flash_attention_backward_reference(q, k, v, None, out, lse,
                                                   g, causal, scale)
    delta = (g * out).sum(-1)
    errs = {}
    for products in (3, 1):
        got = _backward_tf32(q, k, v, lse, delta, g, causal, scale, products)
        errs[products] = max((a - b).abs().max().item()
                             for a, b in zip(got, want))
        if products == 3:
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-4)
    assert errs[1] >= 10 * errs[3], errs


@pytest.mark.parametrize("causal,lens", [(True, None), (False, [40, 17])])
def test_backward_kernel_wrappers_take_the_plain_twin_on_cpu(causal, lens):
    """``flash_bwd_dq`` / ``flash_bwd_dkv`` (the K2/K3 wrappers) on CPU
    tensors equal the plain backward, delta = rowsum(dO * O)."""
    q, k, v, g = (torch.tensor(x) for x in _arrays(4, 2, 2, 40, 16))
    t_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out, lse = tatt.flash_attention_reference(q, k, v, t_lens, causal)
    want = tatt.flash_attention_backward_reference(q, k, v, t_lens, out,
                                                   lse, g, causal, 0.25)
    delta = (g * out).sum(-1)
    dq = tatt.flash_bwd_dq(q, k, v, t_lens, lse, delta, g, causal, 0.25)
    dk, dv = tatt.flash_bwd_dkv(q, k, v, t_lens, lse, delta, g, causal, 0.25)
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)

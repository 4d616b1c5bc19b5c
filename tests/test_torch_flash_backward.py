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


# -------------------------------------------------------------- bfloat16
BF16_TOL = dict(atol=2e-2, rtol=2e-2)  # the JAX package's own bf16 bar


def _bf16(arrays):
    """The same float32 numpy arrays rounded to bf16 in both packages
    (round to nearest even in each): equal bf16 values."""
    return ([jnp.asarray(x, jnp.bfloat16) for x in arrays],
            [torch.tensor(x).to(torch.bfloat16) for x in arrays])


@pytest.mark.parametrize("causal,lens", [(True, None), (False, None),
                                         (True, [128, 50]),
                                         (False, [128, 50])])
@pytest.mark.parametrize("blocks", [(64, 64), (64, 32)])
def test_flash_bf16_matches_jax_interpret_and_keeps_the_dtype(causal, lens,
                                                              blocks):
    """bf16 q, k, v and cotangent: the port's plain K1-K3 (f32 inside)
    against JAX ``flash_attention(..., interpret=True)`` through
    ``jax.vjp`` on the same bf16 values; the output and every gradient
    are bf16 in both packages (``tests/test_attention.py``'s dtype
    contract)."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _bf16(_arrays(11, 2, 2, 128, 64))
    j_lens = None if lens is None else jnp.asarray(lens, jnp.int32)
    t_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    j_out, vjp = jax.vjp(
        lambda q, k, v: jatt.flash_attention(q, k, v, j_lens, causal, None,
                                             *blocks, True), jq, jk, jv)
    j_grads = vjp(jg)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out, lse = tatt.flash_attention(*leaves, t_lens, causal)
    grads = torch.autograd.grad(out, leaves, tg)
    assert j_out.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    assert lse.dtype == torch.float32
    assert all(g.dtype == jnp.bfloat16 for g in j_grads)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(j_out, np.float32), **BF16_TOL)
    for name, a, b in zip("qkv", grads, j_grads):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   err_msg=f"d{name}", **BF16_TOL)
    if lens is not None:
        assert bool((grads[1][1, :, 50:] == 0).all())
        assert bool((grads[2][1, :, 50:] == 0).all())


def _bf16_gate(got, want):
    """The chip gate of the bf16 kernels, as a margin: max over elements
    of |got - want| - (2^-7 |want| + 1e-3 max|want|), <= 0 passes
    (within 2 bf16 ulps of the plain value)."""
    got, want = got.float(), want.float()
    bar = 2 ** -7 * want.abs() + 1e-3 * want.abs().max()
    return float(((got - want).abs() - bar).max())


def _bf16_terms(x, terms):
    """float32 x as ``terms`` bf16 values whose sum approaches it: hi =
    bf16(x), lo = bf16(x - hi), ... (round to nearest even, as
    ``__float2bfloat16_rn``)."""
    out = []
    for _ in range(terms):
        out.append(x.to(torch.bfloat16))
        x = x - out[-1].float()
    return out


def _mm_bf16(a, b, terms):
    """a @ b as the bf16 kernels take it: float32 ``a`` (P or dS) split in
    ``terms`` bf16 terms, one bf16 product each, the smallest term first,
    float32 sums; a bf16 x bf16 product is exact in float32."""
    out = None
    for part in reversed(_bf16_terms(a, terms)):
        term = part.float() @ b.float()
        out = term if out is None else out + term
    return out


def _backward_bf16(q, k, v, kv_lens, lse, delta, dout, causal, scale,
                   terms):
    """K2/K3's bf16 arithmetic: one bf16 product for q.k^T and dO.v^T,
    P and dS split in ``terms`` bf16 terms for P^T.dO, dS.k and dS^T.q,
    each output rounded once to bf16."""
    p = torch.exp(q.float() @ k.float().transpose(-1, -2) * scale
                  - lse[..., None])
    keep = tatt._keep_mask(q.shape[-2], k.shape[-2], kv_lens, causal,
                           q.device)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros(()))
    dp = dout.float() @ v.float().transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * scale
    return tuple(x.to(torch.bfloat16) for x in (
        _mm_bf16(ds, k, terms), _mm_bf16(ds.transpose(-1, -2), q, terms),
        _mm_bf16(p.transpose(-1, -2), dout, terms)))


def _bf16_backward_case(seed, shape, lens, causal):
    """bf16 q, k, v, dO from numpy, the forward's float32 lse and delta =
    rowsum(dO * O) on the bf16 O, and kv_lens (or None)."""
    q, k, v, g = (torch.tensor(x).to(torch.bfloat16)
                  for x in _arrays(seed, *shape))
    t_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    scale = shape[-1] ** -0.5
    out, lse = tatt.flash_attention_reference(q, k, v, t_lens, causal, scale)
    return (q, k, v, t_lens, lse, tatt._row_delta(out, g), g, causal,
            scale)


def _exact(args):
    """The kernels' function of their inputs in float64, unrounded."""
    q, k, v, lens, lse, delta, g, causal, scale = args
    return tatt._backward_plain(q.double(), k.double(), v.double(), lens,
                                lse.double(), delta.double(), g.double(),
                                causal, scale)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_three_tf32_products_keep_the_chip_gate_in_bf16(d, causal):
    """The bf16 backward kernels' arithmetic, emulated at [1, 2, 256, d].
    Of the 3xTF32 split of the float32 kernels only big x big is left for
    a bf16 x bf16 product (a bf16 value widened to float32 is its own
    TF32 big part, its small part exactly 0), so q.k^T and dO.v^T take
    one bf16 product each; P^T.dO, dS.k and dS^T.q take two, P and dS
    split in hi + lo bf16 terms, with float32 sums.  Each output, rounded
    once to bf16, is within the chip gate (2 bf16 ulps) of the plain
    bf16 backward, and within half of it of the float64 function."""
    args = _bf16_backward_case(5, (1, 2, 256, d), None, causal)
    for t in (args[0], args[1], args[2], args[6]):
        w = t.float()
        assert torch.equal(_tf32(w), w)
        assert torch.equal(_tf32(w - _tf32(w)), torch.zeros_like(w))
    want = tatt._backward_plain(*args)
    assert all(w.dtype == torch.bfloat16 for w in want)
    got = _backward_bf16(*args, terms=2)
    for name, a, b, e in zip(("dq", "dk", "dv"), got, want, _exact(args)):
        assert _bf16_gate(a, b) <= 0, name
        ratio = float(((a.double() - e).abs()
                       / (2 ** -7 * e.abs() + 1e-3 * e.abs().max())).max())
        assert ratio < 0.5, (name, ratio)


@pytest.mark.parametrize("shape,causal,lens", [
    ((2, 12, 512, 64), True, None),
    ((4, 12, 128, 64), False, [128, 50, 1, 97]),
])
def test_one_bf16_term_for_p_and_ds_breaks_the_chip_gate(shape, causal,
                                                         lens):
    """Why the bf16 kernels split P and dS in two bf16 terms: with one
    (P rounded to bf16 before its product, as FlashAttention and SDPA
    do) some gradient lands beyond the 2-ulp gate of the float64
    function of the same inputs; with two every gradient stays under
    half of it."""
    args = _bf16_backward_case(0, shape, lens, causal)
    exact = _exact(args)

    def worst(terms):
        return max(
            float(((a.double() - e).abs()
                   / (2 ** -7 * e.abs() + 1e-3 * e.abs().max())).max())
            for a, e in zip(_backward_bf16(*args, terms=terms), exact))

    one, two = worst(1), worst(2)
    assert one > 1.0, one
    assert two < 0.5, two


def test_kernel_checks_refuse_mixed_dtypes_and_float16():
    """The kernels take float32 or bfloat16 q/k/v/dO, all alike, and
    float32 lse/delta: anything else is refused before a launch."""
    x = torch.zeros(1, 2, 64, 64)
    lse = delta = torch.zeros(1, 2, 64)
    bf = x.to(torch.bfloat16)
    tatt._check_kernel_inputs(bf, bf, bf, "k")
    tatt._check_backward_inputs(bf, bf, bf, lse, delta, bf)
    for q, k, v in ((x, bf, bf), (bf, x, bf), (bf, bf, x),
                    (x.half(), x.half(), x.half()),
                    (x.double(), x.double(), x.double())):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tatt._flash_kernel(q, k, v, None, True, 0.125)
    with pytest.raises(TypeError, match="dout"):
        tatt._check_backward_inputs(bf, bf, bf, lse, delta, x)
    with pytest.raises(ValueError, match="lse"):
        tatt._check_backward_inputs(bf, bf, bf, lse.to(torch.bfloat16),
                                    delta, bf)
    with pytest.raises(ValueError, match="delta"):
        tatt._check_backward_inputs(x, x, x, lse, delta[..., :8], x)

"""Port parity: the image and encoder families of ``ml_trainer_tpu_torch``
(MLModel, ResNet, BERT, ViT) against the JAX package's, on the CPU.

Each family's flax variables (params, and ``batch_stats`` for ResNet)
cross into the port through ``params_from_jax`` as numpy; then the
logits agree at rtol 1e-4 / atol 1e-5 (float32, convolutions and
matmuls summed in another order).  ResNet is compared in eval mode
(running statistics, drawn away from their 0/1 init so that they
matter) and in train mode, where the mutated ``batch_stats`` must agree
too (rtol 1e-4 / atol 1e-5; flax's variance is E[x^2] - E[x]^2, the
port's cuDNN/ATen two-pass form).

BERT at S = 128 with head_dim 64 takes the port's flash route (its plain
twins on the CPU, through the autograd Function the card's kernels sit
behind); the JAX package takes its XLA path off a TPU.  The layer checks:
``Conv``'s "SAME" padding against ``lax.conv_general_dilated`` (exact
up to rounding, 1e-5) and ``BatchNorm`` against flax's (outputs and
running statistics, rtol 1e-5 / atol 1e-6).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_trainer_tpu.models import get_model as j_get_model
from ml_trainer_tpu.models.mlmodel import MLModel as JMLModel
from ml_trainer_tpu_torch import MLModel, get_model, init_model, params_from_jax
from ml_trainer_tpu_torch.models import available_models
from ml_trainer_tpu_torch.models.layers import BatchNorm, Conv, same_pads

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: small ops otherwise wait on all cores'
    threads, which the suite's other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _images(seed, b, side):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, side, side, 3)).astype(np.float32)


def _right_padded_ids(seed, b, s, vocab, min_len=1):
    """Real tokens in [1, vocab) (no holes in the mask), then 0 padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(b, s)).astype(np.int32)
    lens = rng.integers(min_len, s + 1, size=b)
    lens[0] = s  # one full row
    ids[np.arange(s)[None, :] >= lens[:, None]] = 0
    return ids


def _port(name, variables, **kw):
    model = get_model(name, device="cpu", **kw)
    model.load_state_dict(params_from_jax(_host(variables)))
    return model.eval()


def _logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


# --------------------------------------------------------------- layers
@pytest.mark.parametrize("side,kernel,stride", [
    (8, 3, 2), (7, 3, 2), (8, 3, 1), (8, 1, 2), (9, 7, 2), (16, 3, 2)])
def test_conv_same_padding_matches_lax(side, kernel, stride):
    rng = np.random.default_rng(side * 10 + kernel + stride)
    x = rng.normal(size=(2, side, side, 3)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, 3, 4)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    pads = jax.lax.padtype_to_pads((side, side), (kernel, kernel),
                                   (stride, stride), "SAME")
    assert [same_pads(side, kernel, stride)] * 2 == [tuple(p) for p in pads]
    conv = Conv(3, 4, kernel, stride, bias=False, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_batch_norm_matches_flax_in_both_modes():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 3, 3, 2)).astype(np.float32) * 2 + 0.5
    j_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    v = j_bn.init(jax.random.PRNGKey(0), x)
    v = {"params": {"scale": rng.normal(size=2).astype(np.float32),
                    "bias": rng.normal(size=2).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(size=2).astype(np.float32),
                         "var": rng.uniform(0.5, 2, 2).astype(np.float32)}}
    want, mutated = j_bn.apply(v, x, mutable=["batch_stats"])
    want_eval = fnn.BatchNorm(use_running_average=True).apply(v, x)
    bn = BatchNorm(2, device="cpu")
    bn.load_state_dict(params_from_jax(v))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = bn.eval()(xt)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want_eval), rtol=1e-5, atol=1e-6)
        got = bn.train()(xt)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
    stats = mutated["batch_stats"]
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(stats[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # The biased variance, not torch's unbiased update.
    biased = x.reshape(-1, 2).var(0)
    np.testing.assert_allclose(
        bn.running_var.numpy(),
        0.9 * np.asarray(v["batch_stats"]["var"]) + 0.1 * biased, rtol=1e-5)


# --------------------------------------------------------------- MLModel
def test_mlmodel_logits_match_jax():
    x = _images(1, 4, 32)
    j_model = JMLModel()
    variables = j_model.init(jax.random.PRNGKey(0), x)
    want = np.asarray(j_model.apply(variables, x))
    model = MLModel(device="cpu")
    model.load_state_dict(params_from_jax(_host(variables)))
    np.testing.assert_allclose(_logits(model, x), want, **TOL)
    # fc1 came across as a plain transpose: the port flattens H, W, C.
    np.testing.assert_array_equal(
        model.fc1.weight.detach().numpy(),
        np.asarray(variables["params"]["fc1"]["kernel"]).T)


# ---------------------------------------------------------------- ResNet
def _resnet_variables(name, x, **kw):
    j_model = j_get_model(name, **kw)
    variables = _host(j_model.init(jax.random.PRNGKey(0), x, train=False))
    rng = np.random.default_rng(7)
    stats = jax.tree.map(lambda a: a, variables["batch_stats"])

    def draw(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                draw(v)
            elif k == "mean":
                tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            else:
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    draw(stats)
    return j_model, {"params": variables["params"], "batch_stats": stats}


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_eval_logits_match_jax(name):
    x = _images(2, 2, 32)
    j_model, variables = _resnet_variables(name, x)
    want = np.asarray(j_model.apply(variables, x, train=False))
    model = _port(name, variables)
    np.testing.assert_allclose(_logits(model, x), want, **TOL)


@pytest.mark.parametrize("name,dtype", [("resnet18", "float32"),
                                        ("resnet50", "float64")])
def test_resnet_train_mode_logits_and_batch_stats_match_jax(name, dtype):
    """Train mode normalises with batch statistics.  ResNet-50 at 32x32
    leaves a 1x1 map at stage 4, so its BatchNorms there see 4 values a
    channel with |mean| / std up to ~34, and float32 rounding alone moves
    the logits by ~1e-2 from a float64 evaluation in the reference (its
    variance is E[x^2] - E[x]^2) and ~4e-3 in the port (two-pass).  Its
    check runs both packages in float64, where the semantics (padding,
    layout, biased running variance) are left alone to compare."""
    x = _images(3, 4, 32)
    with jax.enable_x64(dtype == "float64"):
        jdt = jnp.float64 if dtype == "float64" else jnp.float32
        j_model, variables = _resnet_variables(name, x, dtype=jdt)
        xj = x.astype(dtype)
        want, mutated = j_model.apply(variables, xj, train=True,
                                      mutable=["batch_stats"])
        want, mutated = np.asarray(want), _host(mutated["batch_stats"])
    model = _port(name, variables).to(getattr(torch, dtype)).train()
    with torch.no_grad():
        got = model(torch.from_numpy(xj)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    want_sd = params_from_jax({"params": variables["params"],
                               "batch_stats": mutated})
    buffers = dict(model.named_buffers())
    assert len(buffers) == sum(1 for k in want_sd if "running_" in k) > 0
    for name_, buf in buffers.items():
        np.testing.assert_allclose(buf.numpy(), want_sd[name_].numpy(),
                                   **TOL, err_msg=name_)


def test_resnet_blocks_and_downsample_follow_flax():
    j_model, variables = _resnet_variables("resnet50", _images(0, 1, 32))
    model = _port("resnet50", variables)
    flax_blocks = [k for k in variables["params"] if k.startswith("stage")]
    assert model.block_names == flax_blocks
    for name in flax_blocks:
        has = "downsample" in variables["params"][name]
        assert (getattr(model, name).downsample is not None) == has, name
    # The 1x1 stride-2 downsample takes no padding, as flax gives it none.
    assert model.stage2_block1.downsample.padding == "VALID"


# ------------------------------------------------------------------ BERT
@pytest.mark.parametrize("right_padded", [False, True])
def test_bert_tiny_logits_match_jax(right_padded):
    ids = _right_padded_ids(4, 4, 16, 1024)
    j_model = j_get_model("bert_tiny", right_padded=right_padded)
    variables = j_model.init(jax.random.PRNGKey(0), ids)
    want = np.asarray(j_model.apply(variables, ids))
    model = _port("bert_tiny", variables, right_padded=right_padded)
    np.testing.assert_allclose(_logits(model, ids), want, **TOL)


def test_bert_head_dim_64_takes_the_flash_route_and_matches_jax():
    kw = dict(embed_dim=128, num_heads=2, max_len=128, right_padded=True)
    ids = _right_padded_ids(5, 4, 128, 1024, min_len=8)
    j_model = j_get_model("bert_tiny", **kw)
    variables = j_model.init(jax.random.PRNGKey(0), ids)
    want = np.asarray(j_model.apply(variables, ids))
    model = _port("bert_tiny", variables, **kw)
    for p in model.parameters():
        p.requires_grad_(True)
    out = model(torch.from_numpy(ids))
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    seen, stack = set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    assert "_FlashAttentionBackward" in {type(fn).__name__ for fn in seen}


# ------------------------------------------------------------------- ViT
def test_vit_tiny_logits_match_jax():
    x = _images(6, 2, 32)
    j_model = j_get_model("vit_tiny")
    variables = j_model.init(jax.random.PRNGKey(0), x)
    # cls_token inits to zero: give it values so that it matters.
    variables = _host(variables)
    variables["params"]["cls_token"] = np.random.default_rng(0).normal(
        size=(1, 1, 128)).astype(np.float32)
    want = np.asarray(j_model.apply(variables, x))
    model = _port("vit_tiny", variables)
    assert tuple(model.cls_token.shape) == (1, 1, 128)
    np.testing.assert_allclose(_logits(model, x), want, **TOL)


def test_vit_pos_embed_shape_is_checked_on_load():
    x = _images(6, 1, 32)
    variables = _host(j_get_model("vit_tiny").init(jax.random.PRNGKey(0), x))
    model = get_model("vit_tiny", device="cpu", image_size=64)
    with pytest.raises(RuntimeError, match="pos_embed"):
        model.load_state_dict(params_from_jax(variables))


def test_vit_b16_bf16_default_is_refused():
    """No longer refused: ``vit_b16`` builds at its default bf16 compute
    dtype, as in the JAX package, with float32 parameters, and computes
    in bf16 up to its float32 head."""
    model = get_model("vit_b16", device="cpu", depth=1)
    assert model.dtype == torch.bfloat16
    assert tuple(model.pos_embed.shape) == (1, 197, 768)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert model.blocks[0].attn.qkv.dtype == torch.bfloat16
    assert model.head.dtype == torch.float32
    with torch.no_grad():
        out = model(torch.zeros(1, 224, 224, 3))
    assert out.dtype == torch.float32 and out.shape == (1, 1000)
    model = get_model("vit_b16", device="cpu", dtype=torch.float32, depth=1)
    assert model.blocks[0].attn.qkv.dtype is None and model.head.dtype is None


# ------------------------------------------------------------- bf16
BF16_CASES = [
    ("gpt2_tiny", {}, lambda: np.random.default_rng(0).integers(
        0, 1024, (2, 128)).astype(np.int32)),
    ("bert_tiny", dict(embed_dim=128, num_heads=2, right_padded=True),
     lambda: _right_padded_ids(0, 4, 128, 1024, min_len=8)),
    ("vit_tiny", {}, lambda: _images(6, 2, 32)),
    ("resnet18", {}, lambda: _images(2, 2, 16)),
]
# bf16 logits: |port - JAX| <= 3e-2 x max|JAX logits|.  bf16 keeps 8
# significant bits and the two frameworks round at other places (XLA's
# fused elementwise chains, PyTorch's per-op casts); observed 0.25%
# (ResNet-18) to 1.3% (BERT's 2-class head) of the largest logit.
BF16_REL = 3e-2


@pytest.mark.parametrize("name,kw,inputs", BF16_CASES,
                         ids=[c[0] for c in BF16_CASES])
def test_bf16_logits_match_jax(name, kw, inputs):
    """Each family built with ``precision="bf16"`` in both packages from
    the same float32 weights (GPT-2 at 128 tokens, BERT right-padded at
    head_dim 64 through the flash route, ViT, ResNet-18 on 16x16 inputs
    with drawn running statistics), called directly: the modules' own
    casts (bf16 compute, float32 parameters and heads)."""
    x = inputs()
    if name == "resnet18":
        j_model, variables = _resnet_variables(name, x, precision="bf16")
        variables = _host(variables)
    else:
        j_model = j_get_model(name, precision="bf16", **kw)
        variables = _host(j_model.init(jax.random.PRNGKey(0), x))
    if name == "vit_tiny":  # a class token that matters
        variables["params"]["cls_token"] = np.random.default_rng(0).normal(
            size=(1, 1, 128)).astype(np.float32)
    want = np.asarray(j_model.apply(variables, x), np.float32)
    model = _port(name, variables, precision="bf16", **kw)
    assert model.dtype == torch.bfloat16 and j_model.dtype == jnp.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    got = _logits(model, x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_REL * np.abs(want).max())
    # The bf16 program is not the float32 one.
    fp32 = _logits(_port(name, variables, **kw), x)
    assert np.abs(fp32 - got).max() > 1e-4 * np.abs(want).max()
    if name == "resnet18":  # train-mode statistics come home float32
        model.train()
        with torch.no_grad():
            model(torch.from_numpy(x))
        assert model.stem_bn.running_var.dtype == torch.float32


# -------------------------------------------------------------- registry
def test_registry_lists_every_ported_family():
    names = set(available_models())
    assert {"mlmodel", "resnet18", "resnet50", "resnet101", "resnet152",
            "bert_base", "bert_large", "bert_tiny", "vit_b16", "vit_tiny",
            "gpt2", "gpt2_tiny", "gpt2_mini", "gpt2_medium", "gpt2_large",
            "gpt2_nano", "llama", "llama_tiny"} <= names


@pytest.mark.parametrize("name,kw", [
    ("mlmodel", {}), ("resnet18", {}), ("bert_tiny", {}), ("vit_tiny", {}),
])
def test_init_model_is_seeded_and_matches_the_jax_parameter_set(name, kw):
    a = init_model(name, seed=3, device="cpu", **kw).state_dict()
    b = init_model(name, seed=3, device="cpu", **kw).state_dict()
    c = init_model(name, seed=4, device="cpu", **kw).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    x = (_right_padded_ids(0, 1, 8, 1024) if name.startswith("bert")
         else _images(0, 1, 32))
    variables = _host(j_get_model(name).init(jax.random.PRNGKey(0), x))
    want = params_from_jax(variables)
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    # Draws follow flax's defaults: a Dense/Conv kernel's spread is
    # lecun's 1/sqrt(fan_in), truncated at two deviations.
    for key, w in a.items():
        if key.endswith("weight") and w.dim() >= 2 and "embed" not in key:
            fan_in = w[0].numel()
            assert abs(float(w.std()) * fan_in ** 0.5 - 1) < 0.35, key
            assert float(w.abs().max()) * fan_in ** 0.5 <= 2.28, key

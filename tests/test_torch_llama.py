"""Port parity: the Llama family (``models/llama.py``: RMSNorm, RoPE,
grouped-query attention, SwiGLU) and the GPT-2 sizes against the JAX
package on the CPU.

The same weights go into both packages through ``params_from_jax``; the
JAX side runs its plain attention (its 'auto' takes XLA on the CPU).
Bars:

* ``apply_rope``: 2e-6 of max|x|, at positions up to 2047 and per row;
* ``RMSNorm`` against flax ``nn.RMSNorm``: float32 within 1e-6, bf16
  bitwise;
* logits (the port's ``flash`` route, the kernels' plain versions here,
  and its ``xla`` route): float32 atol = rtol = 1e-5; bf16 logits within
  3e-2 of the largest and the loss within 2e-2 (the bf16 policy's bars);
* one step's gradients against ``jax.grad``: each leaf within 1e-4 of
  its largest entry, dense head and ``loss_chunk``;
* a ``fit()`` against the JAX trainer's: epoch losses rtol 1e-4; a JAX
  ``TrainState`` carried over by ``state_from_jax``: the next two steps'
  losses rtol 1e-5;
* greedy ``generate()``: tokens equal, to the JAX package's and to the
  argmax over repeated full forwards.
"""

import importlib
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import ml_trainer_tpu as J
import ml_trainer_tpu_torch as mt
from ml_trainer_tpu import checkpoint as jckpt
from ml_trainer_tpu.data import SyntheticTokens as JTokens
from ml_trainer_tpu.generate import generate as jgenerate
from ml_trainer_tpu.models import get_model as jget_model
from ml_trainer_tpu.models.llama import apply_rope as japply_rope
from ml_trainer_tpu_torch.convert import state_from_jax
from ml_trainer_tpu_torch.models import gpt2 as port_gpt2
from ml_trainer_tpu_torch.models import llama as port_llama
from ml_trainer_tpu_torch.models.layers import RMSNorm
from ml_trainer_tpu_torch.ops.losses import chunked_lm_cross_entropy
from ml_trainer_tpu_torch.train_state import load_state_tree

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_LOSS, BF16_LOGITS = 2e-2, 3e-2
# A GQA config whose head_dim (64) takes the flash kernels' route.
GQA = dict(vocab_size=512, max_len=256, embed_dim=128, depth=2, num_heads=2,
           num_kv_heads=1)
CONFIGS = {"gqa": ("llama", GQA), "tiny": ("llama_tiny", {})}
port_attention = importlib.import_module("ml_trainer_tpu_torch.ops.attention")


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


def _ids(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close_to_max(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), what


@pytest.fixture(scope="module")
def jax_models():
    """Each config's JAX module and its variables (numpy), built once."""
    out = {}
    for key, (name, kw) in CONFIGS.items():
        jm = jget_model(name, **kw)
        var = jax.jit(lambda rng: jm.init(  # noqa: B023 - called at once
            {"params": rng}, jnp.zeros((1, 8), jnp.int32),
            train=False))(jax.random.PRNGKey(0))
        out[key] = (jm, _host(var))
    return out


@pytest.fixture(scope="module")
def jax_logits(jax_models):
    """``get(key, dtype)``: the JAX module's logits of one config at one
    compute dtype on the shared ids [2, 128], each computed once."""
    done = {}

    def get(key, dtype):
        if (key, dtype) not in done:
            name, cfg = CONFIGS[key]
            jm = jget_model(name, dtype=jnp.dtype(dtype), **cfg)
            x = _ids(7, 2, 128, jm.vocab_size)
            done[key, dtype] = x, np.asarray(jax.jit(
                lambda v: jm.apply(v, x, train=False))(
                    jax_models[key][1]), np.float32)
        return done[key, dtype]

    return get


def _port(key, variables, **kw):
    name, cfg = CONFIGS[key]
    model = mt.get_model(name, device="cpu", **cfg, **kw)
    model.load_state_dict(mt.params_from_jax(variables))
    return model


class _Spy:
    """Counts the calls of the flash kernels' plain forward: the flash
    route on the CPU."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = port_attention.flash_attention_reference

        def spy(*args, **kw):
            self.calls += 1
            return real(*args, **kw)

        monkeypatch.setattr(port_attention, "flash_attention_reference", spy)


# ------------------------------------------------------------ RoPE, RMSNorm
@pytest.mark.parametrize("d", [16, 64])
def test_apply_rope_matches_jax(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 3, 2048, d)).astype(np.float32)
    bar = 2e-6 * np.abs(x).max()
    want = np.asarray(japply_rope(jnp.asarray(x), jnp.arange(2048)))
    got = port_llama.apply_rope(torch.from_numpy(x), torch.arange(2048))
    assert np.abs(got.numpy() - want).max() <= bar
    # A position per row (the decode cache's): rows at offsets 0 and 1999.
    offs = np.array([0, 1999])
    pos = offs[:, None] + np.arange(48)[None]
    got = port_llama.apply_rope(torch.from_numpy(x[:, :, :48]),
                                torch.from_numpy(pos))
    for b in range(2):
        want = np.asarray(japply_rope(jnp.asarray(x[b:b + 1, :, :48]),
                                      jnp.asarray(pos[b])))
        assert np.abs(got[b:b + 1].numpy() - want).max() <= bar


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_flax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 128)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = fnn.RMSNorm(dtype=jdt).apply({"params": {"scale": scale}},
                                        jnp.asarray(x, jdt))
    norm = RMSNorm(128, device="cpu",
                   dtype=None if dtype == "float32" else tdt)
    norm.weight.data.copy_(torch.from_numpy(scale))
    got = norm(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    got = got.detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ logits
def _xent(logits, y):
    return float(F.cross_entropy(torch.tensor(np.asarray(
        logits, np.float32)).reshape(-1, logits.shape[-1]),
        torch.from_numpy(y).long().reshape(-1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("key", ["gqa", "tiny"])
def test_logits_match_jax(jax_models, jax_logits, monkeypatch, key, impl,
                          dtype):
    _, variables = jax_models[key]
    x, want = jax_logits(key, dtype)
    y = np.roll(x, -1, axis=1)
    model = _port(key, variables, attention_impl=impl,
                  dtype=getattr(torch, dtype))
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        got = model(torch.from_numpy(x).long())
    assert got.dtype == torch.float32
    assert spy.calls == (model.depth if impl == "flash" else 0)
    got = got.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() <= BF16_LOGITS * np.abs(want).max()
        np.testing.assert_allclose(_xent(got, y), _xent(want, y),
                                   rtol=BF16_LOSS)


@pytest.mark.parametrize("chunk", [0, 32])
def test_one_step_gradients_match_jax_grad(jax_models, chunk):
    jm, variables = jax_models["gqa"]
    x = _ids(11, 2, 128, 512)
    y = np.roll(x, -1, axis=1)
    if chunk:
        jm = jget_model("llama", loss_chunk=chunk, **GQA)

        def jloss(p):
            return jm.apply({"params": p}, x, targets=y)
    else:
        def jloss(p):
            logits = jm.apply({"params": p}, x)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
    want_loss, want = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    want = mt.params_from_jax(_host({"params": want}))
    model = _port("gqa", variables, attention_impl="flash", loss_chunk=chunk)
    xt, yt = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    loss = (model(xt, targets=yt) if chunk
            else F.cross_entropy(model(xt).reshape(-1, 512), yt.reshape(-1)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert model.lm_head.grad.shape == (128, 512)
    for name, p in model.named_parameters():
        _close_to_max(p.grad, want[name], 1e-4, name)


def test_chunked_loss_lands_on_the_transposed_head():
    """``lm_head.T`` is a non-contiguous view of a float32 parameter: the
    chunked loss's d(embedding) comes back in the view's shape and
    dtype, and autograd lands it on ``lm_head`` as the dense head's."""
    rng = np.random.default_rng(2)
    h = torch.tensor(rng.standard_normal((2, 64, 16)), dtype=torch.float32)
    head = torch.nn.Parameter(torch.tensor(
        0.3 * rng.standard_normal((16, 40)), dtype=torch.float32))
    t = torch.tensor(rng.integers(0, 40, (2, 64)))
    view = head.T
    assert not view.is_contiguous()
    view.retain_grad()
    chunked_lm_cross_entropy(h, view, t, 16).backward()
    assert view.grad.shape == view.shape and view.grad.dtype == torch.float32
    got = head.grad.clone()
    head.grad = None
    F.cross_entropy((h @ head).reshape(-1, 40), t.reshape(-1)).backward()
    assert got.shape == head.shape
    _close_to_max(got, head.grad, 1e-5)


# ---------------------------------------------------------------- generate
@pytest.mark.parametrize("key,p,n", [("tiny", 7, 6), ("gqa", 128, 8)])
def test_greedy_generate_matches_jax(jax_models, monkeypatch, key, p, n):
    jm, variables = jax_models[key]
    prompt = _ids(100 + p, 2, p, jm.vocab_size)
    want = np.asarray(jgenerate(jm, variables, prompt, n))
    model = _port(key, variables)
    spy = _Spy(monkeypatch)
    got = mt.generate(model, prompt, n, device="cpu")
    # The 128-token prompt's prefill takes the flash route.
    assert spy.calls == (model.depth if p == 128 else 0)
    np.testing.assert_array_equal(got.numpy(), want)
    seq = torch.from_numpy(prompt).long()
    with torch.no_grad():
        for _ in range(n):
            nxt = torch.argmax(model(seq)[:, -1], dim=-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(got.numpy(), seq.numpy())


def test_cache_holds_kv_heads_and_refuses_a_warm_prefill(jax_models):
    model = _port("tiny", jax_models["tiny"][1])
    cache = model.new_cache(3, max_len=40)
    assert len(cache.k) == len(cache.v) == 2
    assert cache.k[0].shape == (3, 2, 40, 16)  # Hkv = 2 of 4 heads
    ids = torch.from_numpy(_ids(3, 3, 9, 1024)).long()
    with torch.no_grad():
        full = model(ids)
        steps = [model(ids[:, :5], cache)]
        for t in range(5, 9):
            steps.append(model(ids[:, t:t + 1], cache))
        with pytest.raises(ValueError, match="prefill of an empty cache"):
            model(ids[:, :2], cache)
    torch.testing.assert_close(torch.cat(steps, 1), full, **TOL)
    assert cache.index.tolist() == [9, 9, 9]


# --------------------------------------------------- registry and weights
def _jax_shapes(name, **kw):
    """The port's names and shapes of ``jax.eval_shape`` of the JAX
    module's parameters (Dense kernels transposed)."""
    jm = jget_model(name, **kw)
    tree = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32),
        train=False))["params"]
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [k.key for k in path]
        mods = [f"blocks.{k[5:]}" if k.startswith("block") else k
                for k in keys[:-1]]
        last = {"kernel": "weight", "scale": "weight",
                "embedding": "weight"}.get(keys[-1], keys[-1])
        shape = tuple(leaf.shape)
        out[".".join(mods + [last])] = (shape[::-1] if keys[-1] == "kernel"
                                        else shape)
    return out


def _meta_shapes(module, name, monkeypatch, **kw):
    """A registered model's parameter shapes, built on the meta device
    (no memory: ``gpt2_large`` has 774M parameters)."""
    monkeypatch.setattr(module, "resolve_device",
                        lambda device=None: torch.device("meta"))
    model = mt.get_model(name, **kw)
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def test_full_llama_has_the_jax_leaves_and_124_7m_parameters(monkeypatch):
    got = _meta_shapes(port_llama, "llama", monkeypatch)
    assert got == _jax_shapes("llama")
    assert got["lm_head"] == (768, 32000)
    assert got["blocks.0.attn.k.weight"] == (256, 768)
    assert got["blocks.0.gate.weight"] == (2048, 768)
    assert sum(int(np.prod(s)) for s in got.values()) == 124_668_672


@pytest.mark.parametrize("name", ["gpt2_medium", "gpt2_large", "gpt2_nano"])
def test_gpt2_sizes_have_the_jax_shapes(monkeypatch, name):
    assert _meta_shapes(port_gpt2, name, monkeypatch) == _jax_shapes(name)


def test_params_from_jax_maps_every_llama_leaf(jax_models):
    variables = jax_models["tiny"][1]
    sd = mt.params_from_jax(variables)
    model = mt.get_model("llama_tiny", device="cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    p = variables["params"]
    np.testing.assert_array_equal(sd["blocks.1.attn.k.weight"].numpy(),
                                  p["block1"]["attn"]["k"]["kernel"].T)
    np.testing.assert_array_equal(sd["blocks.0.ln2.weight"].numpy(),
                                  p["block0"]["ln2"]["scale"])
    np.testing.assert_array_equal(sd["lm_head"].numpy(), p["lm_head"])
    assert not any(k.endswith("bias") for k in sd)


def test_init_model_draws_every_leaf_in_the_jax_shapes():
    a = mt.init_model("llama_tiny", seed=3, device="cpu").state_dict()
    b = mt.init_model("llama_tiny", seed=3, device="cpu").state_dict()
    c = mt.init_model("llama_tiny", seed=4, device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in a.items()} == _jax_shapes(
        "llama_tiny")
    assert all(torch.equal(a[k], b[k]) for k in a)
    for k, v in a.items():
        if k.endswith(("ln1.weight", "ln2.weight", "ln_final.weight")):
            assert torch.equal(v, torch.ones_like(v)), k
        else:
            assert not torch.equal(v, c[k]), k
    assert abs(float(a["lm_head"].std()) - 0.02) < 2e-3


def test_refusals_name_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        mt.get_model("llama_tiny", device="cpu", mesh=object())
    assert mt.get_model("llama_tiny", device="cpu", remat=True,
                        remat_policy="dots").remat
    model = mt.get_model("llama_tiny", device="cpu")
    for make in (lambda: mt.SlotDecodeEngine(model, device="cpu"),
                 lambda: mt.Server(model, device="cpu"),
                 lambda: mt.Server(model, kv_page_size=16, device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make()


# ------------------------------------------------------------------- fit
FIT_KW = dict(epochs=1, batch_size=8, metric=None, optimizer="adamw",
              lr=0.01, seed=3)


def _port_trainer(tmp, params, label, **kw):
    ds = mt.SyntheticTokens(size=32, seq_len=32, vocab_size=1024, seed=0)
    model = mt.get_model("llama_tiny", device="cpu",
                         loss_chunk=kw.pop("loss_chunk", 0))
    model.load_state_dict(params)
    return mt.Trainer(model, datasets=(ds, ds),
                      device=kw.pop("device", "cpu"), model_dir=str(tmp / label), **dict(FIT_KW, **kw))


def _port_fit(tmp, params, label, **kw):
    tr = _port_trainer(tmp, params, label, **kw)
    tr.fit()
    return tr


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The JAX trainer's dense fit of ``llama_tiny`` (test_llama.py's
    setup, one epoch), and the port's from the same initial weights."""
    tmp = tmp_path_factory.mktemp("llama_fit")
    ds = JTokens(size=32, seq_len=32, vocab_size=1024, seed=0)
    jtr = J.Trainer(jget_model("llama_tiny"), datasets=(ds, ds),
                    backend="cpu", loader="python", model_dir=str(tmp / "j"),
                    **FIT_KW)
    params = mt.params_from_jax(_host({"params": jtr.state.params}))
    jtr.fit()
    return tmp, jtr, params, {
        "dense": _port_fit(tmp, params, "dense"),
        "chunked": _port_fit(tmp, params, "chunked", loss_chunk=8),
        "k2": _port_fit(tmp, params, "k2", steps_per_execution=2),
    }


@pytest.mark.parametrize("run", ["dense", "chunked"])
def test_fit_matches_the_jax_trainer(fits, run):
    _, jtr, _, ports = fits
    tr = ports[run]
    assert tr._takes_targets == (run == "chunked")
    assert all(np.isfinite(jtr.train_losses))
    np.testing.assert_allclose(tr.train_losses, jtr.train_losses, rtol=1e-4)
    np.testing.assert_allclose(tr.history["val_loss"],
                               jtr.history["val_loss"], rtol=1e-4)
    assert tr.state.step == int(jtr.state.step) == 4


def test_fit_at_k2_is_bitwise_the_k1_run(fits):
    _, _, _, ports = fits
    want = ports["dense"].model.state_dict()
    for name, w in ports["k2"].model.state_dict().items():
        assert w.equal(want[name]), name


def test_bf16_and_sharded_fits_stay_near_fp32(fits):
    """The bf16 policy (one cast at the top of the microbatch; the head
    and logits float32) within the bf16 loss bar of the float32 run, and
    two replicas under ``dp_update="sharded"`` (K4/K5's plain versions)
    within rtol 1e-5 of one replica."""
    tmp, _, params, ports = fits
    bf16 = _port_fit(tmp, params, "bf16", precision="bf16")
    assert bf16.model.lm_head.dtype == torch.float32
    np.testing.assert_allclose(bf16.train_losses, ports["dense"].train_losses,
                               rtol=BF16_LOSS)
    kw = dict(optimizer="adam", lr=1e-3)
    one = _port_fit(tmp, params, "one", **kw)
    two = _port_fit(tmp, params, "two", is_parallel=True,
                    device=["cpu"] * 2, dp_update="sharded", **kw)
    assert two.fused_adam
    np.testing.assert_allclose(two.train_losses, one.train_losses, rtol=1e-5)


def test_a_jax_train_state_continues_in_the_port(fits):
    """``state_from_jax`` of the JAX trainer's state after its fit: the
    port's next two steps give the JAX trainer's losses."""
    tmp, jtr, params, _ = fits
    tr = _port_trainer(tmp, params, "carried")
    load_state_tree(tr.state, tr.model, state_from_jax(_host(jtr.state)))
    ds = mt.SyntheticTokens(size=32, seq_len=32, vocab_size=1024, seed=5)
    for i in range(2):
        x, y = ds.data[8 * i:8 * i + 8], ds.targets[8 * i:8 * i + 8]
        jtr.state, jloss = jtr._train_step(jtr.state, x, y,
                                           jnp.float32(1.0))[:2]
        loss = tr._train_step(torch.from_numpy(x).long(),
                              torch.from_numpy(y).long(), 1.0)[0]
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_a_port_checkpoint_of_llama_verifies_in_the_jax_reader(fits):
    """The port's format-v2 checkpoint of a Llama fit verifies in the JAX
    package's reader; its parameter leaves are the model's own, no RoPE
    table among them."""
    tmp, _, _, ports = fits
    path = os.path.join(str(tmp / "dense"), "checkpoints", "checkpoint_1")
    jckpt.verify_checkpoint(path)
    assert jckpt.latest_valid_checkpoint(os.path.dirname(path)) == path
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    params = {leaf["path"][1] for leaf in manifest["leaves"]
              if leaf["path"][0] == "params"}
    assert params == set(ports["dense"].model.state_dict())

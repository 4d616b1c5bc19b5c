"""Port parity for bf16 serving: a GPT-2 built with ``precision="bf16"``
served by the port's ``Server`` against the JAX package's ``Server`` on
the CPU, plus the pins the reference makes within itself, made within
the port.

* Greedy tokens from the port's ``Server`` equal the JAX ``Server``'s, in
  the contiguous mode, the paged mode with ``paged_kernel=True`` and the
  paged int8 mode (``quant_int8=True``), over the prompts of
  ``tests/test_torch_serving.py``.  The two packages' bf16 matmuls round
  their f32 sums in other orders, so a greedy step whose top two logits
  lie within the bf16 bar may go either way: where a request's tokens
  part, the step must be such a near-tie of the JAX logits (teacher-
  forced along the JAX sequence); the tokens before it must be equal.
* Teacher-forced logits along each JAX sequence agree within 3e-2 of the
  largest logit (the bf16 bar of ``tests/test_torch_models.py``), through
  the full forward and, for the int8 mode, the int8 full forward.
* Within the port, in bf16: the caches and page pools are bf16; paged ==
  contiguous bitwise, ``paged_kernel`` on == off (both take the plain
  versions on the CPU) and preemption under page pressure changes no
  token; a sampled request equals the port's ``generate()``; the int8
  decode step feeds K7 bf16 activations.

The weights cross through ``convert.params_from_jax``; the int8
collection is built from the fp32 weights in both packages.
"""

import jax
import numpy as np
import pytest
import torch

from ml_trainer_tpu.models import get_model as j_get_model
from ml_trainer_tpu.ops.kernels.int8_matmul import (
    quantize_tree as j_quantize_tree,
)
from ml_trainer_tpu.serving import Server as JServer
from ml_trainer_tpu_torch import (
    generate,
    get_model,
    params_from_jax,
    quantize_tree,
)
from ml_trainer_tpu_torch.serving import Server, SlotDecodeEngine

MAX_LEN = 64
NEW_TOKENS = 10
BAR = 3e-2  # of the largest logit: the bf16 bar of tests/test_torch_models.py
MODES = {
    "contiguous": dict(),
    "paged_kernel": dict(kv_page_size=16, paged_kernel=True),
    "int8": dict(kv_page_size=16, paged_kernel=True, quant_int8=True),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: small ops otherwise wait on all cores'
    threads, which the suite's other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    j_model = j_get_model("gpt2_tiny", max_len=MAX_LEN, precision="bf16")
    variables = j_model.init({"params": jax.random.PRNGKey(1)},
                             np.zeros((1, 8), np.int32), train=False)
    t_model = get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu",
                        precision="bf16")
    t_model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, variables["params"])))
    assert t_model.dtype == torch.bfloat16
    return j_model, variables, t_model


def _prompts():
    """The prompts of tests/test_torch_serving.py."""
    rng = np.random.default_rng(0)
    out = [rng.integers(0, 1024, n).astype(np.int32) for n in (5, 40, 12, 7)]
    out.append(np.concatenate([out[1][:32],
                               rng.integers(0, 1024, 9).astype(np.int32)]))
    return out


def _serve(server, prompts, n=NEW_TOKENS, **kw):
    streams = [server.submit(p, n, **kw) for p in prompts]
    return [np.asarray(s.result(timeout=300)) for s in streams], streams


@pytest.fixture(scope="module")
def jax_served(models):
    """Each mode's greedy tokens from the JAX ``Server``."""
    j_model, variables, _ = models
    out = {}
    for mode, kw in MODES.items():
        with JServer(j_model, variables, max_batch=4, **kw) as js:
            out[mode], _ = _serve(js, _prompts())
    return out


def _jax_logits(models, seq, quant: bool) -> np.ndarray:
    """Teacher-forced JAX logits [S, V] (f32) along ``seq``; with ``quant``
    the int8 full forward."""
    j_model, variables, _ = models
    if quant:
        j_model = j_model.clone(quant_int8=True)
        variables = {"params": variables["params"],
                     "quant": j_quantize_tree(variables["params"])}
    return np.asarray(j_model.apply(variables, seq[None], train=False),
                      np.float32)[0]


def _port_logits(models, seq, quant: bool) -> np.ndarray:
    t_model = models[2]
    with torch.no_grad():
        logits = t_model(torch.from_numpy(seq[None].astype(np.int64)),
                         quant=quantize_tree(t_model) if quant else None)
    return logits.float().numpy()[0]


@pytest.mark.parametrize("mode", list(MODES))
def test_bf16_server_matches_jax_server(models, jax_served, mode):
    _, _, t_model = models
    prompts = _prompts()
    with Server(t_model, max_batch=4, device="cpu", **MODES[mode]) as ts:
        got, streams = _serve(ts, prompts)
    assert streams[-1].request.prefix_hit_tokens == (0 if mode == "contiguous"
                                                     else 32)
    quant = mode == "int8"
    for p, a, want in zip(prompts, got, jax_served[mode]):
        n = len(p)
        # Step j's token comes from the prefill (j == 0) or from a decode
        # step, the int8 program in the int8 mode.
        plain = _jax_logits(models, want, quant=False)
        step_logits = _jax_logits(models, want, quant=True) if quant else plain
        for lj, q in ((plain, False), (step_logits, quant)):
            lt = _port_logits(models, want, q)
            peak = np.abs(lj).max()
            assert np.abs(lt - lj).max() <= BAR * peak
        diff = np.flatnonzero(a != want)
        if diff.size:
            j = int(diff[0])
            assert j >= n, "the prompt came back changed"
            logits = (plain if j == n else step_logits)[j - 1]
            top2 = np.sort(logits)[-2:]
            gap = top2[1] - top2[0]
            assert gap <= BAR * np.abs(logits).max(), (
                f"{mode}: request of {n} tokens parts from the JAX tokens "
                f"at step {j - n} where JAX's top-2 gap is {gap}")


def test_bf16_caches_and_pools_are_bf16(models):
    _, _, t_model = models
    assert all(t.dtype == torch.bfloat16 for t in t_model.new_cache(2).k)
    paged = t_model.new_paged_cache(2, 9, 16, paged_kernel=True)
    assert all(t.dtype == torch.bfloat16 for t in paged.k + paged.v)
    for kw in MODES.values():
        engine = SlotDecodeEngine(t_model, max_batch=2, device="cpu", **kw)
        assert {t.dtype for t in engine.cache.k + engine.cache.v} == {
            torch.bfloat16}
    # The int8 collection is built from the float32 weights, as in JAX.
    quant = quantize_tree(t_model)["blocks"]["0"]["attn"]
    assert quant["qkv_scale"].dtype == torch.float32
    assert quant["qkv_b"].dtype == torch.float32


def test_bf16_paged_equals_contiguous_with_sampling(models):
    """Contiguous, paged with the paged-attention wrapper, paged with the
    gather path at page 8: the same bytes, one request sampled."""
    _, _, t_model = models
    prompts = _prompts()
    outs = []
    for kw in (dict(), dict(kv_page_size=16, paged_kernel=True),
               dict(kv_page_size=16, paged_kernel=False),
               dict(kv_page_size=8)):
        with Server(t_model, max_batch=3, device="cpu", **kw) as s:
            streams = [s.submit(p, 9, temperature=0.8 if i == 2 else 0.0,
                                rng=7) for i, p in enumerate(prompts)]
            outs.append([np.asarray(st.result(timeout=300))
                         for st in streams])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)


def test_bf16_int8_paged_kernel_on_equals_off(models):
    _, _, t_model = models
    outs = []
    for paged_kernel in (True, False):
        with Server(t_model, max_batch=4, kv_page_size=16, quant_int8=True,
                    paged_kernel=paged_kernel, device="cpu") as s:
            outs.append(_serve(s, _prompts())[0])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_bf16_sampled_server_matches_generate(models):
    _, _, t_model = models
    prompts = _prompts()[:3]
    with Server(t_model, max_batch=4, kv_page_size=16, paged_kernel=True,
                device="cpu") as s:
        streams = [s.submit(p, 12, temperature=1.1, rng=100 + i)
                   for i, p in enumerate(prompts)]
        got = [np.asarray(st.result(timeout=300)) for st in streams]
    for i, p in enumerate(prompts):
        want = generate(t_model, p[None], 12, temperature=1.1, rng=100 + i,
                        device="cpu").numpy()[0]
        np.testing.assert_array_equal(got[i], want)


def test_bf16_preemption_changes_no_token(models):
    """Preempt and requeue under page pressure (the resumed request
    prefills its prompt and tokens again, at bf16) changes no token."""
    _, _, t_model = models
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 1024, n).astype(np.int32) for n in (20, 18, 22)]
    with Server(t_model, max_batch=3, device="cpu") as s:
        want, _ = _serve(s, prompts, n=30)
    with Server(t_model, max_batch=3, kv_page_size=8, kv_pages=9,
                paged_kernel=True, quant_int8=False, device="cpu") as s:
        got, _ = _serve(s, prompts, n=30)
        snap = s.metrics.snapshot()
    assert snap["preemptions_total"] > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_bf16_int8_decode_feeds_k7_bf16_activations(models, monkeypatch):
    """Every int8 projection of the decode step gets a bf16 x and gives a
    bf16 y; the prefill reads no collection."""
    import ml_trainer_tpu_torch.models.layers as layers

    _, _, t_model = models
    seen = []
    real = layers.int8_matmul

    def spy(x, *args, **kw):
        y = real(x, *args, **kw)
        seen.append((x.dtype, y.dtype, x.shape[-2]))
        return y

    monkeypatch.setattr(layers, "int8_matmul", spy)
    with Server(t_model, max_batch=2, kv_page_size=16, paged_kernel=True,
                quant_int8=True, device="cpu") as s:
        s.complete(np.arange(20), 4, timeout=120)
    assert seen and {(a, b) for a, b, _ in seen} == {
        (torch.bfloat16, torch.bfloat16)}
    assert {s for _, _, s in seen} == {1}
    assert len(seen) % (4 * t_model.depth) == 0

"""Port parity: speculative decoding (``ml_trainer_tpu_torch/speculative.py``
and the serving engine's ``spec_k``) against the JAX package on the CPU.

The same weights go into both packages through ``params_from_jax``
(``gpt2_tiny``, and a one-block 64-wide draft model of the same
vocabulary).  Bars:

* the windowed append on the contiguous cache at an unaligned offset and
  at per-row distinct offsets: the window's logits and the cache rows
  within 1e-5 of the JAX layer's, nothing written past the window;
* ``NgramDrafter``'s drafts equal to the JAX class's on 200 seeded
  histories;
* greedy ``speculative_generate`` (n-gram and draft model, k in
  {1, 2, 4, 7}), its EOS tail and the served mid-stream joins and slot
  reuse (contiguous and paged): tokens equal to JAX ``generate``'s; the
  greedy stats equal to JAX ``speculative_generate``'s;
* the accept-and-resample rule: the committed token's frequencies over
  20,000 seeded draws on a 16-token vocabulary within 0.02 of the target
  softmax;
* every ValueError the JAX package raises here.

Sampled speculative output is pinned within the port (same seeds, same
tokens): ``jax.random`` draws cannot be reproduced in PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ml_trainer_tpu_torch as mt
from ml_trainer_tpu.generate import _cache_shapes
from ml_trainer_tpu.generate import generate as jgenerate
from ml_trainer_tpu.models import get_model as jget_model
from ml_trainer_tpu.speculative import NgramDrafter as JNgramDrafter
from ml_trainer_tpu.speculative import (
    speculative_generate as jspeculative_generate,
)
from ml_trainer_tpu_torch.serving import Server, SlotDecodeEngine
from ml_trainer_tpu_torch.speculative import (
    DraftModelDrafter,
    NgramDrafter,
    speculative_generate,
    verify,
)

MAX_LEN = 128
TOL = 1e-5
DRAFT = dict(depth=1, embed_dim=64, num_heads=2)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(seed, **kw):
    j_model = jget_model("gpt2_tiny", max_len=MAX_LEN, **kw)
    variables = j_model.init({"params": jax.random.PRNGKey(seed)},
                             np.zeros((1, 8), np.int32), train=False)
    t_model = mt.get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu", **kw)
    t_model.load_state_dict(mt.params_from_jax(
        jax.tree.map(np.asarray, variables["params"])))
    return j_model, variables, t_model.eval()


@pytest.fixture(scope="module")
def models():
    return _pair(0)


@pytest.fixture(scope="module")
def draft():
    return _pair(1, **DRAFT)


def _prompt(seed, b=2, p=7):
    return np.random.default_rng(seed).integers(0, 1024, (b, p)).astype(
        np.int32)


def _jax_greedy(models, ids, n, **kw):
    j_model, variables, _ = models
    return np.asarray(jgenerate(j_model, variables, jnp.asarray(ids), n,
                                **kw))


# -- the windowed append on the contiguous cache --------------------------

def _jax_window(j_model, variables, caches, window):
    """The JAX layer's window over per-row caches: the batch-1 caches
    stacked, their index leaves widened to per-row [B] vectors."""
    dm = j_model.clone(decode=True)
    cache = jax.tree.map(
        lambda *ls: (jnp.concatenate(ls) if ls[0].ndim
                     else jnp.asarray(ls, jnp.int32)), *caches)
    logits, mut = dm.apply({"params": variables["params"], "cache": cache},
                           jnp.asarray(window), train=False,
                           mutable=["cache"])
    return np.asarray(logits), mut["cache"]


def _jax_prefill(j_model, variables, row):
    dm = j_model.clone(decode=True)
    shapes = _cache_shapes(dm, 1, jnp.int32)
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    _, mut = dm.apply({"params": variables["params"], "cache": cache},
                      jnp.asarray(row)[None], train=False, mutable=["cache"])
    return mut["cache"]


def _port_window(t_model, rows, window):
    """The port's window: each row prefilled at batch 1 into its slot of
    a [B] contiguous cache, then the windowed call."""
    cache = t_model.new_cache(len(rows))
    with torch.no_grad():
        for b, row in enumerate(rows):
            c1 = t_model.new_cache(1)
            t_model(torch.as_tensor(row[None], dtype=torch.long), c1)
            for layer in range(t_model.depth):
                cache.k[layer][b] = c1.k[layer][0]
                cache.v[layer][b] = c1.v[layer][0]
            cache.index[b] = len(row)
        cache.windowed = True
        logits = t_model(torch.as_tensor(window, dtype=torch.long), cache)
    return logits.numpy(), cache


def _check_window(models, rows, window):
    j_model, variables, t_model = models
    want, j_cache = _jax_window(
        j_model, variables,
        [_jax_prefill(j_model, variables, r) for r in rows], window)
    got, cache = _port_window(t_model, rows, window)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    s = window.shape[1]
    for layer in range(t_model.depth):
        leaf = j_cache[f"block{layer}"]["attn"]
        for name, port in (("cached_key", cache.k), ("cached_value", cache.v)):
            np.testing.assert_allclose(port[layer].numpy(),
                                       np.asarray(leaf[name]), atol=TOL,
                                       rtol=TOL)
            for b, row in enumerate(rows):
                end = len(row) + s
                assert np.abs(port[layer][b, :, len(row):end].numpy()).max() > 0
                assert not port[layer][b, :, end:].any()
    np.testing.assert_array_equal(cache.index.numpy(),
                                  [len(r) + s for r in rows])


def test_windowed_append_at_unaligned_offset(models):
    ids = _prompt(0, b=2, p=11)
    _check_window(models, [ids[0, :7], ids[1, :7]], ids[:, 7:11])


def test_windowed_append_per_row_distinct_offsets(models):
    rng = np.random.default_rng(3)
    row0, row1 = (rng.integers(0, 1024, n).astype(np.int32) for n in (9, 7))
    _check_window(models, [row0[:5], row1[:3]],
                  np.stack([row0[5:9], row1[3:7]]))


def test_warm_cache_prefill_stays_poisoned(models):
    """Without the windowed flag, a multi-token call on a warm cache is
    still the NaN-poisoned prefill of the JAX layer."""
    _, _, t_model = models
    cache = t_model.new_cache(1)
    ids = torch.as_tensor(_prompt(4, b=1, p=8), dtype=torch.long)
    with torch.no_grad():
        t_model(ids[:, :4], cache)
        assert torch.isnan(t_model(ids[:, 4:], cache)).all()


# -- the n-gram drafter --------------------------------------------------

def test_ngram_drafts_equal_jax_on_seeded_histories():
    rng = np.random.default_rng(7)
    for i in range(200):
        k, n = int(rng.integers(1, 8)), int(rng.integers(1, 5))
        min_n = int(rng.integers(1, n + 1))
        hist = rng.integers(0, int(rng.integers(2, 9)),
                            int(rng.integers(1, 40))).astype(np.int32)
        np.testing.assert_array_equal(
            NgramDrafter(k, n, min_n).draft_one(hist),
            JNgramDrafter(k, n, min_n).draft_one(hist), err_msg=str(i))


def test_ngram_lookup_rules():
    d = NgramDrafter(k=3, n=2)
    np.testing.assert_array_equal(d.draft_one([7, 8, 9, 1, 2, 3, 7, 8]),
                                  [9, 1, 2])
    assert d.draft_one([5, 6, 1, 5, 6, 2, 5, 6])[0] == 2  # most recent
    np.testing.assert_array_equal(d.draft_one([1, 2, 3, 4]), [4, 4, 4])
    np.testing.assert_array_equal(d.draft_one([5, 4, 5, 4]), [5, 4, 4])


# -- greedy output and stats ----------------------------------------------

@pytest.mark.parametrize("source", ["ngram", "draft"])
@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_greedy_spec_equals_jax_generate(models, draft, source, k):
    ids = _prompt(1, b=3)
    want = _jax_greedy(models, ids, 32)
    drafter = "ngram" if source == "ngram" else draft[2]
    got = speculative_generate(models[2], ids, 32, draft_k=k,
                               drafter=drafter, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_routes_spec_k(models, draft):
    ids = _prompt(4)
    want = _jax_greedy(models, ids, 24)
    got = mt.generate(models[2], ids, 24, spec_k=4, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    got = mt.generate(models[2], ids, 24, spec_k=3,
                      drafter=DraftModelDrafter(draft[2]), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("source", ["ngram", "draft"])
def test_greedy_stats_equal_jax(models, draft, source):
    j_model, variables, t_model = models
    ids = _prompt(6)
    kw = {} if source == "ngram" else dict(drafter=draft[0],
                                           draft_variables=draft[1])
    j_out, j_stats = jspeculative_generate(
        j_model, variables, jnp.asarray(ids), 30, draft_k=4,
        return_stats=True, **kw)
    out, stats = speculative_generate(
        t_model, ids, 30, draft_k=4, return_stats=True, device="cpu",
        drafter="ngram" if source == "ngram" else draft[2])
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    for key in ("draft_k", "verify_steps", "accept_hist", "drafted_tokens",
                "accepted_tokens"):
        assert stats[key] == j_stats[key], key
    assert stats["acceptance_rate"] == pytest.approx(j_stats["acceptance_rate"])
    assert stats["tokens_per_step"] == pytest.approx(j_stats["tokens_per_step"])


def test_spec_eos_equals_jax_generate(models):
    ids = _prompt(5)
    base = _jax_greedy(models, ids, 16)
    eos = int(base[0, ids.shape[1] + 2])
    want = _jax_greedy(models, ids, 16, eos_token_id=eos, pad_token_id=99)
    got = speculative_generate(models[2], ids, 16, draft_k=4,
                               eos_token_id=eos, pad_token_id=99,
                               device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_spec_is_seeded(models):
    ids = _prompt(7)
    runs = [speculative_generate(models[2], ids, 20, draft_k=4,
                                 temperature=0.8, rng=5, device="cpu")
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (2, 27) and 0 <= int(runs[0].min())
    assert int(runs[0].max()) < 1024
    np.testing.assert_array_equal(runs[0][:, :7].numpy(), ids)
    other = speculative_generate(models[2], ids, 20, draft_k=4,
                                 temperature=0.8, rng=6, device="cpu")
    assert not torch.equal(runs[0], other)


def test_accept_and_resample_follows_the_target_softmax():
    """One verify step (K = 1) per row over 20,000 rows, each drafting a
    token of the 16-token vocabulary: the committed token (the draft when
    accepted, else the residual draw) must follow the target softmax."""
    n, vocab, temp = 20_000, 16, 0.7
    logits = torch.as_tensor(
        np.random.default_rng(0).normal(0, 1.5, vocab), dtype=torch.float32)
    window = torch.stack([torch.zeros(n, dtype=torch.long),
                          torch.arange(n) % vocab], dim=1)
    acc, nxt = verify(logits.expand(n, 2, vocab), window, [temp] * n,
                      list(range(n)), [3] * n)
    committed = np.where(acc >= 1, window[:, 1].numpy(), nxt)
    freq = np.bincount(committed, minlength=vocab) / n
    want = torch.softmax(logits / temp, -1).numpy()
    assert np.abs(freq - want).max() <= 0.02
    assert 0 < acc.mean() < 1


# -- serving --------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_serving_spec_mid_stream_join_equals_jax(models, paged):
    prompts = [np.random.default_rng(20 + i).integers(0, 1024, n).astype(
        np.int32) for i, n in enumerate((5, 3, 6))]
    budgets = (24, 9, 7)
    want = [_jax_greedy(models, p[None], n)[0]
            for p, n in zip(prompts, budgets)]
    kw = dict(kv_page_size=16) if paged else {}
    with Server(models[2], max_batch=3, spec_k=4, device="cpu", **kw) as s:
        first = s.submit(prompts[0], budgets[0])
        next(iter(first))  # decoding when the others join
        streams = [first] + [s.submit(p, n) for p, n in
                             zip(prompts[1:], budgets[1:])]
        got = [st.result(timeout=120) for st in streams]
        snap = s.metrics.snapshot()
        health = s.health()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert snap["spec_steps_total"] > 0 and snap["spec_draft_k"] == 4
    assert snap["spec_drafted_tokens"] == 4 * sum(
        snap["spec_accept_hist"].values())
    assert 0.0 <= snap["spec_acceptance_rate"] <= 1.0
    assert snap["spec_tokens_per_step"] >= 1.0
    assert health["ok"] and s.engine.spec_k == 4
    assert s.engine.prefill_chunk == 0
    req = streams[0].request
    assert req.spec_steps > 0 and req.spec_accepted_tokens >= 0


@pytest.mark.parametrize("paged", [False, True])
def test_serving_spec_draft_model_and_slot_reuse(models, draft, paged):
    prompts = [np.random.default_rng(30 + i).integers(0, 1024, 3 + i).astype(
        np.int32) for i in range(5)]
    want = [_jax_greedy(models, p[None], 8 + i)[0]
            for i, p in enumerate(prompts)]
    kw = dict(kv_page_size=8) if paged else {}
    with Server(models[2], max_batch=2, spec_k=3, drafter=draft[2],
                device="cpu", **kw) as s:
        got = [st.result(timeout=120) for st in
               [s.submit(p, 8 + i) for i, p in enumerate(prompts)]]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_serving_spec_sampled_is_seeded(models):
    p = _prompt(8, b=1)[0]
    outs = []
    for _ in range(2):
        with Server(models[2], max_batch=2, spec_k=4, device="cpu") as s:
            outs.append(s.complete(p, 12, temperature=0.9, rng=3,
                                   timeout=120))
    np.testing.assert_array_equal(outs[0], outs[1])


# -- refusals -------------------------------------------------------------

def test_spec_value_errors(models, draft):
    _, _, t_model = models
    ids = _prompt(8)
    with pytest.raises(ValueError, match="draft_k"):
        speculative_generate(t_model, ids, 8, draft_k=0, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        speculative_generate(t_model, ids, MAX_LEN, draft_k=4, device="cpu")
    with pytest.raises(ValueError, match="drafter"):
        speculative_generate(t_model, ids, 8, draft_k=4, drafter="oracle",
                             device="cpu")
    with pytest.raises(ValueError, match="drafter.k"):
        speculative_generate(t_model, ids, 8, draft_k=4,
                             drafter=NgramDrafter(k=2), device="cpu")
    wrong = mt.get_model("gpt2_tiny", max_len=MAX_LEN, vocab_size=512,
                         device="cpu", **DRAFT)
    with pytest.raises(ValueError, match="vocab_size"):
        speculative_generate(t_model, ids, 8, draft_k=4, drafter=wrong,
                             device="cpu")
    short = mt.get_model("gpt2_tiny", max_len=16, device="cpu", **DRAFT)
    with pytest.raises(ValueError, match="too short"):
        speculative_generate(t_model, ids, 12, draft_k=4, drafter=short,
                             device="cpu")
    llama = mt.get_model("llama_tiny", device="cpu")
    with pytest.raises(ValueError, match="windowed cache"):
        speculative_generate(llama, ids, 8, draft_k=4, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        mt.generate(t_model, ids, 8, spec_k=4, top_k=5, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        mt.generate(t_model, ids, 8, spec_k=4, top_p=0.9, device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        NgramDrafter(k=0)
    with pytest.raises(ValueError, match="min_n"):
        NgramDrafter(k=2, n=2, min_n=3)
    for spec_k in (-1, MAX_LEN):
        with pytest.raises(ValueError, match="spec_k must be in"):
            SlotDecodeEngine(t_model, spec_k=spec_k, device="cpu")
    with pytest.raises(ValueError, match="adapters with spec_k"):
        SlotDecodeEngine(t_model, spec_k=2, adapters={"rank": 4},
                         device="cpu")
    with pytest.raises(ValueError, match="draft model max_len"):
        SlotDecodeEngine(t_model, spec_k=2, drafter=short, device="cpu")
    with pytest.raises(ValueError, match="drafter must be"):
        SlotDecodeEngine(t_model, spec_k=2, drafter=3, device="cpu")
    with Server(t_model, max_batch=1, spec_k=4, device="cpu") as s:
        with pytest.raises(ValueError, match="spec_k"):
            s.submit(ids[0], MAX_LEN - 4)


def test_registry_draft_pairing():
    target = mt.get_model("gpt2_mini", device="cpu")
    draft = mt.suggested_draft("gpt2_mini", device="cpu")
    assert draft.vocab_size == target.vocab_size
    assert draft.max_len >= target.max_len
    DraftModelDrafter(draft).check_compatible(target)
    from ml_trainer_tpu.models.registry import DRAFT_PAIRS as J_PAIRS

    assert mt.models.DRAFT_PAIRS == J_PAIRS
    with pytest.raises(ValueError, match="n-gram"):
        mt.suggested_draft("bert_tiny")

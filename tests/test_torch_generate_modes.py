"""Port parity: ``generate()``'s filters, ``beam_search`` and
``generate_ragged`` against the JAX package on the CPU (``gpt2_tiny``
and ``llama_tiny``, the same weights through ``params_from_jax``).

* ``top_k=1`` at temperature 1.5 and ``top_p=1e-6`` at temperature 0.05
  leave one token to draw: equal to JAX greedy ``generate``;
  ``top_p=1.0`` equals the port's unfiltered sampling at the same seed.
* ``filter_logits`` equal to a numpy transcription of the JAX sampler's
  filter (a closure inside its ``_build``), ties at the k-th logit
  included.
* ``beam_search`` tokens equal to JAX ``beam_search`` for ``num_beams``
  in {1, 2, 4} on both families; ``generate_ragged`` greedy equal to JAX
  ``generate_ragged``, in prompt order.
* The ValueErrors of ``top_k``, ``top_p`` and ``num_beams``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ml_trainer_tpu_torch as mt
from ml_trainer_tpu.generate import beam_search as jbeam_search
from ml_trainer_tpu.generate import generate as jgenerate
from ml_trainer_tpu.generate import generate_ragged as jgenerate_ragged
from ml_trainer_tpu.models import get_model as jget_model
from ml_trainer_tpu_torch.generate import filter_logits

VOCAB = 1024


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(name):
    j_model = jget_model(name, max_len=64)
    variables = j_model.init({"params": jax.random.PRNGKey(0)},
                             np.zeros((1, 8), np.int32), train=False)
    t_model = mt.get_model(name, max_len=64, device="cpu")
    t_model.load_state_dict(mt.params_from_jax(
        jax.tree.map(np.asarray, variables["params"])))
    return j_model, variables, t_model.eval()


@pytest.fixture(scope="module")
def families():
    return {name: _pair(name) for name in ("gpt2_tiny", "llama_tiny")}


def _ids(seed, b=2, p=6):
    return np.random.default_rng(seed).integers(1, VOCAB, (b, p)).astype(
        np.int32)


def _jax_greedy(pair, ids, n):
    j_model, variables, _ = pair
    return np.asarray(jgenerate(j_model, variables, jnp.asarray(ids), n))


@pytest.mark.parametrize("name", ["gpt2_tiny", "llama_tiny"])
def test_one_token_filters_equal_jax_greedy(families, name):
    pair = families[name]
    ids = _ids(0)
    want = _jax_greedy(pair, ids, 10)
    for kw in (dict(top_k=1, temperature=1.5),
               dict(top_p=1e-6, temperature=0.05)):
        got = mt.generate(pair[2], ids, 10, rng=4, device="cpu", **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))


def test_top_p_one_equals_unfiltered_sampling(families):
    t_model = families["gpt2_tiny"][2]
    ids = _ids(1)
    a = mt.generate(t_model, ids, 12, temperature=0.8, top_p=1.0, rng=7,
                    device="cpu")
    b = mt.generate(t_model, ids, 12, temperature=0.8, rng=7, device="cpu")
    assert torch.equal(a, b)


def test_top_k_top_p_sampling_is_seeded_and_filtered(families):
    t_model = families["gpt2_tiny"][2]
    ids = _ids(2)
    runs = [mt.generate(t_model, ids, 8, temperature=0.8, top_k=50,
                        top_p=0.95, rng=7, device="cpu") for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    # Every sampled token is among the top 5 of its step's logits.
    out = mt.generate(t_model, ids, 8, temperature=1.0, top_k=5, rng=3,
                      device="cpu")
    with torch.no_grad():
        logits = t_model(out[:, :-1])[:, ids.shape[1] - 1:]
    top5 = logits.topk(5, dim=-1).indices
    assert (top5 == out[:, ids.shape[1]:, None]).any(-1).all()


def _np_filter(last, temperature, top_k, top_p):
    """``ml_trainer_tpu/generate.py``'s filter (``_build``'s ``sample``)
    in numpy float32."""
    last = last.astype(np.float32)
    if top_k is not None:
        kth = np.sort(last, axis=-1)[:, ::-1][:, top_k - 1:top_k]
        last = np.where(last < kth, -np.inf, last).astype(np.float32)
    if top_p is not None:
        sorted_logits = np.sort(last, axis=-1)[:, ::-1]
        z = sorted_logits / np.float32(temperature)
        e = np.exp(z - z.max(axis=-1, keepdims=True))
        probs = e / e.sum(axis=-1, keepdims=True)
        mass_before = np.cumsum(probs, axis=-1) - probs
        keep = mass_before < top_p
        cutoff = np.min(np.where(keep, sorted_logits, np.inf), axis=-1,
                        keepdims=True)
        last = np.where(last < cutoff, -np.inf, last).astype(np.float32)
    return last


@pytest.mark.parametrize("top_k,top_p,ties", [
    (5, None, False), (None, 0.9, False), (40, 0.8, False),
    (4, None, True), (6, 0.95, True), (None, 0.5, True),
])
def test_filter_equals_numpy_transcription(top_k, top_p, ties):
    rng = np.random.default_rng(11)
    if ties:  # few distinct values: ties at the k-th logit
        last = rng.integers(0, 6, (4, 64)).astype(np.float32) / 2
    else:
        last = rng.normal(0, 2, (4, 64)).astype(np.float32)
    got = filter_logits(torch.as_tensor(last), 0.7, top_k, top_p).numpy()
    want = _np_filter(last, 0.7, top_k, top_p)
    np.testing.assert_array_equal(got, want)
    if ties and top_k:
        assert (np.isfinite(got).sum(-1) > top_k).any()


@pytest.mark.parametrize("name", ["gpt2_tiny", "llama_tiny"])
@pytest.mark.parametrize("num_beams", [1, 2, 4])
def test_beam_search_equals_jax(families, name, num_beams):
    j_model, variables, t_model = families[name]
    ids = _ids(3)
    want = np.asarray(jbeam_search(j_model, variables, jnp.asarray(ids), 8,
                                   num_beams=num_beams))
    got = mt.beam_search(t_model, ids, 8, num_beams=num_beams, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    if num_beams == 1:
        np.testing.assert_array_equal(got.numpy(),
                                      _jax_greedy(families[name], ids, 8))


def test_generate_ragged_equals_jax(families):
    j_model, variables, t_model = families["gpt2_tiny"]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, VOCAB, n).astype(np.int32)
               for n in (5, 9, 5, 3, 9, 5)]
    want = jgenerate_ragged(j_model, variables, prompts, 6)
    got = mt.generate_ragged(t_model, prompts, 6, device="cpu")
    assert len(got) == len(prompts)
    for p, a, b in zip(prompts, got, want):
        assert a.shape == (len(p) + 6,)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # Sampled: each bucket draws with its own folded seed.
    s1 = mt.generate_ragged(t_model, prompts, 6, temperature=0.9, rng=2,
                            device="cpu")
    s2 = mt.generate_ragged(t_model, prompts, 6, temperature=0.9, rng=2,
                            device="cpu")
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)


def test_mode_value_errors(families):
    t_model = families["gpt2_tiny"][2]
    ids = _ids(4)
    for top_k in (0, VOCAB + 1):
        with pytest.raises(ValueError, match="top_k must be"):
            mt.generate(t_model, ids, 4, temperature=1.0, top_k=top_k,
                        device="cpu")
    for top_p in (0.0, 1.5):
        with pytest.raises(ValueError, match="top_p must be"):
            mt.generate(t_model, ids, 4, temperature=1.0, top_p=top_p,
                        device="cpu")
    for beams in (0, VOCAB + 1):
        with pytest.raises(ValueError, match="num_beams must be"):
            mt.beam_search(t_model, ids, 4, num_beams=beams, device="cpu")
    with pytest.raises(ValueError, match="max_new_tokens"):
        mt.beam_search(t_model, ids, 0, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        mt.beam_search(t_model, ids, 60, device="cpu")
    with pytest.raises(ValueError, match="non-empty 1-D"):
        mt.generate_ragged(t_model, [np.array([1, 2]), np.array([])], 4,
                           device="cpu")

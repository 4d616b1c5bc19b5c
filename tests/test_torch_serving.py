"""Port parity: the port's ``Server`` against the JAX package's, on the
CPU, plus the pins the reference makes within itself, made within the
port.

* Greedy token ids from the port's paged ``Server`` (``paged_kernel=True``,
  ``device="cpu"``) equal the JAX ``Server``'s exactly, for concurrent
  requests including a prefix-cache hit.
* Within the port: paged == contiguous, preempt-and-resume under page
  pressure changes no token, and a sampled request equals the port's
  ``generate()`` for the same seed (``jax.random`` draws cannot be
  reproduced in PyTorch, so sampling is pinned within the port only).
"""

import jax
import numpy as np
import pytest

from ml_trainer_tpu.models import get_model as j_get_model
from ml_trainer_tpu.serving import Server as JServer
from ml_trainer_tpu_torch import generate, get_model, params_from_jax
from ml_trainer_tpu_torch.serving import (
    AdmissionError,
    DeadlineExceeded,
    Server,
    SlotDecodeEngine,
)

MAX_LEN = 64


@pytest.fixture(scope="module")
def models():
    j_model = j_get_model("gpt2_tiny", max_len=MAX_LEN)
    variables = j_model.init({"params": jax.random.PRNGKey(1)},
                             np.zeros((1, 8), np.int32), train=False)
    t_model = get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu")
    t_model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, variables["params"])))
    return j_model, variables, t_model


def _prompts():
    rng = np.random.default_rng(0)
    out = [rng.integers(0, 1024, n).astype(np.int32) for n in (5, 40, 12, 7)]
    # Shares its first two 16-token blocks with prompt 1: a prefix hit.
    out.append(np.concatenate([out[1][:32],
                               rng.integers(0, 1024, 9).astype(np.int32)]))
    return out


def _serve(server, prompts, n=10, **kw):
    streams = [server.submit(p, n, **kw) for p in prompts]
    return [np.asarray(s.result(timeout=300)) for s in streams], streams


def test_server_matches_jax_server(models):
    j_model, variables, t_model = models
    prompts = _prompts()
    with JServer(j_model, variables, max_batch=4, kv_page_size=16,
                 paged_kernel=True) as js:
        want, _ = _serve(js, prompts)
    with Server(t_model, max_batch=4, kv_page_size=16, paged_kernel=True,
                device="cpu") as ts:
        got, streams = _serve(ts, prompts)
        health = ts.health()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert streams[-1].request.prefix_hit_tokens == 32
    assert health["ok"] and health["metrics"]["requests_completed"] == 5
    assert health["kv_pages_total"] == 4 * (MAX_LEN // 16)


def test_paged_equals_contiguous_with_sampling(models):
    _, _, t_model = models
    prompts = _prompts()
    outs = []
    for kw in (dict(), dict(kv_page_size=16, paged_kernel=True),
               dict(kv_page_size=8)):
        with Server(t_model, max_batch=3, device="cpu", **kw) as s:
            streams = [s.submit(p, 9, temperature=0.8 if i == 2 else 0.0,
                                rng=7) for i, p in enumerate(prompts)]
            outs.append([np.asarray(st.result(timeout=300))
                         for st in streams])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)


def test_sampled_server_matches_generate(models):
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


def test_preemption_under_page_pressure_changes_no_token(models):
    _, _, t_model = models
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 1024, n).astype(np.int32) for n in (20, 18, 22)]
    with Server(t_model, max_batch=3, device="cpu") as s:
        want, _ = _serve(s, prompts, n=30)
    # 8 usable pages of 8 tokens: one request (at most 52 tokens, 7
    # pages) fits, three growing together do not, so the engine evicts
    # prefix pages and preempts.
    with Server(t_model, max_batch=3, kv_page_size=8, kv_pages=9,
                paged_kernel=True, device="cpu") as s:
        got, streams = _serve(s, prompts, n=30)
        snap = s.metrics.snapshot()
    assert snap["preemptions"] > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_server_refusals_and_failures(models):
    _, _, t_model = models
    for kw in (dict(spec_k=2), dict(prefill_chunk=16), dict(http_port=0)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Server(t_model, device="cpu", kv_page_size=16, **kw)
    # Adapters are ported (tests/test_torch_lora_serving.py).
    with Server(t_model, device="cpu", kv_page_size=16,
                adapters={"rank": 4}) as s:
        assert s.health()["adapters_resident"] == []
    with pytest.raises(ValueError, match="paged_kernel needs paged KV"):
        SlotDecodeEngine(t_model, paged_kernel=True, device="cpu")
    with Server(t_model, max_batch=1, max_queue=0, device="cpu") as s:
        with pytest.raises(AdmissionError):
            s.submit([1, 2, 3], 4)
        with pytest.raises(ValueError, match="max_len"):
            s.submit(np.zeros(60, np.int32), 10)
    with Server(t_model, max_batch=1, device="cpu") as s:
        stream = s.submit([1, 2, 3], 4, deadline=-1.0)
        with pytest.raises(DeadlineExceeded):
            stream.result(timeout=60)

"""Port parity: chunked prefill (the serving engine's ``prefill_chunk``)
against the JAX package on the CPU, mirroring the JAX package's own
chunked-prefill tests.

* Prompts of 40, 33 and 9 tokens at ``kv_page_size=8, prefill_chunk=16``
  (three windows, the last ragged; and one unchunked prefill): greedy
  tokens equal to JAX ``generate``'s.
* A seeded sampled request: equal to the port's unchunked engine (the
  sampler's counter does not consume, so the windows before the last
  cannot move the first draw).
* The short-before-long order of ``first_token_at`` with
  ``prefill_chunk=8``, and the long prompt first without it.
* The validation errors, and ``close()`` in the middle of a chunked
  prefill ending the stream with an error rather than a hang.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ml_trainer_tpu_torch as mt
from ml_trainer_tpu.generate import generate as jgenerate
from ml_trainer_tpu.models import get_model as jget_model
from ml_trainer_tpu_torch.serving import Server, SlotDecodeEngine

MAX_LEN = 64


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    j_model = jget_model("gpt2_tiny", max_len=MAX_LEN)
    variables = j_model.init({"params": jax.random.PRNGKey(0)},
                             np.zeros((1, 8), np.int32), train=False)
    t_model = mt.get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu")
    t_model.load_state_dict(mt.params_from_jax(
        jax.tree.map(np.asarray, variables["params"])))
    return j_model, variables, t_model.eval()


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 1024, n).astype(np.int32)


def _jax_greedy(models, p, n):
    j_model, variables, _ = models
    return np.asarray(jgenerate(j_model, variables, jnp.asarray(p[None]),
                                n))[0]


def test_chunked_greedy_equals_jax_generate(models):
    with Server(models[2], max_batch=2, kv_page_size=8, prefill_chunk=16,
                device="cpu") as server:
        for n, seed, windows in ((40, 0, 3), (33, 1, 3), (9, 2, 0)):
            p = _prompt(n, seed)
            stream = server.submit(p, 12)
            np.testing.assert_array_equal(stream.result(timeout=120),
                                          _jax_greedy(models, p, 12))
            assert stream.request.prefill_chunks == windows
        snap = server.metrics.snapshot()
    assert snap["chunked_admissions_total"] == 2
    assert snap["prefill_chunks_total"] == 6


def test_chunked_sampled_equals_unchunked(models):
    p = _prompt(40, 3)
    outs = []
    for chunk in (16, 0):
        with Server(models[2], max_batch=2, kv_page_size=8,
                    prefill_chunk=chunk, device="cpu") as server:
            outs.append(server.complete(p, 10, temperature=0.7, rng=11,
                                        timeout=120))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(
        outs[1], mt.generate(models[2], p[None], 10, temperature=0.7,
                             rng=11, device="cpu")[0].numpy())


def test_chunked_prefill_unblocks_the_short_request(models):
    """Both slots are plugged while a long and a short prompt queue
    together; with chunking the short request admits and prefills
    between the long prompt's windows and its first token comes first,
    without it the long prefill goes first.  The order is read from the
    engine's own ``first_token_at`` stamps."""
    long_p, short_p = _prompt(48, 4), _prompt(8, 5)
    want_long = _jax_greedy(models, long_p, 8)
    want_short = _jax_greedy(models, short_p, 8)

    def first_token_order(chunk):
        with Server(models[2], max_batch=2, kv_page_size=8,
                    prefill_chunk=chunk, prefix_cache=False,
                    device="cpu") as server:
            plugs = [server.submit(_prompt(8, 50 + i), 16) for i in range(2)]
            s_long = server.submit(long_p, 8)
            s_short = server.submit(short_p, 8)
            for s in plugs:
                s.result(timeout=120)
            np.testing.assert_array_equal(s_long.result(timeout=120),
                                          want_long)
            np.testing.assert_array_equal(s_short.result(timeout=120),
                                          want_short)
            return (s_long.request.first_token_at,
                    s_short.request.first_token_at)

    t_long, t_short = first_token_order(chunk=8)
    assert t_short < t_long
    t_long, t_short = first_token_order(chunk=0)
    assert t_long < t_short


def test_prefill_chunk_validation(models):
    t_model = models[2]
    with pytest.raises(ValueError, match="prefill_chunk needs paged KV"):
        Server(t_model, max_batch=2, prefill_chunk=16, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        Server(t_model, max_batch=2, kv_page_size=8, prefill_chunk=12,
               device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk with spec_k"):
        SlotDecodeEngine(t_model, kv_page_size=8, prefill_chunk=16, spec_k=2,
                         device="cpu")


def test_close_mid_chunk_fails_the_stream(models):
    """``close()`` while a prompt is between its windows: the stream
    ends with a structured error (``abort_chunked``), the slot and its
    pages go back, and nothing hangs."""
    server = Server(models[2], max_batch=2, kv_page_size=8, prefill_chunk=8,
                    device="cpu")
    engine = server.engine
    started = threading.Event()
    real = engine._dispatch_chunk

    def slow(slot):
        started.set()
        time.sleep(0.05)
        return real(slot)

    engine._dispatch_chunk = slow
    stream = server.submit(_prompt(56, 6), 4)
    assert started.wait(timeout=60)
    server.close()
    with pytest.raises(RuntimeError, match="server closed"):
        stream.result(timeout=60)
    req = stream.request
    assert req.state == "error" and 0 < req.prefill_chunks < 7
    assert engine.chunking_count() == 0 and engine.free_capacity() == 2
    assert engine.pool.free_count() == engine.kv_pages - 1
    assert server.scheduler.queue_depth() == 0

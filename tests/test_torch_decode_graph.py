"""The serving engine's decode step as one CUDA graph.

On the card ``SlotDecodeEngine.step()`` runs its forward (``_decode``)
as one replay of a CUDA graph (``step_graph.StepGraph``): the first step
is the warm-up, the second captures, every step from there replays.  A
graph reads and writes fixed addresses, so the step must keep every
tensor it reads in place.  On the CPU, where no graph exists, the engine
runs the step eagerly; these tests put a stand-in in the graph's place
(``_StandInGraph``: ``capture`` records the function and runs nothing,
``replay`` calls it), as ``tests/test_torch_steps_per_execution.py``
stubs ``StepGraph.replay``.

* The step in place: at every replay, the tokens, ``select``, the
  positions, the page table and every K/V pool sit at the addresses they
  had when the engine was made, and the replayed logits are bitwise the
  eager step (the model on copies of the same state), across admissions,
  steps, preemption under page pressure and slot reuse; contiguous and
  paged, ``paged_kernel`` off and on, ``quant_int8`` off and on, fp32
  and bf16.  The tokens equal an eager engine's.
* Through the stand-in: greedy ``Server`` tokens equal the eager
  engine's bitwise and the JAX ``Server``'s at the bars of
  ``tests/test_torch_serving.py`` (fp32, exact),
  ``tests/test_torch_int8.py`` (fp32 int8, exact) and
  ``tests/test_torch_bf16_serving.py`` (bf16: equal up to a near-tie of
  the JAX logits); sampled output equals the port's ``generate()``;
  preemption changes no token; the K6/K7 launch counts are exact with
  replays; the first step is the warm-up and the capture happens once
  per engine; a failed capture raises, and nothing falls back to eager;
  ``Server.close()`` drops the graph.
* On the card (``cuda``): ``gpt2_tiny`` through the real graph against
  the eager step, tokens and logits bitwise, launches exact.

The JAX package is imported only where a test compares with it, so that
the ``cuda`` case also runs on a machine without it (``--noconftest``).
"""

import copy

import numpy as np
import pytest
import torch

import ml_trainer_tpu_torch as mt
from ml_trainer_tpu_torch import device as tdev
from ml_trainer_tpu_torch.models import layers
from ml_trainer_tpu_torch.serving import Server, SlotDecodeEngine
from ml_trainer_tpu_torch.serving import engine as engine_mod
from ml_trainer_tpu_torch.serving.scheduler import Request

MAX_LEN = 64
BAR = 3e-2  # bf16: of the largest logit, as tests/test_torch_bf16_serving.py
CACHES = {
    "contiguous": dict(),
    "paged": dict(kv_page_size=8, kv_pages=9),  # page pressure: preempts
    "paged_kernel": dict(kv_page_size=8, kv_pages=9, paged_kernel=True),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: small ops otherwise wait on all cores'
    threads, which the suite's other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _prompts():
    """The prompts of tests/test_torch_serving.py (the last shares two
    16-token blocks with the second: a prefix hit at page 16)."""
    rng = np.random.default_rng(0)
    out = [rng.integers(0, 1024, n).astype(np.int32) for n in (5, 40, 12, 7)]
    out.append(np.concatenate([out[1][:32],
                               rng.integers(0, 1024, 9).astype(np.int32)]))
    return out


def _pressure_prompts():
    """Five requests for three slots: slots are reused, and at page 8 in
    8 usable pages the growing requests preempt one another."""
    rng = np.random.default_rng(3)
    return [rng.integers(0, 1024, n).astype(np.int32)
            for n in (20, 18, 22, 7, 12)]


def _serve(server, prompts, n=10, **kw):
    streams = [server.submit(p, n, **kw) for p in prompts]
    return [np.asarray(s.result(timeout=300)) for s in streams], streams


def _state_ptrs(engine) -> dict:
    """The addresses of every tensor the decode step reads or writes."""
    cache = engine.cache
    ptrs = {"tok": engine.tok.data_ptr(), "select": engine._select.data_ptr(),
            "index": cache.index.data_ptr(),
            "k": [t.data_ptr() for t in cache.k],
            "v": [t.data_ptr() for t in cache.v]}
    if cache.paged:
        ptrs["table"] = cache.table.data_ptr()
    return ptrs


def _eager_step(engine) -> torch.Tensor:
    """The eager decode step on copies of the engine's state: the model
    on the tokens with a fresh ``select``, as the engine ran it before
    the step had fixed addresses.  The launches it counts are taken back
    (``CountedGraph.capturing`` restores the counters)."""
    with torch.no_grad(), tdev.CountedGraph(None).capturing():
        return engine.model(
            engine.tok.clone(), copy.deepcopy(engine.cache),
            select=torch.zeros(engine.max_batch, dtype=torch.long),
            quant=engine.quant)


class _StandInGraph:
    """CPU stand-in for ``StepGraph``.  ``warm_up`` runs the step;
    ``capture`` records the function and runs nothing (a capture
    executes nothing on the card); ``replay`` checks that the state sits
    at the addresses the engine was made with, that the function's
    logits are bitwise the eager step's, and returns them."""

    def __init__(self, device, made: list):
        self.device = device
        self.capture_s = None
        self.fn = None
        self.warm_ups = self.captures = self.replays = 0
        made.append(self)

    def warm_up(self, fn):
        self.warm_ups += 1
        return fn()

    def capture(self, fn):
        self.captures += 1
        self.fn = fn
        self.capture_s = 0.0

    def replay(self):
        engine = self.fn.__self__
        assert _state_ptrs(engine) == engine.ptrs_at_init, "state moved"
        want = _eager_step(engine)
        self.replays += 1
        out = self.fn()
        assert torch.equal(out, want), "replay differs from the eager step"
        return out


@pytest.fixture
def stand_in(monkeypatch):
    """Every engine made while it is active takes the graph path on the
    CPU through ``_StandInGraph``; returns the list of graphs made."""
    made = []
    real_init = SlotDecodeEngine.__init__

    def init(self, *args, **kw):
        real_init(self, *args, **kw)
        assert self._graphed is False  # the CPU runs the step eagerly
        self._graphed = True
        self.ptrs_at_init = _state_ptrs(self)

    monkeypatch.setattr(SlotDecodeEngine, "__init__", init)
    monkeypatch.setattr(engine_mod, "StepGraph",
                        lambda device: _StandInGraph(device, made))
    return made


@pytest.fixture
def counted(monkeypatch):
    """K6 and K7 count a launch wherever the decode step calls them (on
    the CPU their wrappers take the plain versions, which count none)."""
    real_paged, real_int8 = layers.paged_attention, layers.int8_matmul

    def paged(*args, **kw):
        tdev.count_launch("paged_attention")
        return real_paged(*args, **kw)

    def int8(*args, **kw):
        tdev.count_launch("int8_matmul")
        return real_int8(*args, **kw)

    monkeypatch.setattr(layers, "paged_attention", paged)
    monkeypatch.setattr(layers, "int8_matmul", int8)
    mt.reset_launch_counts()
    yield
    mt.reset_launch_counts()


def _torch_model(precision):
    return mt.init_gpt2("gpt2_tiny", seed=0, device="cpu", max_len=MAX_LEN,
                        precision=precision)


@pytest.fixture(scope="module")
def jax_models():
    """(precision, init key) -> (JAX model, its variables, the port's
    model with the same weights), made once each."""
    import jax

    from ml_trainer_tpu.models import get_model as j_get_model

    made = {}

    def get(precision, key):
        if (precision, key) not in made:
            j_model = j_get_model("gpt2_tiny", max_len=MAX_LEN,
                                  precision=precision)
            variables = j_model.init({"params": jax.random.PRNGKey(key)},
                                     np.zeros((1, 8), np.int32), train=False)
            t_model = mt.get_model("gpt2_tiny", max_len=MAX_LEN,
                                   device="cpu", precision=precision)
            t_model.load_state_dict(mt.params_from_jax(
                jax.tree.map(np.asarray, variables["params"])))
            made[precision, key] = (j_model, variables, t_model)
        return made[precision, key]

    return get


# ------------------------------------------------------ the step in place
def _serve_mixed(server, prompts, n):
    """Greedy requests but the third, sampled at 0.8 (seed 7)."""
    streams = [server.submit(p, n, temperature=0.8 if i == 2 else 0.0,
                             rng=7) for i, p in enumerate(prompts)]
    return [np.asarray(s.result(timeout=300)) for s in streams]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("quant_int8", [False, True], ids=["f", "int8"])
@pytest.mark.parametrize("cache", list(CACHES))
def test_step_in_place_is_the_eager_step(cache, quant_int8, precision,
                                         stand_in):
    model = _torch_model(precision)
    prompts = _pressure_prompts()
    kw = dict(max_batch=3, quant_int8=quant_int8, device="cpu",
              **CACHES[cache])
    with Server(model, **kw) as s:
        engine = s.engine
        got = _serve_mixed(s, prompts, 30)
        snap = s.metrics.snapshot()
        assert engine._graph is stand_in[0]
    assert engine._graph is None  # dropped on close
    (graph,) = stand_in
    assert (graph.warm_ups, graph.captures) == (1, 1)
    assert graph.replays == snap["decode_steps_total"] - 1 > 0
    assert _state_ptrs(engine) == engine.ptrs_at_init
    if cache != "contiguous":
        assert snap["preemptions_total"] > 0
    with Server(model, **kw) as s:
        s.engine._graphed = False  # the eager step
        want = _serve_mixed(s, prompts, 30)
    assert len(stand_in) == 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------- the engine through the stand-in
@pytest.mark.parametrize("precision,mode,key", [
    ("fp32", "paged_kernel", 1), ("fp32", "int8", 2),
    ("bf16", "contiguous", 1), ("bf16", "paged_kernel", 1),
    ("bf16", "int8", 1),
])
def test_graph_server_matches_eager_and_jax(precision, mode, key, jax_models,
                                            stand_in):
    """Greedy tokens through the stand-in graph: bitwise the eager
    engine's; against the JAX ``Server``, exact in fp32 (the pins of
    tests/test_torch_serving.py and tests/test_torch_int8.py), and in
    bf16 equal up to the first step whose JAX top-2 logits lie within
    the bf16 bar (tests/test_torch_bf16_serving.py)."""
    from ml_trainer_tpu.serving import Server as JServer

    j_model, variables, t_model = jax_models(precision, key)
    kw = {"contiguous": dict(),
          "paged_kernel": dict(kv_page_size=16, paged_kernel=True),
          "int8": dict(kv_page_size=16, paged_kernel=True,
                       quant_int8=True)}[mode]
    prompts = _prompts()
    with JServer(j_model, variables, max_batch=4, **kw) as js:
        want, _ = _serve(js, prompts)
    with Server(t_model, max_batch=4, device="cpu", **kw) as ts:
        got, streams = _serve(ts, prompts)
    assert stand_in[0].replays > 0
    assert streams[-1].request.prefix_hit_tokens == (
        0 if mode == "contiguous" else 32)
    with Server(t_model, max_batch=4, device="cpu", **kw) as ts:
        ts.engine._graphed = False
        eager, _ = _serve(ts, prompts)
    for a, b in zip(got, eager):
        np.testing.assert_array_equal(a, b)
    if precision == "fp32":
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return
    quant = mode == "int8"
    for p, a, b in zip(prompts, got, want):
        diff = np.flatnonzero(a != b)
        if not diff.size:
            continue
        j = int(diff[0])
        assert j >= len(p), "the prompt came back changed"
        # Step j's token comes from the prefill (j == n) or a decode step
        # (the int8 program in the int8 mode).
        logits = _jax_logits(j_model, variables, b,
                             quant and j > len(p))[j - 1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] <= BAR * np.abs(logits).max(), (
            f"{mode}: request of {len(p)} tokens parts from the JAX tokens "
            f"at step {j - len(p)} outside a near-tie")


def _jax_logits(j_model, variables, seq, quant: bool) -> np.ndarray:
    """Teacher-forced JAX logits [S, V] (f32) along ``seq``; with
    ``quant`` the int8 full forward."""
    from ml_trainer_tpu.ops.kernels.int8_matmul import (
        quantize_tree as j_quantize_tree,
    )

    if quant:
        j_model = j_model.clone(quant_int8=True)
        variables = {"params": variables["params"],
                     "quant": j_quantize_tree(variables["params"])}
    return np.asarray(j_model.apply(variables, seq[None], train=False),
                      np.float32)[0]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_graph_sampled_server_matches_generate(precision, stand_in):
    model = _torch_model(precision)
    prompts = _prompts()[:3]
    with Server(model, max_batch=4, kv_page_size=16, paged_kernel=True,
                device="cpu") as s:
        streams = [s.submit(p, 12, temperature=1.1, rng=100 + i)
                   for i, p in enumerate(prompts)]
        got = [np.asarray(st.result(timeout=300)) for st in streams]
    assert stand_in[0].replays > 0
    for i, p in enumerate(prompts):
        want = mt.generate(model, p[None], 12, temperature=1.1, rng=100 + i,
                           device="cpu").numpy()[0]
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_graph_preemption_changes_no_token(precision, stand_in):
    """Through the stand-in: the paged engine under page pressure (it
    preempts and resumes) against the contiguous engine (it cannot)."""
    model = _torch_model(precision)
    prompts = _pressure_prompts()[:3]
    with Server(model, max_batch=3, device="cpu") as s:
        want, _ = _serve(s, prompts, n=30)
    with Server(model, max_batch=3, kv_page_size=8, kv_pages=9,
                paged_kernel=True, device="cpu") as s:
        got, _ = _serve(s, prompts, n=30)
        snap = s.metrics.snapshot()
    assert snap["preemptions_total"] > 0
    assert all(g.replays > 0 for g in stand_in)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("quant_int8", [False, True], ids=["f", "int8"])
def test_launch_counts_are_exact_with_replays(quant_int8, precision,
                                              stand_in, counted):
    model = _torch_model(precision)
    with Server(model, max_batch=4, kv_page_size=16, paged_kernel=True,
                quant_int8=quant_int8, device="cpu") as s:
        _serve(s, _prompts())
        steps = s.metrics.snapshot()["decode_steps_total"]
    (graph,) = stand_in
    assert graph.replays == steps - 1
    counts = mt.launch_counts()
    assert counts["paged_attention"] == model.depth * steps
    assert counts["int8_matmul"] == (4 * model.depth * steps if quant_int8
                                     else 0)


def test_first_step_warms_up_then_one_capture(stand_in):
    model = _torch_model("fp32")
    engine = SlotDecodeEngine(model, max_batch=2, kv_page_size=16,
                              paged_kernel=True, device="cpu")
    engine.admit(Request(np.arange(9, dtype=np.int32), 8), 0)
    engine.step()
    (graph,) = stand_in
    assert (graph.warm_ups, graph.captures, graph.replays) == (1, 0, 0)
    engine.step()
    assert (graph.warm_ups, graph.captures, graph.replays) == (1, 1, 1)
    engine.admit(Request(np.arange(20, dtype=np.int32), 8), 1)
    for _ in range(3):
        engine.step()
    assert (graph.warm_ups, graph.captures, graph.replays) == (1, 1, 4)
    # close() drops the graph; a later step warms up and captures anew.
    engine.close()
    assert engine._graph is None
    engine.step()
    engine.step()
    assert len(stand_in) == 2 and stand_in[1].captures == 1


def test_cpu_runs_the_step_eagerly():
    """No stand-in: on the CPU the engine makes no graph."""
    model = _torch_model("fp32")
    engine = SlotDecodeEngine(model, max_batch=2, device="cpu")
    assert SlotDecodeEngine._decode_graph and not engine._graphed
    engine.admit(Request(np.arange(9, dtype=np.int32), 4), 0)
    tok = engine.tok
    engine.step()
    engine.step()
    assert engine._graph is None and engine.tok is tok


def test_failed_capture_raises_and_never_falls_back(stand_in, monkeypatch):
    def fail(self, fn):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(_StandInGraph, "capture", fail)
    model = _torch_model("fp32")
    engine = SlotDecodeEngine(model, max_batch=2, device="cpu")
    engine.admit(Request(np.arange(9, dtype=np.int32), 8), 0)
    engine.step()  # the warm-up
    before = engine.cache.index.clone()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            engine.step()
    torch.testing.assert_close(engine.cache.index, before, rtol=0, atol=0)
    assert stand_in[0].replays == 0


# -------------------------------------------------------------- the card
@pytest.mark.cuda
def test_decode_graph_matches_eager_on_card():
    """``gpt2_tiny`` (head_dim 32) on the card, fp32 and bf16, contiguous,
    paged with K6 and paged with K6 and K7: the graph run's tokens equal
    the eager run's, launches exact with replays, K6's tickets back at 0;
    then on one state of 4 live slots the replayed logits are bitwise
    the eager step's from the same state."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA) and nvcc")
    from ml_trainer_tpu_torch.ops.kernels import _split

    prompts = _prompts()
    for precision in ("fp32", "bf16"):
        model = mt.init_gpt2("gpt2_tiny", seed=0, device="cuda",
                             max_len=MAX_LEN, precision=precision)
        for kw in (dict(), dict(kv_page_size=16, paged_kernel=True),
                   dict(kv_page_size=16, paged_kernel=True,
                        quant_int8=True)):
            runs = []
            for graphed in (True, False):
                SlotDecodeEngine._decode_graph = graphed
                try:
                    with Server(model, max_batch=4, device="cuda",
                                **kw) as s:
                        mt.reset_launch_counts()
                        outs, _ = _serve(s, prompts)
                        counts = mt.launch_counts()
                        steps = s.metrics.snapshot()["decode_steps_total"]
                        captured = (s.engine._graph is not None
                                    and s.engine._graph.capture_s is not None)
                finally:
                    SlotDecodeEngine._decode_graph = True
                assert captured == graphed
                paged = model.depth * steps if kw.get("paged_kernel") else 0
                assert counts["paged_attention"] == paged
                assert counts["int8_matmul"] == (
                    4 * model.depth * steps if kw.get("quant_int8") else 0)
                runs.append(outs)
            for a, b in zip(*runs):
                np.testing.assert_array_equal(a, b)
            engine = SlotDecodeEngine(model, max_batch=4, device="cuda", **kw)
            for slot, p in enumerate(prompts[:4]):
                engine.admit(Request(p, 8), slot)
            engine.step()
            engine.step()  # warm-up, then capture and the first replay
            state = [t.clone() for t in _state_tensors(engine)]
            with torch.no_grad():
                want = engine._decode().clone()
            for t, saved in zip(_state_tensors(engine), state):
                t.copy_(saved)
            got = engine._graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            engine.close()
        assert _split.all_zero()


def _state_tensors(engine) -> list:
    cache = engine.cache
    return [engine.tok, cache.index, *cache.k, *cache.v] + (
        [cache.table] if cache.paged else [])

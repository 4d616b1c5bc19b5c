"""Serving LoRA adapters from the port's adapter pool
(``ml_trainer_tpu_torch/serving/adapter_pool.py``, the engine's serve
mode) against the JAX package's, on the CPU.

``gpt2_tiny`` (max_len 64), the same weights on both sides
(``params_from_jax``), artifacts written by the JAX package's
``export_lora_artifact`` with B given real mass.  Tolerance: greedy
tokens equal (fp32); base rows bitwise.

* The pool's refcount, LRU eviction, exhaustion and unknown-adapter
  errors, as ``tests/test_lora.py``.
* Artifacts cross both ways with equal ``base_fingerprint``; the port's
  paged ``Server`` serves a JAX-exported artifact (two adapters of two
  ranks and target sets, beside base rows in one batch) with the JAX
  ``Server``'s greedy tokens.
* Base rows decode bitwise like an engine without adapters; the prefix
  cache is namespaced by adapter; evict-and-reload serves the same
  tokens; the stacks keep their addresses across uploads; a served
  adapter equals the train-mode model's ``generate()``.
* Through a stand-in for the decode graph (the step captured once,
  replayed at fixed addresses): bitwise the eager step, a hot-load after
  the capture served with no second capture.
* Structured errors, the gauges and ``health()``.
"""

import copy

import numpy as np
import pytest
import torch

import ml_trainer_tpu_torch as mt
from ml_trainer_tpu.lora import LoraConfig as JLoraConfig
from ml_trainer_tpu.lora import base_fingerprint as j_fingerprint
from ml_trainer_tpu.lora import export_lora_artifact as j_export
from ml_trainer_tpu.lora import load_lora_artifact as j_load
from ml_trainer_tpu.models import get_model as j_get_model
from ml_trainer_tpu.serving import AdapterConfig as JAdapterConfig
from ml_trainer_tpu.serving import AdapterPool as JAdapterPool
from ml_trainer_tpu.serving import Server as JServer
from ml_trainer_tpu_torch.lora import (
    LoraConfig,
    base_fingerprint,
    export_lora_artifact,
    flat_paths,
    load_lora_artifact,
    strip_lora_params,
)
from ml_trainer_tpu_torch.serving import (
    AdapterConfig,
    AdapterPool,
    AdapterPoolExhausted,
    Server,
    SlotDecodeEngine,
    UnknownAdapter,
)
from ml_trainer_tpu_torch.serving import engine as engine_mod

MAX_LEN = 64
PS = 8
ALL = ("qkv", "proj", "fc_in", "fc_out")


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 1024, n).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    """The port's seeded ``gpt2_tiny`` and its weights as the JAX model's
    variables (``variables_to_jax``: flax's names and layouts)."""
    j_model = j_get_model("gpt2_tiny", max_len=MAX_LEN)
    t_model = mt.init_model("gpt2_tiny", seed=0, max_len=MAX_LEN,
                            device="cpu")
    return j_model, mt.variables_to_jax(t_model), t_model


_DIMS = {"attn": {"qkv": (128, 384), "proj": (128, 128)},
         "mlp": {"fc_in": (128, 512), "fc_out": (512, 128)}}


def _artifact(variables, path, *, name, rank=4, alpha=8.0,
              targets=("qkv", "proj"), seed=0, scale=2.0):
    """A JAX-exported artifact over the fixture's base: A from N(0,
    0.01^2) as the train-mode init, B with real mass (as
    tests/test_lora.py), in flax's layouts."""
    rng = np.random.default_rng(seed)
    full = copy.deepcopy(variables["params"])
    for i in range(2):
        for mod, dims in _DIMS.items():
            for t, (n_in, n_out) in dims.items():
                if t in targets:
                    node = full[f"block{i}"][mod]
                    node[f"{t}_lora_A"] = (rng.normal(size=(n_in, rank))
                                           * 0.01).astype(np.float32)
                    node[f"{t}_lora_B"] = (rng.normal(size=(rank, n_out))
                                           * scale).astype(np.float32)
    j_export(full, JLoraConfig(rank=rank, alpha=alpha, targets=targets),
             path, name=name)
    return path, full


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    _, variables, _ = models
    d = tmp_path_factory.mktemp("artifacts")
    return {
        "x": _artifact(variables, str(d / "x.npz"), name="x", seed=1),
        "y": _artifact(variables, str(d / "y.npz"), name="y", rank=8,
                       alpha=4.0, targets=ALL, seed=2, scale=1.0),
        "z": _artifact(variables, str(d / "z.npz"), name="z", rank=2,
                       seed=3),
    }


def _serve(server, jobs, n=6):
    streams = [server.submit(p, n, adapter=a) for p, a in jobs]
    return [np.asarray(s.result(timeout=300)) for s in streams]


def _jobs():
    return [(_prompt(0, 5), None), (_prompt(1, 19), "x"),
            (_prompt(2, 11), "y"), (_prompt(3, 7), None),
            (_prompt(1, 19), "y")]


# ------------------------------------------------------- the pool (host)
def test_pool_refcount_eviction_and_exhaustion(artifacts):
    pool = AdapterPool(AdapterConfig(
        slots=3, rank=8, targets=ALL,
        sources={n: p for n, (p, _) in artifacts.items()}))
    slot_a, up_a = pool.acquire("x")
    slot_b, up_b = pool.acquire("y")
    assert up_a is not None and up_b is not None
    assert sorted((slot_a, slot_b)) == [1, 2]
    with pytest.raises(AdapterPoolExhausted, match="'z'"):
        pool.acquire("z")
    slot_a2, up = pool.acquire("x")
    assert slot_a2 == slot_a and up is None
    assert pool.counters()["hits"] == 1
    pool.release(slot_a)
    pool.release(slot_a)
    assert pool.resident() == ["x", "y"]
    slot_c, up_c = pool.acquire("z")
    assert slot_c == slot_a and up_c is not None  # the LRU victim was x
    assert pool.counters()["evictions"] == 1
    assert pool.resident() == ["y", "z"]
    with pytest.raises(UnknownAdapter, match="'nope'"):
        pool.acquire("nope")
    pool.release(0)
    pool.release(slot_b)
    with pytest.raises(ValueError, match="unheld"):
        pool.release(slot_b)
    with pytest.raises(ValueError, match="slots"):
        AdapterConfig(slots=1)
    with pytest.raises(ValueError, match="subset"):
        AdapterConfig(targets=("qkv", "nonsense"))
    with pytest.raises(ValueError, match="rank 8 exceeds"):
        AdapterPool(AdapterConfig(slots=3, rank=4, targets=ALL)).register(
            "y", artifacts["y"][0])
    with pytest.raises(ValueError, match="not covered"):
        AdapterPool(AdapterConfig(slots=3, rank=8)).register(
            "y", artifacts["y"][0])


def test_artifacts_cross_both_ways(models, artifacts, tmp_path):
    j_model, variables, t_model = models
    want_fp = j_fingerprint(variables["params"])
    assert base_fingerprint(t_model) == want_fp
    meta, leaves = load_lora_artifact(artifacts["x"][0])
    assert meta["base_fingerprint"] == want_fp and meta["n_leaves"] == 8
    # The port's export of the same adapter, read by the JAX package.
    lm = t_model.clone(lora_rank=4, lora_alpha=8.0,
                       lora_targets=("qkv", "proj"))
    lm.load_state_dict(mt.params_from_jax({"params": artifacts["x"][1]}))
    path = str(tmp_path / "port_x.npz")
    t_meta = export_lora_artifact(lm, LoraConfig(rank=4, alpha=8.0), path,
                                  name="x")
    j_meta, j_leaves = j_load(path)
    assert t_meta == j_meta == meta
    assert set(j_leaves) == set(leaves)
    for k, v in leaves.items():
        assert j_leaves[k].dtype == v.dtype
        np.testing.assert_array_equal(j_leaves[k], v)
    pool = JAdapterPool(JAdapterConfig(slots=3, rank=8))
    assert pool.register("x", path)["base_fingerprint"] == want_fp
    # The base-only tree of the adapted model is the base's, path for path.
    stripped = dict(flat_paths(strip_lora_params(lm)))
    assert list(stripped) == [k for k, _ in flat_paths(variables["params"])]
    for k, v in flat_paths(variables["params"]):
        np.testing.assert_array_equal(stripped[k], v)


def test_port_serves_a_jax_artifact_like_the_jax_server(models, artifacts):
    j_model, variables, t_model = models
    cfg = dict(slots=4, rank=8, targets=ALL,
               sources={n: artifacts[n][0] for n in ("x", "y")})
    kw = dict(max_batch=4, kv_page_size=PS, paged_kernel=True)
    with JServer(j_model, variables, adapters=JAdapterConfig(**cfg),
                 **kw) as js:
        want = _serve(js, _jobs())
    with Server(t_model, adapters=AdapterConfig(**cfg), device="cpu",
                **kw) as ts:
        got = _serve(ts, _jobs())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got[1][19:], got[4][19:])  # x vs y


def _admitted(engine, jobs):
    for slot, (p, a) in enumerate(jobs):
        req = mt.serving.Request(prompt=p, max_new_tokens=20, adapter=a)
        assert engine.admit(req, slot) == "active"


def test_base_rows_are_bitwise_an_adapter_free_engine(models, artifacts):
    _, _, t_model = models
    jobs = _jobs()[:4]
    with torch.no_grad():
        plain = SlotDecodeEngine(t_model, max_batch=4, kv_page_size=PS,
                                 paged_kernel=True, device="cpu")
        _admitted(plain, [(p, None) for p, _ in jobs])
        lora = SlotDecodeEngine(t_model, max_batch=4, kv_page_size=PS,
                                paged_kernel=True, device="cpu",
                                adapters=AdapterConfig(
                                    slots=3, rank=8, targets=ALL, sources={
                                        n: artifacts[n][0]
                                        for n in ("x", "y")}))
        _admitted(lora, jobs)
        for _ in range(3):
            for eng in (plain, lora):
                eng._sync_table()
            lora._adapter_idx.copy_(torch.from_numpy(lora._adapter_rows))
            want, got = plain._decode(), lora._decode()
            for slot, (_, a) in enumerate(jobs):
                if a is None:
                    assert torch.equal(got[slot], want[slot])
                else:
                    assert not torch.equal(got[slot], want[slot])
            nxt = torch.argmax(got, -1)
            plain.tok.copy_(nxt[:, None])
            lora.tok.copy_(nxt[:, None])
    assert list(lora._adapter_rows) == [0, 1, 2, 0]


def test_prefix_cache_isolated_per_adapter(models, artifacts):
    _, _, t_model = models
    p = np.concatenate([_prompt(3, 2 * PS), _prompt(4, 3)])
    with Server(t_model, max_batch=2, kv_page_size=PS, prefix_scope="global",
                adapters=AdapterConfig(slots=3, rank=8, sources={
                    "x": artifacts["x"][0]}), device="cpu") as srv:
        eng = srv.engine
        base1 = np.asarray(srv.complete(p, 4, timeout=300))
        h0, m0 = eng._prefix.hits, eng._prefix.misses
        out_x = np.asarray(srv.complete(p, 4, adapter="x", timeout=300))
        assert (eng._prefix.hits, eng._prefix.misses) == (h0, m0 + 1)
        out_x2 = np.asarray(srv.complete(p, 4, adapter="x", timeout=300))
        assert eng._prefix.hits == h0 + 1
        base2 = np.asarray(srv.complete(p, 4, timeout=300))
    with Server(t_model, max_batch=2, kv_page_size=PS,
                device="cpu") as plain:
        ref = np.asarray(plain.complete(p, 4, timeout=300))
    np.testing.assert_array_equal(base1, ref)
    np.testing.assert_array_equal(base2, ref)
    np.testing.assert_array_equal(out_x, out_x2)
    assert not np.array_equal(out_x, base1)


def test_eviction_reload_is_bitwise_at_fixed_addresses(models, artifacts):
    _, _, t_model = models
    p = _prompt(5, 6)
    with Server(t_model, max_batch=2, device="cpu", adapters=AdapterConfig(
            slots=2, rank=8, targets=ALL, sources={
                n: artifacts[n][0] for n in ("x", "y")})) as srv:
        eng = srv.engine
        ptrs = {k: b.data_ptr() for k, b in eng._stacks.items()}
        idx_ptr = eng._adapter_idx.data_ptr()
        out_a1 = np.asarray(srv.complete(p, 5, adapter="x", timeout=300))
        srv.complete(p, 5, adapter="y", timeout=300)  # evicts idle x
        assert eng.adapters.counters()["evictions"] == 1
        out_a2 = np.asarray(srv.complete(p, 5, adapter="x", timeout=300))
        assert {k: b.data_ptr() for k, b in eng._stacks.items()} == ptrs
        assert eng._adapter_idx.data_ptr() == idx_ptr
        assert all(torch.equal(b[0], torch.zeros_like(b[0]))
                   for b in eng._stacks.values())
    np.testing.assert_array_equal(out_a1, out_a2)


def test_a_served_adapter_equals_its_train_mode_generate(models, tmp_path):
    """A train-mode model's adapter (rank 4, alpha 8, B with real mass),
    exported and served from a rank-8 pool (the scale folded into B, A
    and B padded): its greedy tokens are the train-mode model's
    ``generate()``'s."""
    _, _, t_model = models
    lm = t_model.clone(share=False, lora_rank=4, lora_alpha=8.0,
                       lora_targets=("qkv", "proj"))
    mt.models.layers.init_lora(lm, seed=3)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for n, p in lm.named_parameters():
            if n.endswith("_lora_B"):
                p.copy_(torch.randn(p.shape, generator=gen) * 2.0)
    path = str(tmp_path / "trained.npz")
    export_lora_artifact(lm, LoraConfig(rank=4, alpha=8.0), path,
                         name="trained")
    prompts = [_prompt(10 + i, 9) for i in range(2)]
    refs = [mt.generate(lm, p[None], 4, device="cpu")[0].numpy()
            for p in prompts]
    with Server(t_model, max_batch=2, device="cpu", kv_page_size=PS,
                adapters=AdapterConfig(slots=3, rank=8)) as srv:
        srv.load_adapter("trained", path)
        for p, ref in zip(prompts, refs):
            np.testing.assert_array_equal(
                srv.complete(p, 4, adapter="trained", timeout=300), ref)
        base = srv.complete(prompts[0], 4, timeout=300)
    assert not np.array_equal(base, refs[0])


# ------------------------------------------- the decode graph's stand-in
class _StandIn:
    """``StepGraph``'s CPU stand-in: ``capture`` records the step and
    runs nothing; ``replay`` checks that the stacks and ``adapter_idx``
    sit where they were, runs the step and holds it bitwise to the eager
    step on copies of the state."""

    def __init__(self, device, made):
        self.capture_s, self.fn, self.captures, self.replays = None, None, 0, 0
        made.append(self)

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        self.captures += 1
        self.fn, self.capture_s = fn, 0.0

    def replay(self):
        eng = self.fn.__self__
        assert eng.ptrs == _ptrs(eng), "the graph's tensors moved"
        with torch.no_grad():
            want = eng._serve_model(
                eng.tok.clone(), copy.deepcopy(eng.cache),
                select=torch.zeros(eng.max_batch, dtype=torch.long),
                adapter_idx=eng._adapter_idx.clone())
        self.replays += 1
        out = self.fn()
        assert torch.equal(out, want)
        return out


def _ptrs(eng):
    return ([b.data_ptr() for b in eng._stacks.values()]
            + [eng._adapter_idx.data_ptr(), eng.tok.data_ptr()]
            + [t.data_ptr() for t in eng.cache.k])


def test_hot_load_after_capture_replays_without_recapture(
        models, artifacts, monkeypatch):
    _, _, t_model = models
    made = []
    monkeypatch.setattr(engine_mod, "StepGraph",
                        lambda device: _StandIn(device, made))
    cfg = dict(slots=3, rank=8, targets=ALL,
               sources={"x": artifacts["x"][0]})
    kw = dict(max_batch=3, kv_page_size=PS, paged_kernel=True, device="cpu")
    jobs = [(_prompt(0, 5), None), (_prompt(1, 12), "x")]
    late = [(_prompt(2, 9), "z"), (_prompt(3, 9), None)]
    with Server(t_model, adapters=AdapterConfig(**cfg), **kw) as srv:
        eng = srv.engine
        eng._graphed = True
        eng.ptrs = _ptrs(eng)
        got = _serve(srv, jobs, n=8)
        assert made and made[0].captures == 1
        srv.load_adapter("z", artifacts["z"][0])  # after the capture
        got += _serve(srv, late, n=8)
        assert len(made) == 1 and made[0].captures == 1
        assert made[0].replays > 8
    with Server(t_model, adapters=AdapterConfig(**cfg), **kw) as srv:
        srv.load_adapter("z", artifacts["z"][0])
        want = _serve(srv, jobs + late, n=8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------ errors and telemetry
def test_structured_errors_gauges_and_health(models, artifacts):
    _, _, t_model = models
    with Server(t_model, max_batch=2, device="cpu") as srv:
        with pytest.raises(ValueError, match="no adapter pool"):
            srv.submit(_prompt(0, 5), 4, adapter="x")
        with pytest.raises(ValueError, match="no adapter pool"):
            srv.load_adapter("x", artifacts["x"][0])
        assert srv.health()["adapters_resident"] is None
    with Server(t_model, max_batch=3, device="cpu", adapters=AdapterConfig(
            slots=2, rank=8, sources={"x": artifacts["x"][0],
                                      "z": artifacts["z"][0]})) as srv:
        with pytest.raises(RuntimeError, match="unknown adapter 'ghost'"):
            srv.submit(_prompt(0, 5), 4, adapter="ghost").result(timeout=60)
        sa = srv.submit(_prompt(0, 5), 40, adapter="x")
        next(iter(sa))  # x resident and held
        sb = srv.submit(_prompt(1, 5), 4, adapter="z")
        with pytest.raises(RuntimeError,
                           match="adapter pool exhausted loading 'z'"):
            sb.result(timeout=120)
        sa.result(timeout=300)
        assert np.asarray(srv.complete(_prompt(1, 5), 4, adapter="z",
                                       timeout=300)).size == 9
        health = srv.health()
        snap = srv.metrics.snapshot()
    assert health["adapters_resident"] == ["z"]
    assert snap["adapter_loads_total"] == 2
    assert snap["adapter_evictions_total"] == 1
    assert snap["adapter_slots_used"] == 1 and snap["adapter_slots_total"] == 1
    # 2 layers x 4 bytes x rank 8 x (qkv: 128 in + 384 out, proj: 128 +
    # 128): one slot of the float32 stacks.
    per_slot = 2 * 4 * 8 * (128 + 384 + 128 + 128)
    assert snap["adapter_pool_bytes"]["used"] == per_slot
    with pytest.raises(ValueError, match="quant_int8 with adapters"):
        Server(t_model, quant_int8=True, adapters={"rank": 4}, device="cpu")
    llama = mt.get_model("llama_tiny", device="cpu")
    with pytest.raises(NotImplementedError):
        Server(llama, adapters={"rank": 4}, device="cpu")

"""KV migration in the port (``ml_trainer_tpu_torch/serving/transfer.py``)
against the JAX package's ``serving/transfer.py``.

One wire format, read by both packages: a port export is read by the JAX
package's ``from_bytes`` and imported into a JAX engine, a JAX export
into a port engine, and either continuation's greedy tokens equal the
JAX ``generate()`` of the request.  The weights' fingerprint is equal
across the packages; the layer order is the JAX package's flatten order
(``block10`` before ``block2``).  Inside the port a migration keeps
greedy and ``spec_k`` continuations bitwise the never-migrated run and
seeded ones equal to ``generate(rng=seed)``; every refusal (geometry,
memory, a flipped byte, foreign weights) comes before a page is written;
an import reaches the decode graph without a recapture.  ``gpt2_tiny``
at max_len 64 and page 8 (8 pages a slot), weights from the JAX init.
"""

import jax
import numpy as np
import pytest
import torch

from ml_trainer_tpu.generate import generate as j_generate
from ml_trainer_tpu.models import get_model as j_get_model
from ml_trainer_tpu.serving import transfer as j_transfer
from ml_trainer_tpu.serving.engine import SlotDecodeEngine as JEngine
from ml_trainer_tpu.serving.scheduler import Request as JRequest
from ml_trainer_tpu_torch import generate, get_model, params_from_jax
from ml_trainer_tpu_torch.serving import engine as engine_mod
from ml_trainer_tpu_torch.serving import transfer
from ml_trainer_tpu_torch.serving.engine import SlotDecodeEngine
from ml_trainer_tpu_torch.serving.scheduler import Request

MAX_LEN = 64
PS = 8


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(seed=0, **kw):
    """The JAX model and variables (``PRNGKey(seed)``) and the port's
    model over the same weights."""
    j_model = j_get_model("gpt2_tiny", max_len=MAX_LEN, **kw)
    variables = j_model.init({"params": jax.random.PRNGKey(seed)},
                             np.zeros((1, 8), np.int32), train=False)
    t_model = get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu", **kw)
    t_model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, variables["params"])))
    return j_model, variables, t_model.eval()


@pytest.fixture(scope="module")
def models():
    return _pair()


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 1024, n).astype(np.int32)


def _drain(engine):
    while engine.active_count():
        engine.step()


def _full(prompt, req):
    return np.concatenate([prompt, np.asarray(req.tokens, np.int32)])


def _mid_stream(engine, req, slot, steps):
    assert engine.admit(req, slot) == "active"
    for _ in range(steps):
        engine.step()
    assert 1 < len(req.tokens) < req.max_new_tokens


def test_port_payload_adopted_by_jax_and_jax_payload_by_port(models):
    """Both directions across the packages: the continuation's greedy
    tokens equal the JAX ``generate()`` of the never-migrated request."""
    j_model, variables, t_model = models
    p = _prompt(0, 9)
    ref = np.asarray(j_generate(j_model, variables, p[None], 20))[0]

    src = SlotDecodeEngine(t_model, max_batch=2, kv_page_size=PS,
                           device="cpu")
    req = Request(prompt=p, max_new_tokens=20)
    _mid_stream(src, req, 0, 6)
    exp = src.export_slot(0)
    got = j_transfer.from_bytes(transfer.to_bytes(exp))  # CRC-verified
    assert got.n_pages == exp.n_pages and got.pos == exp.pos
    np.testing.assert_array_equal(got.rng_key, [0, 0])  # PRNGKey(0)
    dst = JEngine(j_model, variables, max_batch=2, kv_page_size=PS)
    cont = JRequest(prompt=p, max_new_tokens=20)
    cont.tokens = list(req.tokens)
    assert dst.import_slot(cont, 1, got) == "active"
    _drain(dst)
    np.testing.assert_array_equal(_full(p, cont), ref)

    j_src = JEngine(j_model, variables, max_batch=2, kv_page_size=PS)
    j_req = JRequest(prompt=p, max_new_tokens=20)
    _mid_stream(j_src, j_req, 0, 4)
    back = transfer.from_bytes(j_transfer.to_bytes(j_src.export_slot(0)))
    t_dst = SlotDecodeEngine(t_model, max_batch=2, kv_page_size=PS,
                             device="cpu")
    t_cont = Request(prompt=p, max_new_tokens=20)
    t_cont.tokens = list(j_req.tokens)
    assert t_dst.import_slot(t_cont, 1, back) == "active"
    _drain(t_dst)
    np.testing.assert_array_equal(_full(p, t_cont), ref)


def test_weights_fp_equals_the_jax_engines(models):
    j_model, variables, t_model = models
    t_fp = SlotDecodeEngine(t_model, max_batch=1, device="cpu").weights_fp
    assert t_fp == JEngine(j_model, variables, max_batch=1).weights_fp
    assert t_fp.startswith("w:")
    other = _pair(seed=1)
    assert SlotDecodeEngine(other[2], max_batch=1,
                            device="cpu").weights_fp != t_fp
    # An in-place update is other weights: the cached fingerprint is
    # taken again.
    model = get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu")
    model.load_state_dict(t_model.state_dict())
    assert engine_mod.weights_fp(model) == t_fp
    with torch.no_grad():
        next(model.parameters()).add_(1.0)
    assert engine_mod.weights_fp(model) != t_fp


def test_wire_leaf_order_is_the_jax_flatten_order():
    """Twelve blocks: the JAX package flattens the cache dict with its
    keys sorted as strings, so ``block10`` and ``block11`` come before
    ``block2``; a port payload at depth 12 continues in a JAX engine
    exactly as the JAX ``generate()`` does."""
    order = transfer.wire_leaf_order(12)
    assert order[:6] == [(0, "k"), (0, "v"), (1, "k"), (1, "v"),
                         (10, "k"), (10, "v")]
    assert order[8] == (2, "k") and len(order) == 24
    tree = {f"block{i}": {"attn": {"cache_index": np.zeros(()),
                                   "cached_key": np.zeros((2, 1, 1, 1)) + i,
                                   "cached_value": np.zeros((2, 1, 1, 1)) - i,
                                   "page_table": np.zeros((1, 1))}}
            for i in range(12)}
    leaves = [(path[0].key, path[-1].key) for path, leaf in
              jax.tree_util.tree_flatten_with_path(tree)[0] if leaf.ndim == 4]
    assert [(int(b[5:]), {"cached_key": "k", "cached_value": "v"}[n])
            for b, n in leaves] == order

    kw = dict(depth=12, embed_dim=64, num_heads=4)
    j_model, variables, t_model = _pair(seed=2, **kw)
    p = _prompt(1, 11)
    ref = np.asarray(j_generate(j_model, variables, p[None], 10))[0]
    src = SlotDecodeEngine(t_model, max_batch=1, kv_page_size=PS,
                           device="cpu")
    req = Request(prompt=p, max_new_tokens=10)
    _mid_stream(src, req, 0, 3)
    dst = JEngine(j_model, variables, max_batch=1, kv_page_size=PS)
    cont = JRequest(prompt=p, max_new_tokens=10)
    cont.tokens = list(req.tokens)
    assert dst.import_slot(cont, 0, j_transfer.from_bytes(
        transfer.to_bytes(src.export_slot(0)))) == "active"
    _drain(dst)
    np.testing.assert_array_equal(_full(p, cont), ref)


@pytest.mark.parametrize("spec_k", [0, 4])
def test_migration_keeps_greedy_and_spec_bitwise(models, spec_k):
    """Export mid-stream, import into a fresh engine through the wire:
    the continuation is bitwise the never-migrated run, and the source,
    finished after its (read-only) export, is too."""
    _, _, t_model = models
    p = _prompt(2, 11)
    kw = dict(max_batch=2, kv_page_size=PS, spec_k=spec_k, device="cpu")
    ref = SlotDecodeEngine(t_model, **kw)
    r_req = Request(prompt=p, max_new_tokens=16)
    ref.admit(r_req, 0)
    _drain(ref)
    src = SlotDecodeEngine(t_model, **kw)
    req = Request(prompt=p, max_new_tokens=16)
    _mid_stream(src, req, 0, 2)
    exp = transfer.from_bytes(transfer.to_bytes(src.export_slot(0)))
    dst = SlotDecodeEngine(t_model, **kw)
    cont = Request(prompt=p, max_new_tokens=16)
    cont.tokens = list(req.tokens)
    assert dst.import_slot(cont, 1, exp) == "active"
    if spec_k:
        assert dst._caps[1] == min(p.size + 16 - 1, MAX_LEN - spec_k - 1)
    _drain(dst)
    _drain(src)
    np.testing.assert_array_equal(_full(p, cont), _full(p, r_req))
    np.testing.assert_array_equal(_full(p, req), _full(p, r_req))
    assert np.array_equal(_full(p, r_req)[:p.size + 16],
                          np.asarray(generate(t_model, p[None], 16,
                                              device="cpu"))[0])


def test_migration_keeps_seeded_sampling_equal_to_generate(models):
    _, _, t_model = models
    p = _prompt(3, 10)
    want = np.asarray(generate(t_model, p[None], 12, temperature=0.7,
                               rng=42, device="cpu"))[0]
    src = SlotDecodeEngine(t_model, max_batch=2, kv_page_size=PS,
                           device="cpu")
    req = Request(prompt=p, max_new_tokens=12, temperature=0.7, rng=42)
    _mid_stream(src, req, 1, 3)
    exp = transfer.from_bytes(transfer.to_bytes(src.export_slot(1)))
    np.testing.assert_array_equal(exp.rng_key, [0, 42])
    assert exp.step_counter == len(req.tokens)
    dst = SlotDecodeEngine(t_model, max_batch=2, kv_page_size=PS,
                           device="cpu")
    cont = Request(prompt=p, max_new_tokens=12, temperature=0.7, rng=42)
    cont.tokens = list(req.tokens)
    assert dst.import_slot(cont, 0, exp) == "active"
    _drain(dst)
    np.testing.assert_array_equal(_full(p, cont), want)


def _pool_state(engine):
    return ([t.clone() for t in engine.cache.k + engine.cache.v],
            engine.pool.free_count(), engine.cache.table.clone())


def _untouched(engine, before):
    pools, free, table = before
    assert engine.pool.free_count() == free
    assert engine.active_count() == 0
    assert torch.equal(engine.cache.table, table)
    assert all(torch.equal(a, b) for a, b in
               zip(pools, engine.cache.k + engine.cache.v))


def test_refusals_come_before_any_page_is_written(models):
    """Geometry, a full pool, a flipped byte and foreign weights are
    refused structurally, and the target pool is as it was."""
    _, _, t_model = models
    src = SlotDecodeEngine(t_model, max_batch=2, kv_page_size=PS,
                           device="cpu")
    p = _prompt(4, 30)
    src.admit(Request(prompt=p, max_new_tokens=4), 0)
    exp = src.export_slot(0)
    cont = Request(prompt=p, max_new_tokens=4)

    other = SlotDecodeEngine(t_model, max_batch=2, kv_page_size=16,
                             device="cpu")
    before = _pool_state(other)
    with pytest.raises(ValueError, match="geometry"):
        other.import_slot(cont, 0, exp)
    _untouched(other, before)
    contig = SlotDecodeEngine(t_model, max_batch=2, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        contig.import_slot(cont, 0, exp)

    small = SlotDecodeEngine(t_model, max_batch=2, kv_page_size=PS,
                             kv_pages=exp.n_pages, prefix_cache=False,
                             device="cpu")  # one page short
    before = _pool_state(small)
    assert small.import_slot(cont, 0, exp) == "no_memory"
    assert small.pool.slot_page_count(0) == 0
    _untouched(small, before)

    dst = SlotDecodeEngine(t_model, max_batch=2, kv_page_size=PS,
                           device="cpu")
    before = _pool_state(dst)
    payload = bytearray(transfer.to_bytes(exp))
    payload[len(payload) // 2] ^= 0x40
    with pytest.raises(transfer.MigrationCorrupt):
        transfer.from_bytes(bytes(payload))
    bad = transfer.from_bytes(transfer.to_bytes(exp))
    bad.layers[3] = bad.layers[3].copy()
    bad.layers[3].reshape(-1)[7] += 1.0
    with pytest.raises(transfer.MigrationCorrupt, match="layer 3"):
        dst.import_slot(cont, 0, bad)
    _untouched(dst, before)

    foreign = SlotDecodeEngine(_pair(seed=1)[2], max_batch=2,
                               kv_page_size=PS, device="cpu")
    before = _pool_state(foreign)
    with pytest.raises(transfer.WeightsMismatch, match="weights_mismatch"):
        foreign.import_slot(cont, 0, exp)
    assert issubclass(transfer.WeightsMismatch, transfer.MigrationCorrupt)
    _untouched(foreign, before)


class _CountingGraph:
    """CPU stand-in for ``StepGraph``: ``warm_up`` runs the step,
    ``capture`` records it, ``replay`` runs the recorded function (the
    engine's state at the addresses it had at the capture)."""

    def __init__(self, device, made):
        self.capture_s, self.fn, self.captures = None, None, 0
        made.append(self)

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        self.captures += 1
        self.fn, self.capture_s = fn, 0.0

    def replay(self):
        return self.fn()


def test_imports_reach_the_decode_graph_without_a_recapture(models,
                                                            monkeypatch):
    """Three imports into an engine whose decode graph is captured: one
    capture, the pools, tokens, positions and table written in place
    (their addresses unchanged), and every continuation bitwise the
    eager never-migrated run."""
    _, _, t_model = models
    made = []
    monkeypatch.setattr(engine_mod, "StepGraph",
                        lambda device: _CountingGraph(device, made))
    dst = SlotDecodeEngine(t_model, max_batch=4, kv_page_size=PS,
                           device="cpu")
    dst._graphed = True
    ptrs = [t.data_ptr() for t in (dst.tok, dst.cache.index, dst.cache.table,
                                   *dst.cache.k, *dst.cache.v)]
    warm = Request(prompt=_prompt(9, 5), max_new_tokens=40)
    dst.admit(warm, 3)
    for _ in range(3):
        dst.step()  # warm-up, capture, replay
    assert dst.graph_captures == 1
    conts, refs = [], []
    for i, slot in enumerate((0, 1, 2)):
        p = _prompt(10 + i, 9 + 3 * i)
        src = SlotDecodeEngine(t_model, max_batch=1, kv_page_size=PS,
                               device="cpu")
        req = Request(prompt=p, max_new_tokens=14)
        _mid_stream(src, req, 0, 2 + i)
        cont = Request(prompt=p, max_new_tokens=14)
        cont.tokens = list(req.tokens)
        assert dst.import_slot(cont, slot, src.export_slot(0)) == "active"
        dst.step()
        conts.append((p, cont))
        refs.append(np.asarray(generate(t_model, p[None], 14,
                                        device="cpu"))[0])
    _drain(dst)
    assert dst.graph_captures == 1 and len(made) == 1
    assert made[0].captures == 1
    assert ptrs == [t.data_ptr() for t in (
        dst.tok, dst.cache.index, dst.cache.table, *dst.cache.k,
        *dst.cache.v)]
    for (p, cont), ref in zip(conts, refs):
        np.testing.assert_array_equal(_full(p, cont), ref)


def test_bf16_pages_ride_as_their_bits(models):
    """A bf16 pool's pages cross the wire as uint16 bits with a dtype
    key; the continuation is bitwise the never-migrated bf16 run.  The
    JAX reader takes the payload and sees integer layers (the recorded
    divergence: ROADMAP.md Queue C 15); a JAX bf16 payload's pages land
    in the port's pool bit for bit."""
    _, _, t_model = models
    model = get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu",
                      precision="bf16")
    model.load_state_dict(t_model.state_dict())
    model.eval()
    p = _prompt(5, 12)
    kw = dict(max_batch=1, kv_page_size=PS, device="cpu")
    ref = SlotDecodeEngine(model, **kw)
    r_req = Request(prompt=p, max_new_tokens=10)
    ref.admit(r_req, 0)
    _drain(ref)
    src = SlotDecodeEngine(model, **kw)
    assert src.cache.k[0].dtype == torch.bfloat16
    req = Request(prompt=p, max_new_tokens=10)
    _mid_stream(src, req, 0, 3)
    payload = transfer.to_bytes(src.export_slot(0))
    exp = transfer.from_bytes(payload)
    assert exp.dtype == "bfloat16" and exp.layers[0].dtype == np.uint16
    dst = SlotDecodeEngine(model, **kw)
    cont = Request(prompt=p, max_new_tokens=10)
    cont.tokens = list(req.tokens)
    assert dst.import_slot(cont, 0, exp) == "active"
    _drain(dst)
    np.testing.assert_array_equal(_full(p, cont), _full(p, r_req))
    with pytest.raises(ValueError, match="dtype"):
        SlotDecodeEngine(t_model, **kw).import_slot(cont, 0, exp)
    assert j_transfer.from_bytes(payload).layers[0].dtype == np.uint16

    # The JAX package's bf16 pages come back from its payload as 2-byte
    # void records: the port writes their bits into its bf16 pool.
    j_model = j_get_model("gpt2_tiny", max_len=MAX_LEN,
                          dtype=jax.numpy.bfloat16)
    j_vars = j_model.init({"params": jax.random.PRNGKey(0)},
                          np.zeros((1, 8), np.int32), train=False)
    j_eng = JEngine(j_model, j_vars, max_batch=1, kv_page_size=PS)
    j_req = JRequest(prompt=p, max_new_tokens=10)
    _mid_stream(j_eng, j_req, 0, 2)
    j_exp = j_eng.export_slot(0)
    back = transfer.from_bytes(j_transfer.to_bytes(j_exp))
    assert back.dtype is None and back.layers[0].dtype.kind == "V"
    back.weights_fp = None  # the JAX bf16 tree's fingerprint differs
    dst = SlotDecodeEngine(model, **kw)
    cont = Request(prompt=p, max_new_tokens=10)
    cont.tokens = list(j_req.tokens)
    assert dst.import_slot(cont, 0, back) == "active"
    chain = dst.pool.slot_pages[0]
    for (layer, kv), arr in zip(transfer.wire_leaf_order(2), j_exp.layers):
        pool = (dst.cache.k if kv == "k" else dst.cache.v)[layer]
        got = pool[chain].view(torch.int16).numpy().view(np.uint16)
        want = np.asarray(arr[:len(chain)]).view(np.uint16)
        np.testing.assert_array_equal(got, want)


def test_request_wire_identity_crosses_packages():
    """A JAX wire meta (its key as two words) rebuilds a port request
    whose seed those words spell; the port's meta round-trips."""
    j_req = JRequest(prompt=_prompt(6, 7), max_new_tokens=5,
                     temperature=0.5, rng=jax.random.PRNGKey(7),
                     tenant="t", priority=2, deadline=30.0)
    j_req.tokens = [3, 4]
    req = transfer.request_from_wire(j_transfer.request_wire_meta(j_req))
    assert (req.rng, req.tenant, req.priority, req.tokens) == (7, "t", 2,
                                                               [3, 4])
    assert 29.0 < req.deadline <= 30.0
    again = transfer.request_from_wire(transfer.request_wire_meta(req))
    np.testing.assert_array_equal(again.prompt, j_req.prompt)
    assert (again.rng, again.temperature, again.tokens) == (7, 0.5, [3, 4])
    jj = j_transfer.request_from_wire(transfer.request_wire_meta(req))
    assert int(jj.rng) == 7

"""The port's disaggregated router (``ml_trainer_tpu_torch/serving/
router.py``) against the JAX package's ``generate()``.

Requests routed prefill -> KV migration -> decode, colocated on ``both``
replicas, and redistributed after a replica dies mid-stream all give
the greedy tokens of the JAX ``generate()`` of the same weights; seeded
ones equal the port's ``generate(rng=seed)``.  Around it: session
stickiness, the redistribution budget's structured error, a role
reassignment through the migration machinery, the router's gauges on
the registry, the fleet and request validation, the router's HTTP front
end, and the surface left out (NotImplementedError naming ROADMAP.md).
Affinity is held on ``_HashRing.place`` itself, not through timing.
``gpt2_tiny`` at max_len 64 and page 8, weights from the JAX init.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from ml_trainer_tpu.generate import generate as j_generate
from ml_trainer_tpu.models import get_model as j_get_model
from ml_trainer_tpu_torch import device as tdev
from ml_trainer_tpu_torch import generate, get_model, params_from_jax
from ml_trainer_tpu_torch.serving import Router, Server
from ml_trainer_tpu_torch.serving.router import _HashRing
from ml_trainer_tpu_torch.telemetry.registry import MetricsRegistry

MAX_LEN = 64
PS = 8


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    j_model = j_get_model("gpt2_tiny", max_len=MAX_LEN)
    variables = j_model.init({"params": jax.random.PRNGKey(0)},
                             np.zeros((1, 8), np.int32), train=False)
    t_model = get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu")
    t_model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, variables["params"])))
    return j_model, variables, t_model.eval()


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 1024, n).astype(np.int32)


def _jax_ref(models, p, n):
    j_model, variables, _ = models
    return np.asarray(j_generate(j_model, variables, p[None], n))[0]


def _build(models, roles, **kw):
    return Router.build(models[2], roles=roles, max_batch=2,
                        kv_page_size=PS, device="cpu", **kw)


def test_disagg_tokens_equal_jax_generate(models):
    """Prefill on one replica, decode on another: greedy tokens equal the
    JAX ``generate()``, a seeded request the port's ``generate``; each
    request migrated once."""
    pa, pb, pc = _prompt(5, 9), _prompt(6, 5), _prompt(7, 12)
    seeded = np.asarray(generate(models[2], pc[None], 10, temperature=0.7,
                                 rng=42, device="cpu"))[0]
    with _build(models, ["prefill", "decode"]) as router:
        streams = [router.submit(pa, 16), router.submit(pb, 10),
                   router.submit(pc, 10, temperature=0.7, rng=42)]
        outs = [s.result(timeout=120) for s in streams]
        snap = router.snapshot()
        assert router.replica("decode0").server.engine._active == {}
    np.testing.assert_array_equal(outs[0], _jax_ref(models, pa, 16))
    np.testing.assert_array_equal(outs[1], _jax_ref(models, pb, 10))
    np.testing.assert_array_equal(outs[2], seeded)
    assert snap["mode"] == "disagg"
    assert snap["migrations_total"] == 3
    assert snap["kv_migrated_bytes_total"] > 3 * 2 * 2 * 8 * PS * 4 * 32
    assert snap["requests_total"] == {"decode/decode0": 3,
                                      "prefill/prefill0": 3}
    assert [s.request.events[-1]["event"] for s in streams] == ["finish"] * 3
    assert all(Router._serving_replica(s.request) == "decode0"
               for s in streams)


def test_colocated_tokens_equal_jax_generate(models):
    prompts = [_prompt(s, 6 + s % 5) for s in (8, 9, 10)]
    with _build(models, ["both", "both", "both"],
                router_kwargs={"hedging": False}) as router:
        outs = [router.complete(p, 8, timeout=120) for p in prompts]
        snap = router.snapshot()
    for out, p in zip(outs, prompts):
        np.testing.assert_array_equal(out, _jax_ref(models, p, 8))
    assert snap["mode"] == "colocated"
    assert snap["migrations_total"] == 0
    assert sum(snap["requests_total"].values()) == 3
    assert all(k.startswith("colocated/") for k in snap["requests_total"])


def test_hash_ring_places_a_shared_prefix_on_one_replica(models):
    """Affinity on the ring itself: a key always lands on one replica;
    the same tenant and first block give the same key whatever follows;
    a replica's loss remaps only the keys it held."""
    ring = _HashRing(["p0", "p1", "p2"])
    keys = [f"key{i}".encode() for i in range(200)]
    alive = {"p0", "p1", "p2"}
    placed = {k: ring.place(k, alive) for k in keys}
    assert {placed[k] for k in keys} == alive
    assert all(ring.place(k, alive) == placed[k] for k in keys)
    after = {k: ring.place(k, {"p0", "p2"}) for k in keys}
    for k in keys:
        if placed[k] != "p1":
            assert after[k] == placed[k]
        else:
            assert after[k] in ("p0", "p2")
    assert ring.place(b"x", set()) is None
    with _build(models, ["prefill", "prefill", "decode"],
                router_kwargs={"hedging": False}) as router:
        shared = _prompt(11, PS)
        a = router._affinity_key("t", np.concatenate([shared, _prompt(1, 4)]))
        b = router._affinity_key("t", np.concatenate([shared, _prompt(2, 9)]))
        assert a == b
        assert router._affinity_key("u", shared) != a
        assert router._affinity_key("t", shared, adapter="x") != a
        want = router._ring.place(a, {"prefill0", "prefill1"})
        assert want in ("prefill0", "prefill1")
        from ml_trainer_tpu_torch.serving.scheduler import Request

        for sfx in (_prompt(3, 4), _prompt(4, 7)):
            req = Request(prompt=np.concatenate([shared, sfx]),
                          max_new_tokens=2, tenant="t")
            assert router._place(req, None)[0].name == want


def test_session_stickiness_pins_the_decode_replica(models):
    with _build(models, ["prefill", "decode", "decode"],
                router_kwargs={"hedging": False}) as router:
        for i in range(3):
            router.complete(_prompt(20 + i, 6), 3, timeout=120,
                            session="chat-1")
        snap = router.snapshot()
    decodes = {k: n for k, n in snap["requests_total"].items()
               if k.startswith("decode/")}
    assert len(decodes) == 1 and sum(decodes.values()) == 3, decodes
    assert snap["sessions"] == 1


def _hold_at_step(server, n: int):
    """Hold ``server``'s loop before its ``n``th decode step until the
    returned ``go`` is set (``reached`` is set when it gets there); a
    server that went unhealthy meanwhile skips the step.  The replica is
    then mid-stream whatever the machine's load."""
    engine, real = server.engine, server.engine.step
    reached, go = threading.Event(), threading.Event()
    count = [0]

    def step():
        count[0] += 1
        if count[0] == n:
            reached.set()
            go.wait(60)
            if not server.healthy:
                return []
        return real()

    engine.step = step
    return reached, go


def test_replica_kill_redistributes_byte_identically(models):
    """A decode replica dies mid-stream: its streams resume on the
    survivor from their committed tokens, every one equal to the JAX
    ``generate()``."""
    prompts = [_prompt(30 + i, 7 + i) for i in range(4)]
    with _build(models, ["prefill", "decode", "decode"],
                router_kwargs={"hedging": False}) as router:
        reached, go = _hold_at_step(router.replica("decode0").server, 3)
        streams = [router.submit(p, 28) for p in prompts]
        assert reached.wait(120), "decode0 never decoded"
        router.kill_replica("decode0")
        go.set()
        outs = [s.result(timeout=120) for s in streams]
        snap = router.snapshot()
    for out, p in zip(outs, prompts):
        np.testing.assert_array_equal(out, _jax_ref(models, p, 28))
    assert snap["redistributes_total"] >= 1
    assert snap["replica_healthy"] == {"decode0": 0, "decode1": 1,
                                       "prefill0": 1}


def test_redistribution_budget_exhaustion_is_structured(models):
    with _build(models, ["prefill", "decode"],
                router_kwargs={"max_redistributes": 0,
                               "admission_retry_s": 1.0,
                               "hedging": False}) as router:
        reached, go = _hold_at_step(router.replica("decode0").server, 3)
        s = router.submit(_prompt(40, 8), 40)
        assert reached.wait(120)
        router.kill_replica("decode0")
        go.set()
        with pytest.raises(RuntimeError, match="max_redistributes=0"):
            s.result(timeout=120)
        assert router.snapshot()["errors_total"] == 1


def test_reassign_role_evacuates_through_migration(models):
    """A decode replica flips to prefill mid-stream: its slots' KV is
    adopted by the other decode replica (no re-prefill), the streams stay
    byte-identical, and the ring takes the new prefill replica."""
    prompts = [_prompt(60 + i, 9) for i in range(2)]
    with _build(models, ["prefill", "decode", "decode"],
                router_kwargs={"hedging": False}) as router:
        server = router.replica("decode0").server
        reached, go = _hold_at_step(server, 3)
        streams = [router.submit(p, 30, session="s") for p in prompts]
        assert reached.wait(120)
        sticky = router._sessions["s"]
        assert sticky == "decode0" and server.engine.active_count() >= 1
        flip = threading.Thread(
            target=lambda: flipped.append(router.reassign_role(sticky,
                                                               "prefill")))
        flipped = []
        flip.start()
        deadline = time.monotonic() + 60
        while server._evacuate_sink is None:  # the sweep is armed
            assert time.monotonic() < deadline
            time.sleep(0.002)
        go.set()
        flip.join(60)
        assert flipped == [True]
        outs = [s.result(timeout=120) for s in streams]
        snap = router.snapshot()
        assert router.replica(sticky).role == "prefill"
        assert router.replica(sticky).server.health()["role"] == "prefill"
        assert router._sessions == {}
    for out, p in zip(outs, prompts):
        np.testing.assert_array_equal(out, _jax_ref(models, p, 30))
    assert snap["migrations_total"] >= 3
    assert snap["redistributes_total"] == 0


def test_router_metrics_on_the_registry(models):
    with _build(models, ["prefill", "decode"]) as router:
        router.complete(_prompt(50, 6), 4, timeout=120)
        reg = MetricsRegistry()
        snap = router.publish(reg)
        text = reg.prometheus_text()
    assert ('router_requests_total{role="prefill",replica="prefill0"} 1'
            in text)
    assert 'router_requests_total{role="decode",replica="decode0"} 1' in text
    sample = {line.split(" ")[0]: float(line.split(" ")[1])
              for line in text.splitlines() if not line.startswith("#")}
    assert sample["router_kv_migrated_bytes_total"] == snap[
        "kv_migrated_bytes_total"] > 0
    assert 'router_replica_healthy{replica="decode0"} 1' in text
    assert 'router_breaker_state{replica="prefill0"} 0' in text
    assert 'router_replica_slo_attainment{slo="ttft",replica="decode0"}' \
        in text
    for name in ("router_migrations_total 1", "router_redistributes_total 0",
                 "router_hedges_total", "router_migrations_corrupt_total",
                 "router_flaps_damped_total", "serving_degradation_level"):
        assert name in text, name


def test_router_refuses_a_heterogeneous_or_contiguous_fleet(models):
    t_model = models[2]
    paged = Server(t_model, max_batch=2, kv_page_size=PS, role="prefill",
                   device="cpu")
    contig = Server(t_model, max_batch=2, role="decode", device="cpu")
    other = Server(t_model, max_batch=2, kv_page_size=16, role="decode",
                   device="cpu")
    try:
        with pytest.raises(ValueError, match="paged"):
            Router({"p0": paged, "d0": contig})
        with pytest.raises(ValueError, match="kv_page_size"):
            Router({"p0": paged, "d0": other})
        with pytest.raises(ValueError, match="role"):
            Server(t_model, max_batch=2, role="router", device="cpu")
        with pytest.raises(ValueError, match="at least one"):
            Router({})
    finally:
        for srv in (paged, contig, other):
            srv.close()
    with _build(models, ["both"]) as router:
        with pytest.raises(ValueError, match="colocated"):
            router.add_replica("d9", Server(t_model, max_batch=2,
                                            kv_page_size=PS, role="decode",
                                            device="cpu"))


def test_router_validates_requests(models):
    with _build(models, ["both"]) as router:
        with pytest.raises(ValueError, match="non-empty"):
            router.submit(np.asarray([], np.int32), 4)
        with pytest.raises(ValueError, match="max_len"):
            router.submit(_prompt(60, 8), 1000)
        with pytest.raises(ValueError, match="eos_token_id"):
            router.submit(_prompt(60, 8), 4, eos_token_id=10 ** 6)
        with pytest.raises(ValueError, match="tenant"):
            router.submit(_prompt(60, 8), 4, tenant="")
        with pytest.raises(ValueError, match="max_new_tokens"):
            router.submit(_prompt(60, 8), 0)
    with pytest.raises(RuntimeError, match="closed"):
        router.submit(_prompt(60, 8), 4)


def test_the_surface_left_out_names_the_roadmap(models):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A 7"):
        _build(models, ["both"], router_kwargs={"incident_dir": "/x"})
    for arg in ("metrics_scrape_interval", "incident_min_interval_s"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A 7"):
            _build(models, ["both"], router_kwargs={arg: 1.0})
    with _build(models, ["both"]) as router:
        for call in (router.fleet_trace, router.scrape_metrics,
                     router.federated_metrics_text,
                     lambda: router.save_fleet_trace("x"),
                     lambda: router.trigger_incident("x"),
                     lambda: router.save_incident_bundle("x"),
                     lambda: router.submit(_prompt(1, 4), 2, trace={})):
            with pytest.raises(NotImplementedError,
                               match="ROADMAP.md Queue A 7"):
                call()


def _call(base, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_router_http_front_end(models):
    p = _prompt(70, 10)
    with _build(models, ["prefill", "decode"]) as router:
        host, port = router.serve_http()
        base = f"http://{host}:{port}"
        code, body = _call(base, "/v1/generate", {
            "prompt": p.tolist(), "max_new_tokens": 6, "session": "s1"})
        assert code == 200
        out = json.loads(body)
        np.testing.assert_array_equal(out["tokens"], _jax_ref(models, p, 6))
        assert out["replica"] == "decode0"
        code, health = _call(base, "/healthz")
        health = json.loads(health)
        assert code == 200 and health["mode"] == "disagg"
        assert health["replicas"]["decode0"]["role"] == "decode"
        assert health["sessions"] == 1
        code, text = _call(base, "/metrics")
        assert code == 200 and b"router_migrations_total 1" in text
        assert json.loads(_call(base, "/metrics.json")[1])[
            "migrations_total"] == 1
        assert "attainment" in json.loads(_call(base, "/slo")[1])
        assert _call(base, "/v1/generate", {"max_new_tokens": 2})[0] == 400
        assert _call(base, "/trace")[0] == 404


def test_a_capture_keeps_only_its_own_threads_launches():
    """The replicas of an in-process router run their loops in threads of
    one process: a decode graph captured on one thread takes in the
    launches of its own forward only, while another engine's launches
    meanwhile stay counted as launches that ran."""

    class Stub:
        def replay(self):
            pass

    tdev.reset_launch_counts()
    graph = tdev.CountedGraph(Stub())
    inside, go = threading.Event(), threading.Event()

    def capture():
        with graph.capturing():
            for _ in range(12):
                tdev.count_launch("paged_attention")
            inside.set()
            go.wait(10)

    th = threading.Thread(target=capture)
    th.start()
    assert inside.wait(10)
    for _ in range(5):  # another engine's eager step meanwhile
        tdev.count_launch("paged_attention")
    go.set()
    th.join(10)
    assert tdev.launch_counts()["paged_attention"] == 5
    assert graph.added[0] == {"paged_attention": 12}
    graph.replay()
    assert tdev.launch_counts()["paged_attention"] == 17
    tdev.reset_launch_counts()

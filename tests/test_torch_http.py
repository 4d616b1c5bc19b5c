"""The port's serving front end over HTTP, on the CPU, against the JAX
package's, with the same ``gpt2_tiny`` weights (``params_from_jax``).

* ``POST /v1/generate``: the same prompts give the same greedy tokens
  from both servers, concurrently and through the paged engine.
* Status codes: 400 (a bad body), 404 (an unknown path), 429 (a full
  queue), 503 with ``Retry-After`` (a shed) and 504 (a deadline) arise
  from the same requests in both.
* The ``/healthz`` key set is the JAX package's (the keys of modules not
  ported yet are named and null or 0), and the ``/metrics`` metric
  names, ``/metrics.json`` keys and ``/slo`` keys match.
* On the port: a ``decode_wedge`` fails the HTTP client fast, turns
  ``/healthz`` to 503 and refuses new work, and a fresh server serves
  again; the engine thread's death reaches every stream;
  ``result(timeout=)`` holds on a stuck engine; ``drain()``; the four
  degradation rungs as the JAX package's ``tests/test_overload.py``
  pins them; and ``decode_wedge@step=N`` fires at the same decode step
  in both packages.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from ml_trainer_tpu.models import get_model as j_get_model
from ml_trainer_tpu.resilience import faults as j_faults
from ml_trainer_tpu.serving import Server as JServer
from ml_trainer_tpu.telemetry import registry as j_registry
from ml_trainer_tpu_torch import generate, get_model, params_from_jax
from ml_trainer_tpu_torch.resilience import faults as t_faults
from ml_trainer_tpu_torch.serving import (
    AdmissionError,
    DegradationConfig,
    DegradationLadder,
    EngineUnhealthy,
    OverloadShed,
    Server,
)
from ml_trainer_tpu_torch.telemetry import registry as t_registry

MAX_LEN = 64
PS = 8  # page size: 8 pages a slot
# The health keys of modules not ported yet (null), and the adoption
# queue of a server no router feeds (empty).
UNPORTED_HEALTH = {"compile_events_post_warmup_total": None,
                   "trace_now_us": None, "mono_epoch": None,
                   "adoptions_pending": 0}


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
    j_model = j_get_model("gpt2_tiny", max_len=MAX_LEN)
    variables = j_model.init({"params": jax.random.PRNGKey(1)},
                             np.zeros((1, 8), np.int32), train=False)
    t_model = get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu")
    t_model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, variables["params"])))
    t_model.eval()
    # Warm JAX's programs through a watchdog-less server first: compiles
    # run on its loop thread and would read as a wedge.
    with JServer(j_model, variables, max_batch=2, kv_page_size=PS,
                 paged_kernel=True, watchdog_timeout=None) as w:
        for n in (5, 12, 20):
            w.complete(_prompt(90 + n, n), 4, timeout=300)
    return j_model, variables, t_model


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 1024, n).astype(np.int32)


def _call(base, path, body=None, raw=None, timeout=120):
    """(status, JSON or text payload, headers) of one request."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, text, headers = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        code, text, headers = e.code, e.read(), e.headers
    try:
        return code, json.loads(text), headers
    except ValueError:
        return code, text.decode(), headers


def _jax_server(models, **kw):
    j_model, variables, _ = models
    kw.setdefault("watchdog_timeout", None)
    return JServer(j_model, variables, **kw)


def _base(server):
    host, port = server.serve_http(port=0)
    return f"http://{host}:{port}"


def _gen(prompt, n, **kw):
    return dict(prompt=[int(t) for t in prompt], max_new_tokens=n, **kw)


def test_generate_over_http_matches_jax(models):
    prompts = [_prompt(i, n) for i, n in enumerate((5, 12, 20, 9, 14))]
    # A prefix hit: the first two 8-token blocks of prompt 2.
    prompts.append(np.concatenate([prompts[2][:16], _prompt(9, 4)]))
    got = {}
    for name, make in (
            ("jax", lambda: _jax_server(models, max_batch=2,
                                        kv_page_size=PS, paged_kernel=True)),
            ("port", lambda: Server(models[2], max_batch=2, kv_page_size=PS,
                                    paged_kernel=True, device="cpu"))):
        with make() as server:
            base = _base(server)
            # The prefix-hit prompt goes after its donor has finished.
            outs = [None] * len(prompts)

            def post(i):
                outs[i] = _call(base, "/v1/generate", _gen(prompts[i], 10))

            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(len(prompts) - 1)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            post(len(prompts) - 1)
            got[name] = outs
            snap = server.metrics.snapshot()
        assert all(o[0] == 200 for o in outs), outs
        assert snap["prefix_hits"] >= 1
    for (_, a, _), (_, b, _) in zip(got["jax"], got["port"]):
        assert a == b
        assert b["replica"] is None
    for p, (_, b, _) in zip(prompts, got["port"]):
        want = generate(models[2], p[None], 10, device="cpu")[0]
        np.testing.assert_array_equal(np.asarray(b["tokens"]), want.numpy())


def _status_run(server, full, shed_cfg):
    """The status codes of one server's bad and refused requests."""
    base = _base(server)
    p = _prompt(3, 6)
    rec = {
        "get_unknown": _call(base, "/nope")[0],
        "post_unknown": _call(base, "/v1/nope", _gen(p, 3))[0],
        "malformed": _call(base, "/v1/generate", raw=b"{not json")[0],
        "no_prompt": _call(base, "/v1/generate", {"max_new_tokens": 3})[0],
        "too_long": _call(base, "/v1/generate", _gen(_prompt(4, 60), 10))[0],
        "deadline": _call(base, "/v1/generate",
                          _gen(p, 3, deadline=-1.0))[0],
        "ok": _call(base, "/v1/generate", _gen(p, 3))[0],
    }
    full_base = _base(full)
    rec["queue_full"] = _call(full_base, "/v1/generate", _gen(p, 3))[0]
    server.set_degradation(4, shed_cfg)
    code, payload, headers = _call(base, "/v1/generate", _gen(p, 3))
    rec["shed"] = (code, headers["Retry-After"], payload["retry_after"],
                   "shed" in payload["error"])
    server.set_degradation(0)
    rec["after"] = _call(base, "/v1/generate", _gen(p, 3))[0]
    return rec


def test_status_codes_match_jax(models):
    from ml_trainer_tpu.serving.overload import (
        DegradationConfig as JDegradationConfig,
    )

    recs = {}
    with _jax_server(models, max_batch=2, kv_page_size=PS,
                     paged_kernel=True) as js, \
            _jax_server(models, max_batch=2, max_queue=0) as jfull:
        recs["jax"] = _status_run(js, jfull,
                                  JDegradationConfig(retry_after_s=3.0))
    with Server(models[2], max_batch=2, kv_page_size=PS, paged_kernel=True,
                device="cpu") as ts, \
            Server(models[2], max_batch=2, max_queue=0, device="cpu") as tfull:
        recs["port"] = _status_run(ts, tfull,
                                   DegradationConfig(retry_after_s=3.0))
    assert recs["port"] == recs["jax"]
    assert recs["port"] == {
        "get_unknown": 404, "post_unknown": 404, "malformed": 400,
        "no_prompt": 400, "too_long": 400, "deadline": 504, "ok": 200,
        "queue_full": 429, "shed": (503, "3", 3.0, True), "after": 200}


def _names(prom: str) -> set:
    return {line.split()[2] for line in prom.splitlines()
            if line.startswith("# TYPE ")}


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return None


SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$')


def test_healthz_metrics_slo_shapes_match_jax(models):
    got = {}
    for name, make, reg_mod in (
            ("jax", lambda: _jax_server(models, max_batch=2, kv_page_size=PS,
                                        paged_kernel=True), j_registry),
            ("port", lambda: Server(models[2], max_batch=2, kv_page_size=PS,
                                    device="cpu"), t_registry)):
        reg_mod.reset_default_registry()
        with make() as server:
            base = _base(server)
            for tenant in ("a", "b"):
                assert _call(base, "/v1/generate", _gen(
                    _prompt(5, 12), 4, tenant=tenant))[0] == 200
            got[name] = {p: _call(base, p) for p in
                         ("/healthz", "/metrics", "/metrics.json", "/slo")}
        reg_mod.reset_default_registry()
    for name in got:
        assert got[name]["/healthz"][0] == 200
        assert got[name]["/metrics"][2]["Content-Type"].startswith(
            "text/plain; version=0.0.4")
    health = got["port"]["/healthz"][1]
    assert sorted(health) == sorted(got["jax"]["/healthz"][1])
    for key, value in UNPORTED_HEALTH.items():
        assert health[key] == value, key
    assert health["ok"] and health["role"] == "both"
    # The same weights in both packages: the same fingerprint.
    assert health["weights_fp"] == got["jax"]["/healthz"][1]["weights_fp"]
    assert health["weights_fp"].startswith("w:")
    assert health["transport"] == "inproc"
    assert health["kv_pages_total"] == 2 * (MAX_LEN // PS)
    prom = got["port"]["/metrics"][1]
    assert _names(prom) == _names(got["jax"]["/metrics"][1])
    for line in prom.splitlines():
        assert line.startswith("# ") or SAMPLE.match(line), line
    for tenant in ("a", "b"):
        for stem in ("ttft", "tpot", "queue_wait", "e2e"):
            assert f'serving_{stem}_seconds_bucket{{tenant="{tenant}"' in prom
    assert sorted(got["port"]["/metrics.json"][1]) == sorted(
        got["jax"]["/metrics.json"][1])
    assert _keys(got["port"]["/slo"][1]) == _keys(got["jax"]["/slo"][1])
    assert got["port"]["/slo"][1]["tenants"]["a"]["requests"] == 1


def test_decode_wedge_fails_http_clients_fast(models):
    t_model = models[2]
    p = _prompt(7, 9)
    with Server(t_model, max_batch=2, kv_page_size=PS,
                watchdog_timeout=None, device="cpu") as warm:
        want = warm.complete(p, 32, timeout=120)
    timeout = 1.0
    with t_faults.injected("decode_wedge@step=8,secs=120") as plan:
        srv = Server(t_model, max_batch=2, kv_page_size=PS,
                     watchdog_timeout=timeout, device="cpu", http_port=0)
        try:
            host, port = srv._httpd.server_address
            base = f"http://{host}:{port}"
            box = {}

            def client():
                box["resp"] = _call(base, "/v1/generate", _gen(p, 32))
                box["t"] = time.monotonic()

            th = threading.Thread(target=client)
            th.start()
            while not plan.faults[0].fired:
                time.sleep(0.002)
            fired = time.monotonic()
            th.join(timeout=60)
            code, payload, _ = box["resp"]
            assert code == 503 and "wedged" in payload["error"]
            # The timeout, one watchdog poll (timeout / 5) and slack.
            assert box["t"] - fired < timeout + timeout / 5 + 2.0
            assert srv.engine._step_seq == 8
            code, health, _ = _call(base, "/healthz")
            assert code == 503 and not health["ok"]
            assert "wedged" in health["reason"] and not health["healthy"]
            code, payload, _ = _call(base, "/v1/generate", _gen(p, 4))
            assert code == 503 and "wedged" in payload["error"]
            with pytest.raises(EngineUnhealthy, match="wedged"):
                srv.submit(p, 4)
            assert _call(base, "/metrics.json")[1]["watchdog_trips"] == 1
        finally:
            plan.release_wedge()
            srv.close()
    assert not srv._thread.is_alive() and srv.engine._graph is None
    with Server(t_model, max_batch=2, kv_page_size=PS, device="cpu") as again:
        np.testing.assert_array_equal(again.complete(p, 32, timeout=120),
                                      want)


def test_close_releases_a_held_wedge(models):
    """``close()`` releases the wedge that holds the loop, so the loop
    ends and every stream fails instead of hanging for ``secs``."""
    with t_faults.injected("decode_wedge@step=2,secs=120") as plan:
        srv = Server(models[2], max_batch=2, watchdog_timeout=None,
                     device="cpu")
        s = srv.submit(_prompt(8, 5), 8)
        while not plan.faults[0].fired:
            time.sleep(0.002)
        t0 = time.monotonic()
        srv.close()
        assert time.monotonic() - t0 < 10 and not srv._thread.is_alive()
    with pytest.raises(RuntimeError, match="server closed"):
        s.result(timeout=30)


def test_engine_thread_death_reaches_every_stream(models):
    srv = Server(models[2], max_batch=2, watchdog_timeout=None,
                 device="cpu", http_port=0)
    try:
        srv.complete(_prompt(3, 4), 2, timeout=120)

        class Boom(BaseException):  # past the loop's except Exception
            pass

        submitted = threading.Event()

        def die(*a, **kw):
            # Every stream is in before the loop dies: a submit after the
            # death is refused instead (checked below).
            submitted.wait(60)
            raise Boom("engine exploded")

        srv.engine.step = die
        streams = [srv.submit(_prompt(4 + i, 4), 8) for i in range(3)]
        submitted.set()
        for s in streams:
            with pytest.raises(RuntimeError, match="engine thread died"):
                s.result(timeout=60)
        with pytest.raises(EngineUnhealthy):
            srv.submit(_prompt(5, 4), 4)
        assert not srv.health()["healthy"]
        host, port = srv._httpd.server_address
        assert _call(f"http://{host}:{port}", "/healthz")[0] == 503
    finally:
        srv.close()


def test_result_timeout_honoured_on_a_stuck_engine(models):
    srv = Server(models[2], max_batch=2, watchdog_timeout=None,
                 device="cpu")
    release = threading.Event()
    try:
        srv.complete(_prompt(6, 4), 2, timeout=120)

        def stuck(*a, **kw):
            release.wait(60)
            return []

        srv.engine.step = stuck
        s = srv.submit(_prompt(7, 4), 8)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="not finished within"):
            s.result(timeout=0.5)
        assert time.monotonic() - t0 < 5
    finally:
        release.set()
        srv.close()


def test_drain_stops_admission_and_finishes_in_flight(models):
    srv = Server(models[2], max_batch=2, device="cpu")
    try:
        srv.complete(_prompt(8, 4), 2, timeout=120)
        streams = [srv.submit(_prompt(9 + i, 4), 6) for i in range(3)]
        assert srv.drain(timeout=120)
        with pytest.raises(AdmissionError, match="draining"):
            srv.submit(_prompt(12, 4), 4)
        for s in streams:
            assert np.asarray(s.result(timeout=30)).size == 10
        health = srv.health()
        assert health["draining"] and not health["ok"] and health["healthy"]
    finally:
        srv.close()


def _ref(model, p, n):
    return generate(model, p[None], n, device="cpu")[0].numpy()


def _wait_tokens(stream, n):
    deadline = time.monotonic() + 60
    while len(stream.tokens) < n:
        assert time.monotonic() < deadline
        time.sleep(0.002)


def test_clamp_rung_spares_running_stream(models):
    t_model = models[2]
    pA, pB = _prompt(0, 9), _prompt(1, 7)
    with Server(t_model, max_batch=2, kv_page_size=PS, device="cpu") as s:
        ladder = DegradationLadder([s], DegradationConfig(clamp_tokens=5))
        sA = s.submit(pA, 24)
        _wait_tokens(sA, 3)
        ladder.set_level(1, "test burn")
        sB = s.submit(pB, 24)
        outA, outB = sA.result(timeout=120), sB.result(timeout=120)
    np.testing.assert_array_equal(outA, _ref(t_model, pA, 24))
    assert outB.size == pB.size + 5
    np.testing.assert_array_equal(outB, _ref(t_model, pB, 24)[:outB.size])
    assert any(e["event"] == "degraded_clamp" for e in sB.request.events)


def test_spec_off_mid_stream_keeps_the_tokens(models):
    t_model = models[2]
    p = _prompt(2, 9)
    with Server(t_model, max_batch=2, kv_page_size=PS, spec_k=4,
                device="cpu") as s:
        ladder = DegradationLadder([s])
        st = s.submit(p, 20)
        _wait_tokens(st, 4)
        ladder.set_level(2, "test burn")
        assert s.engine.spec_enabled is False
        at_switch = s.metrics.snapshot()["spec_steps_total"]
        out = st.result(timeout=120)
        assert s.metrics.snapshot()["spec_steps_total"] <= at_switch + 1
    np.testing.assert_array_equal(out, _ref(t_model, p, 20))


def test_hits_only_rung_sheds_misses(models):
    t_model = models[2]
    shared = _prompt(3, 2 * PS + 4)
    with Server(t_model, max_batch=2, kv_page_size=PS, device="cpu") as s:
        s.complete(shared, 4, timeout=120)  # primes the prefix cache
        DegradationLadder([s], DegradationConfig(retry_after_s=1.5)
                          ).set_level(3, "test burn")
        hit = s.complete(np.concatenate([shared[:2 * PS], _prompt(5, 4)]),
                         3, timeout=120)
        assert hit.size == 2 * PS + 4 + 3
        with pytest.raises(OverloadShed, match="hits_only") as ei:
            s.complete(_prompt(4, 20), 4, timeout=120)
        assert ei.value.retry_after == pytest.approx(1.5)
        assert s.metrics.snapshot()["requests_shed"] == 1


def test_shed_queued_rung_keeps_priority_traffic(models):
    t_model = models[2]
    pLong = _prompt(6, 2 * PS + 4)
    pLo = _prompt(7, 8)
    pHi = np.concatenate([pLong[:2 * PS], _prompt(8, 4)])
    with Server(t_model, max_batch=1, kv_page_size=PS, device="cpu") as s:
        sLong = s.submit(pLong, 24)
        _wait_tokens(sLong, 2)
        sLo = s.submit(pLo, 4, priority=0)
        sHi = s.submit(pHi, 4, priority=1)
        ladder = DegradationLadder([s], DegradationConfig(
            retry_after_s=2.0, shed_below_priority=1))
        ladder.set_level(4, "test burn")
        with pytest.raises(OverloadShed, match="shed") as ei:
            sLo.result(timeout=120)
        assert ei.value.retry_after == pytest.approx(2.0)
        with pytest.raises(OverloadShed, match="priority"):
            s.submit(_prompt(9, 8), 4, priority=0)
        np.testing.assert_array_equal(sLong.result(timeout=120),
                                      _ref(t_model, pLong, 24))
        np.testing.assert_array_equal(sHi.result(timeout=120),
                                      _ref(t_model, pHi, 4))
        assert ladder.snapshot()["shed_total"] == 1
        assert s.health()["degradation_level"] == 4


def test_decode_wedge_fires_at_the_same_step_in_both(models):
    """``decode_wedge@step=5``: the hook sits after the cancel sweep,
    only with slots active, before the step's forward, so the hold comes
    when the request has its prefill token and four decoded ones, in the
    JAX package and in the port."""
    p = _prompt(10, 6)
    seen = {}
    for name, faults, make in (
            ("jax", j_faults, lambda: _jax_server(
                models, max_batch=2, kv_page_size=PS, paged_kernel=True)),
            ("port", t_faults, lambda: Server(
                models[2], max_batch=2, kv_page_size=PS,
                watchdog_timeout=None, device="cpu"))):
        with faults.injected("decode_wedge@step=5,secs=60") as plan:
            server = make()
            try:
                st = server.submit(p, 12)
                while not plan.faults[0].fired:
                    time.sleep(0.002)
                time.sleep(0.05)
                seen[name] = (len(st.tokens), server.engine._step_seq,
                              server.engine.active_count())
                plan.release_wedge()
                out = st.result(timeout=120)
            finally:
                plan.release_wedge()
                server.close()
        seen[name] += (np.asarray(out).tolist(),)
    assert seen["port"] == seen["jax"]
    assert seen["port"][:3] == (5, 5, 1)


def test_graph_side_streams_are_reused(monkeypatch):
    """``step_graph.take_stream`` hands out a stream a closed graph gave
    back before it makes a new one (torch keeps a cuBLAS workspace for
    every stream it meets, so a new stream per engine would grow the
    card's memory with every server)."""
    from ml_trainer_tpu_torch import step_graph

    made = []

    class FakeStream:
        def __init__(self, device):
            made.append(self)

    monkeypatch.setattr(step_graph.torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(step_graph, "_FREE_STREAMS", {})
    first = step_graph.take_stream("cuda:0")
    second = step_graph.take_stream("cuda:0")
    assert first is not second and len(made) == 2
    step_graph.give_back_stream("cuda:0", first)
    assert step_graph.take_stream("cuda:1") is not first  # another card's
    assert step_graph.take_stream("cuda:0") is first and len(made) == 3

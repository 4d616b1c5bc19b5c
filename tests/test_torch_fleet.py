"""The port's serving fleet (``ml_trainer_tpu_torch/serving/fleet.py``)
and the fleet's chaos faults, against the JAX package.

* The socket round trip: a router drives two servers through
  ``RemoteServer`` proxies (NDJSON streams, ``POST /v1/adopt`` carrying
  the serialized export, CRC-verified by the receiver); greedy tokens
  equal the JAX ``generate()``, seeded ones the port's ``generate``.
* A real ``--worker --device cpu`` process answers ``/v1/spec`` with the
  weights of the seeded init and exits at ``/admin/shutdown``; without
  a card and without ``--device cpu`` a worker exits non-zero with the
  device error.
* The four fault kinds fire where the JAX package fires them:
  ``replica_kill`` in the router's health poller, ``replica_slow`` in
  the server's loop, ``healthz_flap`` in ``health()`` (absorbed by the
  router's flap damping) and ``migration_corrupt`` in the router's
  adoption (refused by the CRC check), each only for its ``host``.
"""

import json
import os
import subprocess
import sys
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
from ml_trainer_tpu_torch import generate, get_model, init_model
from ml_trainer_tpu_torch import params_from_jax
from ml_trainer_tpu_torch.resilience import faults
from ml_trainer_tpu_torch.serving import (
    EngineUnhealthy,
    Fleet,
    MigrationCorrupt,
    RemoteServer,
    Router,
    Server,
    WeightsMismatch,
)
from ml_trainer_tpu_torch.serving import SlotDecodeEngine, transfer
from ml_trainer_tpu_torch.serving.engine import weights_fp
from ml_trainer_tpu_torch.serving.scheduler import Request

MAX_LEN = 64
PS = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_socket_adopt_round_trip_bit_exact(models):
    """Prefill and decode servers reached only over HTTP: every KV
    migration crosses a socket and is CRC-verified by the decode server;
    the continuations are bit-exact, greedy and seeded."""
    t_model = models[2]
    servers, remotes = {}, {}
    router = None
    try:
        for name, role in (("prefill0", "prefill"), ("decode0", "decode")):
            srv = Server(t_model, max_batch=2, kv_page_size=PS, role=role,
                         prefill_chunk=16, device="cpu")
            host, port = srv.serve_http(port=0)
            servers[name] = srv
            remotes[name] = RemoteServer(f"http://{host}:{port}", name=name)
        assert all(r.pid == os.getpid() for r in remotes.values())
        assert remotes["prefill0"].role == "prefill"
        assert remotes["decode0"].engine.weights_fp == weights_fp(t_model)
        router = Router(dict(remotes),
                        replica_urls={n: r.url for n, r in remotes.items()},
                        hedging=False)
        for seed, n in ((6, 40), (7, 12)):  # 40 tokens: 3 chunks of 16
            p = _prompt(seed, n)
            out = router.complete(p, 12, timeout=120)
            np.testing.assert_array_equal(out, _jax_ref(models, p, 12))
        p = _prompt(24, 8)
        want = np.asarray(generate(t_model, p[None], 10, temperature=0.7,
                                   rng=3, device="cpu"))[0]
        out = router.complete(p, 10, temperature=0.7, rng=3, timeout=120)
        np.testing.assert_array_equal(out, want)
        snap = router.snapshot()
        assert snap["migrations_total"] == 3
        assert snap["kv_migrated_bytes_total"] > 0
        assert servers["decode0"].metrics.snapshot()[
            "decode_steps_total"] > 0
        assert servers["prefill0"].metrics.snapshot()[
            "prefill_chunks_total"] >= 3
        assert remotes["decode0"].health()["transport"] == "inproc"
        spec = remotes["decode0"].spec()
        assert spec["device"] == "cpu" and spec["graph_captures"] == 0
        assert set(spec["launches"]) >= {"flash_fwd", "paged_attention"}

        # The receiver's verdicts, as the in-process exceptions.
        req = Request(prompt=_prompt(50, 9), max_new_tokens=4)
        eng = SlotDecodeEngine(t_model, max_batch=1, kv_page_size=PS,
                               device="cpu")
        assert eng.admit(req, 0) == "active"
        exp = eng.export_slot(0)
        payload = bytearray(transfer.to_bytes(exp))
        payload[len(payload) // 2] ^= 0x40
        shadow = Request(prompt=req.prompt, max_new_tokens=4)
        shadow.tokens = list(req.tokens)
        with pytest.raises(MigrationCorrupt):
            remotes["decode0"].adopt_payload(shadow, bytes(payload))
        exp.weights_fp = "w:someone-else"
        exp.crc32s = None
        with pytest.raises(WeightsMismatch, match="weights_mismatch"):
            remotes["decode0"].adopt_payload(shadow,
                                             transfer.to_bytes(exp))
    finally:
        if router is not None:
            router.close()
        for srv in servers.values():
            srv.close()


def test_admin_endpoints_and_cancel(models):
    t_model = models[2]
    with Server(t_model, max_batch=1, kv_page_size=PS, device="cpu",
                http_port=0) as srv:
        host, port = srv._httpd.server_address
        base = f"http://{host}:{port}"
        remote = RemoteServer(base, name="d")
        remote.role = "decode"
        assert srv.role == "decode" and srv.health()["role"] == "decode"
        remote.replica_index = 3
        assert srv.replica_index == 3
        remote.set_degradation(1, None)
        assert srv.health()["degradation_level"] == 1
        remote.set_degradation(0, None)
        assert remote.shed_queued(5, 1.0) == 0
        assert _post(base, "/admin/faults",
                     {"spec": "healthz_flap@host=3"})[0] == 200
        assert faults.active_plan() is not None
        assert srv.health().get("flap") is True
        assert srv.health()["ok"] is True  # one poll only
        assert _post(base, "/admin/faults", {"spec": ""})[0] == 200
        assert faults.active_plan() is None
        assert _post(base, "/admin/faults",
                     {"spec": "host_hang@step=1"})[0] == 400
        assert _post(base, "/admin/role", {"role": "router"})[0] == 400
        assert _post(base, "/admin/nope", {})[0] == 404
        # A stream reached by its wire id: cancelled mid-decode.
        reached, go = _hold_at_step(srv, 3)
        shadow = Request(prompt=_prompt(1, 9), max_new_tokens=50)
        remote.submit_request(shadow)
        assert reached.wait(60)
        remote.cancel(shadow)
        go.set()
        assert shadow._finished.wait(60)
        assert shadow.state == "error" and "cancelled" in shadow.error
        assert len(shadow.tokens) == 3  # the first token and two steps
        remote._mark_unhealthy("drill")
        assert srv.health()["healthy"] is False
        with pytest.raises(EngineUnhealthy, match="drill"):
            remote.submit_request(Request(prompt=_prompt(2, 5),
                                          max_new_tokens=2))


def test_worker_process_on_the_cpu_answers_spec(tmp_path, monkeypatch):
    """One real ``--worker --device cpu`` process: its ``/v1/spec``
    carries the seeded init's fingerprint, and ``/admin/shutdown`` ends
    it with code 0."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the worker's torch
    fleet = Fleet(["decode"], max_len=MAX_LEN, max_batch=2,
                  kv_page_size=PS, device="cpu", log_dir=str(tmp_path))
    with fleet:
        remote = fleet.replicas["decode0"]
        spec = remote.spec()
        assert remote.pid != os.getpid()
        assert (spec["role"], spec["device"], spec["max_len"],
                spec["kv_page_size"]) == ("decode", "cpu", MAX_LEN, PS)
        model = init_model("gpt2_tiny", seed=0, device="cpu",
                           max_len=MAX_LEN)
        assert spec["weights_fp"] == weights_fp(model)
        assert remote.health()["transport"] == "http"
        proc = remote.proc
    assert proc.wait(timeout=60) == 0
    assert fleet.replicas == {}


def test_worker_without_a_card_exits_with_the_device_error():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-m", "ml_trainer_tpu_torch.serving.fleet",
         "--worker", "--port", "1", "--max-len", "64"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is visible" in proc.stderr
    assert "FLEET_WORKER_READY" not in proc.stdout


def _hold_at_step(server, n: int):
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


def test_replica_kill_fires_in_the_health_poller(models):
    """``replica_kill@step=2,host=0``, armed while ``decode0`` holds
    streams: the poller's second busy poll from there kills the replica
    at fleet index 0, and its streams finish on the survivor, equal to
    the JAX ``generate()``."""
    prompts = [_prompt(30 + i, 7 + i) for i in range(3)]
    with Router.build(models[2], roles=["prefill", "decode", "decode"],
                      max_batch=2, kv_page_size=PS, device="cpu",
                      router_kwargs={"hedging": False,
                                     "health_interval": 0.02}) as router:
        assert router.replica("decode0").server.replica_index == 0
        reached, go = _hold_at_step(router.replica("decode0").server, 3)
        streams = [router.submit(p, 24) for p in prompts]
        assert reached.wait(120)
        with faults.injected("replica_kill@step=2,host=0") as plan:
            deadline = time.monotonic() + 60
            while router.replica("decode0").healthy:
                assert time.monotonic() < deadline, "the kill never fired"
                time.sleep(0.005)
            assert plan.remaining() == []
        go.set()
        outs = [s.result(timeout=120) for s in streams]
        snap = router.snapshot()
    for out, p in zip(outs, prompts):
        np.testing.assert_array_equal(out, _jax_ref(models, p, 24))
    assert snap["redistributes_total"] >= 1
    assert snap["replica_healthy"]["decode0"] == 0
    assert snap["replica_healthy"]["decode1"] == 1


def test_replica_slow_latches_in_the_named_replicas_loop(models):
    t_model = models[2]
    p = _prompt(3, 9)
    with faults.injected("replica_slow@step=1,host=1,secs=0.2"), \
            Server(t_model, max_batch=1, kv_page_size=PS,
                   device="cpu") as fast, \
            Server(t_model, max_batch=1, kv_page_size=PS,
                   device="cpu") as slow:
        slow.replica_index = 1
        t0 = time.monotonic()
        out = slow.complete(p, 4, timeout=60)
        took = time.monotonic() - t0
        assert fast.complete(p, 4, timeout=60).tolist() == out.tolist()
        assert slow._slow_until > 0 and fast._slow_until == 0
        assert took >= 0.5  # a dispatch inside the window pays 0.5 s
    np.testing.assert_array_equal(out, _jax_ref(models, p, 4))


def test_healthz_flap_is_damped_by_the_router(models):
    with Router.build(models[2], roles=["both", "both"], max_batch=1,
                      kv_page_size=PS, device="cpu",
                      router_kwargs={"health_interval": 0.02,
                                     "unhealthy_after": 2}) as router:
        with faults.injected("healthz_flap@host=1") as plan:
            deadline = time.monotonic() + 30
            while plan.remaining():
                assert time.monotonic() < deadline
                time.sleep(0.01)
            time.sleep(0.1)  # polls after the flap
        snap = router.snapshot()
        assert snap["flaps_damped_total"] == 1
        assert snap["replica_healthy"] == {"rep0": 1, "rep1": 1}
        assert router.replica("rep1").healthy
    with faults.injected("healthz_flap@host=1"):
        assert router.replica("rep0").server.health().get("flap") is None


def test_migration_corrupt_is_refused_and_retried(models):
    """One flipped bit in the first migration's payload: the CRC check
    refuses it, no other decode replica can take it, so the request is
    prefilled again and its second payload adopted; tokens unchanged."""
    p = _prompt(8, 11)
    with faults.injected("migration_corrupt") as plan, \
            Router.build(models[2], roles=["prefill", "decode"], max_batch=2,
                         kv_page_size=PS, device="cpu",
                         router_kwargs={"hedging": False}) as router:
        out = router.complete(p, 10, timeout=120)
        snap = router.snapshot()
        assert plan.remaining() == []
    np.testing.assert_array_equal(out, _jax_ref(models, p, 10))
    assert snap["migrations_corrupt_total"] == 1
    assert snap["migrations_total"] == 1
    assert snap["redistributes_total"] == 1


def test_a_slow_prefill_replica_is_hedged_around(models):
    """``replica_slow`` on the prefill replica a greedy request hashes
    to: its first token cannot come before a 0.5 s dispatch, so the
    router's hedge (here after 0.1 s) prefills it on the other prefill
    replica, which wins; the tokens are the JAX ``generate()``'s."""
    p = _prompt(9, 10)
    with Router.build(models[2], roles=["prefill", "prefill", "decode"],
                      max_batch=2, kv_page_size=PS, device="cpu",
                      router_kwargs={"hedge_factor": 0.1,
                                     "hedge_min_s": 0.05}) as router:
        key = router._affinity_key("default", p)
        primary = router._ring.place(key, {"prefill0", "prefill1"})
        host = router.replica(primary).server.replica_index
        with faults.injected(f"replica_slow@step=1,host={host},secs=5"):
            out = router.complete(p, 8, timeout=120)
        snap = router.snapshot()
        events = [e["event"] for e in router.slo._timelines[-1]["events"]]
    np.testing.assert_array_equal(out, _jax_ref(models, p, 8))
    assert (snap["hedges_total"], snap["hedge_wins_total"]) == (1, 1)
    assert "hedged" in events and "hedge_won" in events
    other = ({"prefill0", "prefill1"} - {primary}).pop()
    assert snap["requests_total"][f"prefill/{other}"] == 1

"""Port parity of the serving front end's host modules, on the CPU: the
same seeded operations go through the JAX package's class and the
port's, and the outcomes must be equal.

* ``TenantScheduler``: a seeded trace of 200 operations (submits over
  four tenants with priorities, quotas and expired deadlines; acquires;
  releases; preempt-style requeues; cancels; ``shed_queued``) gives the
  same (request, slot) admissions, the same ``AdmissionError`` points,
  the same final states and the same metrics.
* ``ServingMetrics``: one seeded ``record_*`` sequence (the clock of
  ``record_step`` faked in both) gives equal snapshots, and their
  ``publish`` into fresh registries byte-equal Prometheus text; the JAX
  package's golden exposition test, run on the port.
* ``MetricsRegistry``/``prometheus_text``: the same instruments, labels
  and values give byte-equal text.
* ``aggregate_timelines``, ``SloTracker.snapshot``/``publish`` and
  ``Request.timeline`` agree on the same synthetic timelines.
* ``CircuitBreaker``, ``RollingQuantile`` and ``DegradationLadder``
  make the same transitions under a fake clock.
"""

import threading
import time

import numpy as np
import pytest
import torch

from ml_trainer_tpu.serving import overload as j_overload
from ml_trainer_tpu.serving import scheduler as j_sched
from ml_trainer_tpu.serving import slo as j_slo
from ml_trainer_tpu.serving.metrics import ServingMetrics as JMetrics
from ml_trainer_tpu.telemetry.registry import MetricsRegistry as JRegistry
from ml_trainer_tpu_torch.serving import overload as t_overload
from ml_trainer_tpu_torch.serving import scheduler as t_sched
from ml_trainer_tpu_torch.serving import slo as t_slo
from ml_trainer_tpu_torch.serving.metrics import ServingMetrics as TMetrics
from ml_trainer_tpu_torch.telemetry import MetricsRegistry as TRegistry
from ml_trainer_tpu_torch.telemetry import prometheus_text

PKGS = {"jax": (j_sched, JMetrics), "port": (t_sched, TMetrics)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: small ops otherwise wait on all cores'
    threads, which the suite's other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Side:
    """One package's scheduler under the trace, with its bookkeeping."""

    def __init__(self, sched_mod, metrics_cls):
        self.mod = sched_mod
        self.metrics = metrics_cls()
        tenants = {
            "a": sched_mod.TenantConfig(weight=3.0, max_queued=4),
            "b": sched_mod.TenantConfig(weight=1.0, max_active=2),
            "c": sched_mod.TenantConfig(weight=2.0),
        }
        self.sched = sched_mod.TenantScheduler(
            4, max_queue=24, metrics=self.metrics, tenants=tenants)
        self.reqs = []   # by submit index
        self.held = {}   # slot -> submit index

    def submit(self, tenant, priority, deadline):
        req = self.mod.Request(prompt=np.asarray([1, 2, 3], np.int32),
                               max_new_tokens=4, tenant=tenant,
                               priority=priority, deadline=deadline)
        self.reqs.append(req)
        try:
            self.sched.submit(req)
        except self.mod.AdmissionError as e:
            return ("rejected", "quota" if "quota" in str(e) else "global")
        return ("queued",)

    def acquire(self):
        got = self.sched.acquire()
        if got is None:
            return ("none",)
        req, slot = got
        i = next(k for k, r in enumerate(self.reqs) if r is req)
        self.held[slot] = i
        return ("admit", i, slot)

    def release(self, slot):
        self.held.pop(slot)
        self.sched.release(slot)
        return ("released", slot)

    def requeue(self, slot):
        i = self.held.pop(slot)
        self.sched.release(slot)
        self.reqs[i].preemptions += 1
        self.sched.requeue(self.reqs[i])
        return ("requeued", i)

    def state(self):
        return ([r.state for r in self.reqs],
                self.sched.queue_depth(), self.sched.tenant_depths(),
                self.sched.active_counts(), self.sched.free_slot_count())


def _trace(seed: int = 7, n_ops: int = 200):
    """Both packages' schedulers through one seeded trace, in lockstep;
    returns each side's outcome list and final state."""
    rng = np.random.default_rng(seed)
    sides = {k: _Side(*v) for k, v in PKGS.items()}
    outs = {k: [] for k in sides}
    for _ in range(n_ops):
        r = rng.random()
        j = sides["jax"]
        if r < 0.46:
            tenant = str(rng.choice(["a", "b", "c", "d"]))
            priority = int(rng.integers(0, 3))
            deadline = -1.0 if rng.random() < 0.1 else None
            step = {k: s.submit(tenant, priority, deadline)
                    for k, s in sides.items()}
        elif r < 0.72:
            step = {k: s.acquire() for k, s in sides.items()}
        elif r < 0.86 and j.held:
            slot = int(rng.choice(sorted(j.held)))
            step = {k: s.release(slot) for k, s in sides.items()}
        elif r < 0.93 and j.held:
            slot = int(rng.choice(sorted(j.held)))
            step = {k: s.requeue(slot) for k, s in sides.items()}
        elif r < 0.97:
            queued = [i for i, q in enumerate(j.reqs) if q.state == "queued"]
            if not queued:
                continue
            i = int(rng.choice(queued))
            for s in sides.values():
                s.reqs[i].cancel_requested = True
            step = {k: ("cancel", i) for k in sides}
        else:
            step = {k: ("shed", s.sched.shed_queued(1, retry_after=1.5))
                    for k, s in sides.items()}
        assert step["jax"] == step["port"], step
        for k in sides:
            outs[k].append(step[k])
    # Drain what is left, so that every queued request meets acquire.
    for _ in range(64):
        for s in sides.values():
            for slot in sorted(s.held):
                s.release(slot)
        step = {k: s.acquire() for k, s in sides.items()}
        assert step["jax"] == step["port"]
        if step["jax"] == ("none",) and not sides["jax"].sched.queue_depth():
            break
    return sides, outs


def test_scheduler_trace_matches_jax():
    sides, outs = _trace()
    assert outs["jax"] == outs["port"]
    kinds = [o[0] for o in outs["port"]]
    # The trace reaches every path: admissions, both watermarks, the
    # requeues, cancels and a shed.
    assert kinds.count("admit") > 20 and kinds.count("requeued") > 3
    rejected = [o[1] for o in outs["port"] if o[0] == "rejected"]
    assert "quota" in rejected and "global" in rejected
    assert any(o[0] == "shed" and o[1] > 0 for o in outs["port"])
    assert sides["jax"].state() == sides["port"].state()
    states = sides["port"].state()[0]
    assert {"expired", "error", "shed", "active"} <= set(states)
    for side in sides.values():
        for req in side.reqs:
            if req.state == "shed":
                assert req.retry_after == 1.5
    snap = {k: s.metrics.snapshot() for k, s in sides.items()}
    assert snap["jax"] == snap["port"]
    assert snap["port"]["requests_shed"] > 0
    assert set(snap["port"]["tenants"]) == {"a", "b", "c", "d"}
    # The lifecycle marks each scheduler made, in order.
    for i, (a, b) in enumerate(zip(sides["jax"].reqs, sides["port"].reqs)):
        assert ([e["event"] for e in a.events]
                == [e["event"] for e in b.events]), i


def test_weighted_admission_under_contention():
    """Both packages: with two tenants always queued, weights 3 and 1
    give 3 of every 4 admissions to the first, and a tenant back from
    idle starts at the pass floor (no burst)."""
    got = {}
    for name, (mod, metrics_cls) in PKGS.items():
        sched = mod.TenantScheduler(
            1, max_queue=100, metrics=metrics_cls(),
            tenants={"a": mod.TenantConfig(weight=3.0),
                     "b": mod.TenantConfig(weight=1.0)})
        reqs = [mod.Request(prompt=np.asarray([1]), max_new_tokens=1,
                            tenant=t) for t in "ab" * 20]
        for r in reqs:
            sched.submit(r)
        order = []
        for _ in range(24):
            req, slot = sched.acquire()
            order.append(req.tenant)
            sched.release(slot)
        # "c" arrives late: it competes from the floor, not from 0.
        late = mod.Request(prompt=np.asarray([1]), max_new_tokens=1,
                           tenant="c")
        sched.submit(late)
        for _ in range(4):
            req, slot = sched.acquire()
            order.append(req.tenant)
            sched.release(slot)
        got[name] = order
    assert got["jax"] == got["port"]
    first = got["port"][:24]
    for k in range(0, 24, 4):
        assert abs(first[k:k + 4].count("a") - 3) <= 1
    assert got["port"][24:].count("c") == 1


def _contended_pass(mod, sched, n: int = 16):
    """One pass of ``n`` requests of tenants a and b, submitted together
    and admitted into the free slots, each admission's slot released in
    admission order: per admission, its tenant and whether both tenants
    had queued requests just before it."""
    for t in "ab" * (n // 2):
        sched.submit(mod.Request(prompt=np.asarray([1]), max_new_tokens=1,
                                 tenant=t))
    held, log = [], []
    while True:
        while True:
            depths = sched.tenant_depths()
            got = sched.acquire()
            if got is None:
                break
            held.append(got[1])
            log.append((got[0].tenant, len(depths) == 2))
        if not held:
            return log
        sched.release(held.pop(0))


def test_stride_passes_carry_over_like_jax():
    """Both packages, two passes back to back at the serving front end's
    shape (8 slots; a weight 3, b weight 1 with ``max_active=4``): the
    first pass gives a 0.65-0.85 of the contended admissions (not 1:1,
    not 1:0).  A pass carries each tenant's stride over to the next
    (the pass floor lifts a tenant only up to the lowest queued pass),
    so in the second a, owed the most, takes every contended admission
    in both packages alike."""
    got = {}
    for name, (mod, metrics_cls) in PKGS.items():
        sched = mod.TenantScheduler(
            8, max_queue=64, metrics=metrics_cls(),
            tenants={"a": mod.TenantConfig(weight=3.0),
                     "b": mod.TenantConfig(weight=1.0, max_active=4)})
        got[name] = [_contended_pass(mod, sched) for _ in range(2)]
    assert got["jax"] == got["port"]
    first, second = ([t for t, both in p if both] for p in got["port"])
    assert len(first) >= 8
    assert 0.65 <= first.count("a") / len(first) <= 0.85, first
    assert second and set(second) == {"a"}, second


def _record_sequence(m, rng):
    """One seeded sequence of every ``record_*`` call."""
    for _ in range(60):
        tenant = str(rng.choice(["t0", "t1", "default"]))
        r = rng.random()
        if r < 0.15:
            m.record_ttft(float(rng.uniform(0.0005, 2.0)), tenant=tenant)
            m.record_queue_wait(float(rng.uniform(0, 0.5)), tenant=tenant)
        elif r < 0.3:
            m.record_tpot([float(x) for x in rng.uniform(1e-3, 0.2, 5)],
                          tenant=tenant)
            m.record_e2e(float(rng.uniform(0.01, 30.0)), tenant=tenant)
        elif r < 0.45:
            m.record_step(float(rng.uniform(1e-3, 0.02)),
                          int(rng.integers(0, 9)), 8, int(rng.integers(0, 9)))
        elif r < 0.55:
            m.record_prefill(float(rng.uniform(0.005, 0.05)))
        elif r < 0.65:
            m.record_admission(int(rng.integers(0, 10)), tenant,
                               int(rng.integers(0, 5)))
            m.record_queue_depth(int(rng.integers(0, 10)), tenant,
                                 int(rng.integers(0, 5)))
        elif r < 0.7:
            m.record_rejection(tenant)
            m.record_shed(tenant)
            m.record_preemption(tenant)
        elif r < 0.75:
            m.record_spec([int(a) for a in rng.integers(0, 5, 3)], 4)
        elif r < 0.8:
            m.record_kv(int(rng.integers(0, 60)), int(rng.integers(0, 60)),
                        64, int(rng.integers(0, 9)), bytes_per_page=98304)
            m.record_prefix_stats(3, 4, 48, 200)
        elif r < 0.85:
            m.record_adapters(2, 1, 3, ["x"], 5, 2, 1, bytes_per_slot=4096)
        else:
            for fn in (m.record_completion, m.record_expiry,
                       m.record_cancellation, m.record_engine_error,
                       m.record_watchdog_trip, m.record_admission_blocked,
                       m.record_chunked_admission, m.record_prefill_chunk):
                fn()


@pytest.fixture
def fake_clock(monkeypatch):
    """``time.monotonic`` stepping 0.25 s a call on the test's thread; a
    thread left by an earlier test in the worker keeps the real clock
    (its calls would otherwise step the test's clock between reads)."""
    t = [1000.0]
    real, me = time.monotonic, threading.get_ident()

    def clock():
        if threading.get_ident() != me:
            return real()
        t[0] += 0.25
        return t[0]

    monkeypatch.setattr(time, "monotonic", clock)
    return t


def test_metrics_snapshots_and_exposition_match_jax(fake_clock):
    snaps, texts = {}, {}
    for name, metrics_cls, registry_cls in (("jax", JMetrics, JRegistry),
                                            ("port", TMetrics, TRegistry)):
        fake_clock[0] = 1000.0
        m = metrics_cls()
        _record_sequence(m, np.random.default_rng(11))
        snaps[name] = m.snapshot()
        reg = registry_cls()
        m.publish(reg)
        m.publish(reg)  # idempotent: the histograms drain once
        texts[name] = reg.prometheus_text()
    assert sorted(snaps["port"]) == sorted(snaps["jax"])
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"]["watchdog_trips"] > 0
    assert snaps["port"]["tokens_per_sec_wall"] > 0
    assert texts["port"] == texts["jax"]
    for stem in ("ttft", "tpot", "queue_wait", "e2e"):
        assert f'serving_{stem}_seconds_bucket{{tenant="t0",le="0.001"}}' \
            in texts["port"]


def test_latency_histogram_golden_exposition():
    """The JAX package's ``tests/test_slo.py`` golden exposition, on the
    port: exact cumulative ``le`` buckets and ``_sum``/``_count``, and a
    second publish never counts twice."""
    m = TMetrics()
    for v in (0.0005, 0.003, 0.003, 0.2):
        m.record_ttft(v, tenant="t0")
    m.record_tpot([0.004, 0.09], tenant="t0")
    reg = TRegistry()
    m.publish(reg)
    first = reg.prometheus_text()
    assert 'serving_ttft_seconds_bucket{tenant="t0",le="0.001"} 1' in first
    assert 'serving_ttft_seconds_bucket{tenant="t0",le="0.0025"} 1' in first
    assert 'serving_ttft_seconds_bucket{tenant="t0",le="0.005"} 3' in first
    assert 'serving_ttft_seconds_bucket{tenant="t0",le="0.1"} 3' in first
    assert 'serving_ttft_seconds_bucket{tenant="t0",le="0.25"} 4' in first
    assert 'serving_ttft_seconds_bucket{tenant="t0",le="+Inf"} 4' in first
    assert 'serving_ttft_seconds_sum{tenant="t0"} 0.2065' in first
    assert 'serving_ttft_seconds_count{tenant="t0"} 4' in first
    assert 'serving_tpot_seconds_bucket{tenant="t0",le="0.005"} 1' in first
    assert 'serving_tpot_seconds_count{tenant="t0"} 2' in first
    m.publish(reg)
    assert reg.prometheus_text() == first
    m.record_ttft(0.0005, tenant="t0")
    m.publish(reg)
    assert 'serving_ttft_seconds_count{tenant="t0"} 5' \
        in reg.prometheus_text()
    with pytest.raises(ValueError, match="window"):
        TMetrics(window=0)


def _fill_registry(reg):
    c = reg.counter("req_total", "requests", labelnames=("code",))
    c.labels(code="200").inc(3)
    c.labels(code='5"03\n').inc()
    reg.counter("plain_total").inc(2.5)
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.inc(-2)
    reg.gauge("ratio", labelnames=("a", "b")).labels(a="x", b="y").set(
        float("nan"))
    reg.gauge("big").set(1e16)
    reg.gauge("neg_inf").set(float("-inf"))
    h = reg.histogram("lat_seconds", "latency", labelnames=("t",),
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, 0.1):
        h.labels(t="q").observe(v)
    reg.histogram("plain_hist").observe(0.3)
    return reg


def test_prometheus_text_byte_equal():
    want = _fill_registry(JRegistry()).prometheus_text()
    reg = _fill_registry(TRegistry())
    assert reg.prometheus_text() == want == prometheus_text(reg)
    # str(): the NaN gauge is equal only as text.
    assert str(reg.snapshot()) == str(_fill_registry(JRegistry()).snapshot())
    for bad in (lambda r: r.counter("x").inc(-1),
                lambda r: r.gauge("bad name"),
                lambda r: r.histogram("h", buckets=(2.0, 1.0))):
        for cls in (JRegistry, TRegistry):
            with pytest.raises((ValueError, TypeError)):
                bad(cls())
    with pytest.raises(ValueError, match="already registered"):
        r = TRegistry()
        r.counter("dup")
        r.gauge("dup")


def _finished(mod, tenant, ttft_s, tpot_s, n_tokens, state, t0):
    """A finished Request with a made-up timeline (stamps from ``t0``),
    built alike in both packages."""
    req = mod.Request(prompt=np.asarray([1, 2, 3], np.int32),
                      max_new_tokens=n_tokens, tenant=tenant)
    req.submitted_at = t0
    req.first_admitted_at = t0 + 1e-3
    req.admitted_at = req.first_admitted_at
    req.prefill_secs = max(ttft_s - 1e-3, 0.0)
    req.token_times = [t0 + ttft_s + i * tpot_s for i in range(n_tokens)]
    req.first_token_at = req.token_times[0] if n_tokens else None
    req.tokens = list(range(n_tokens))
    req.state = state
    req.finished_at = t0 + ttft_s + n_tokens * tpot_s
    return req


def _timelines(mod, seed=5, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(_finished(
            mod, str(rng.choice(["a", "b", "c"])),
            float(rng.uniform(0.005, 0.6)), float(rng.uniform(0.002, 0.09)),
            int(rng.integers(1, 9)),
            str(rng.choice(["done"] * 6 + ["error", "expired", "shed"])),
            100.0 + i))
    return out


def test_slo_tracker_and_aggregate_match_jax():
    policy = dict(ttft_ms=200.0, tpot_ms=40.0, target=0.95)
    trackers = {
        "jax": j_slo.SloTracker(j_slo.SloPolicy(**policy), JMetrics(),
                                keep_timelines=32, trace=False),
        "port": t_slo.SloTracker(t_slo.SloPolicy(**policy), TMetrics(),
                                 keep_timelines=32),
    }
    reqs = {"jax": _timelines(j_sched), "port": _timelines(t_sched)}
    for name, tracker in trackers.items():
        for req in reqs[name]:
            tracker.track(req)
        for req in reqs[name][:-3]:  # three stay in flight
            tracker.observe(req)
    for a, b in zip(reqs["jax"], reqs["port"]):
        ta, tb = a.timeline(), b.timeline()
        ta.pop("id"), tb.pop("id")
        assert ta == tb
    snaps = {k: t.snapshot() for k, t in trackers.items()}
    assert snaps["jax"] == snaps["port"]
    assert snaps["port"]["active_requests"] == 3
    assert 0.0 < snaps["port"]["attainment"]["ttft"] < 1.0
    agg = {}
    for name, mod in (("jax", j_slo), ("port", t_slo)):
        tls = trackers[name].timelines(since=110.0, tenants={"a", "b"})
        agg[name] = mod.aggregate_timelines(tls, trackers[name].policy)
    assert agg["jax"] == agg["port"] and agg["port"]["n_requests"] > 5
    texts = {}
    for name, reg in (("jax", JRegistry()), ("port", TRegistry())):
        trackers[name].publish(reg)
        texts[name] = reg.prometheus_text()
    assert texts["jax"] == texts["port"]
    assert 'serving_slo_attainment{slo="ttft",tenant="all"}' in texts["port"]
    # The completion-side feeds reached each tracker's metrics alike.
    assert (trackers["jax"]._metrics.snapshot()["tpot_p99_ms"]
            == trackers["port"]._metrics.snapshot()["tpot_p99_ms"] > 0)
    payload = trackers["port"].context_payload()
    assert len(payload["recent"]) == 16 and len(payload["active"]) == 3
    for mod in (j_slo, t_slo):
        with pytest.raises(ValueError, match="positive"):
            mod.SloPolicy(ttft_ms=0)
        with pytest.raises(ValueError, match="target"):
            mod.SloPolicy(target=1.0)


def test_breaker_quantile_and_ladder_transitions_match_jax():
    seq = []
    for mod in (j_overload, t_overload):
        t = [0.0]
        b = mod.CircuitBreaker(threshold=2, cooldown_s=5.0,
                               clock=lambda: t[0])
        rec = []
        for step, (dt, action) in enumerate(
                [(0, "fail"), (0, "allow"), (0, "fail"), (4.9, "allow"),
                 (0.2, "state"), (0, "allow"), (0, "allow"),
                 (0, "fail"), (5.2, "allow"), (0, "ok"), (0, "fail"),
                 (0, "fail"), (0, "fail"), (6, "allow"), (0, "ok")]):
            t[0] += dt
            if action == "fail":
                b.record_failure()
            elif action == "ok":
                b.record_success()
            rec.append((b.allow() if action == "allow" else None, b.state,
                        b.gauge_value()))
        rec.append([dict(tr) for tr in b.transitions])
        q = mod.RollingQuantile(window=16, min_samples=4, default=2.5)
        rng = np.random.default_rng(3)
        for v in rng.uniform(0, 1, 40):
            q.observe(float(v))
            rec.append((q.quantile(0.99), q.quantile(0.5), len(q)))
        calls = []

        class _Server:
            def set_degradation(self, level, cfg):
                calls.append(("level", level, cfg.clamp_tokens))

            def shed_queued(self, below, retry_after, cause=""):
                calls.append(("shed", below, retry_after))
                return 2

        ladder = mod.DegradationLadder(
            [_Server()], mod.DegradationConfig(clamp_tokens=8,
                                               shed_below_priority=1))
        for move in ("up", "up", 4, "down", 4, 9, -3, "up"):
            if move == "up":
                ladder.step_up("burn")
            elif move == "down":
                ladder.step_down("recovery")
            else:
                ladder.set_level(move, "set")
        snap = ladder.snapshot()
        for row in snap["history"]:
            row.pop("t")
        reg = JRegistry() if mod is j_overload else TRegistry()
        ladder.publish(reg)
        rec += [calls, snap, reg.prometheus_text(), mod.RUNGS]
        with pytest.raises(ValueError, match="clamp_tokens"):
            mod.DegradationConfig(clamp_tokens=0)
        seq.append(rec)
    assert seq[0] == seq[1]
    assert seq[1][-3]["shed_total"] == 4 and seq[1][-3]["level"] == 1

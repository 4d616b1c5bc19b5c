"""SLO attainment accounting over request-lifecycle timelines (the JAX
package's ``serving/slo.py``).

The capacity question, "how much load can this deployment take before it
stops being good?", is answered in SLO terms: what fraction of requests
met their time-to-first-token (TTFT) and time-per-output-token (TPOT)
targets.

* every :class:`~ml_trainer_tpu_torch.serving.scheduler.Request` records
  its lifecycle (submit -> queue -> admit -> prefill -> tokens -> finish
  or preempt) as monotonic stamps and ``mark()`` events, and
  ``Request.timeline()`` renders it as one JSON record;
* :class:`SloTracker` is the request's finish observer (``Server`` wires
  it at submit): it keeps per-tenant attainment against an
  :class:`SloPolicy`, feeds the completion-side latencies (TPOT,
  end-to-end) into ``ServingMetrics`` and keeps a bounded ring of the
  last timelines (``timelines``, ``context_payload``);
* ``publish()`` mirrors attainment and the **burn rate**, ``(1 -
  attainment) / (1 - target)``, into the metrics registry: 1.0 spends
  the error budget exactly as fast as the target allows, above 1 faster.

Host-only: timelines are plain host data.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, Optional

from ml_trainer_tpu_torch.serving.metrics import ServingMetrics


@dataclasses.dataclass(frozen=True)
class SloPolicy:
    """Latency targets one deployment promises its callers.

    ``ttft_ms``: submit -> first token budget per request.
    ``tpot_ms``: per-request MEAN inter-token latency budget (requests
    with fewer than two tokens have no inter-token gap and trivially
    attain it).  ``target``: the attainment objective (fraction of
    requests that must meet each budget) the burn rate is relative to.
    Requests that finish in an error/expired state missed both SLOs by
    definition — a failed request is not a fast request."""

    ttft_ms: float = 250.0
    tpot_ms: float = 50.0
    target: float = 0.99

    def __post_init__(self):
        if self.ttft_ms <= 0 or self.tpot_ms <= 0:
            raise ValueError(
                f"SLO budgets must be positive, got ttft_ms={self.ttft_ms} "
                f"tpot_ms={self.tpot_ms}"
            )
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"target must be in (0, 1), got {self.target}"
            )


def _attained(tl: dict, policy: SloPolicy) -> Dict[str, bool]:
    """Per-SLO verdict for one finished timeline."""
    ok_state = tl["state"] == "done"
    ttft = tl.get("ttft_ms")
    tpot_mean = (tl.get("tpot_ms") or {}).get("mean")
    return {
        "ttft": bool(
            ok_state and ttft is not None and ttft <= policy.ttft_ms
        ),
        "tpot": bool(
            ok_state and (tpot_mean is None or tpot_mean <= policy.tpot_ms)
        ),
    }


def _pct(sorted_vals, q):
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return round(sorted_vals[i], 3)


def aggregate_timelines(timelines, policy: SloPolicy) -> dict:
    """Aggregation of one window's finished timelines: latency
    percentiles (ms), attainment and burn rate, independent of the
    tracker's lifetime accounting (``timelines(since=...)`` scopes the
    window).  TPOT percentiles are over each request's MEAN inter-token
    latency, the quantity the attainment judges."""
    tls = list(timelines)
    budget = 1.0 - policy.target

    def _dist(values):
        vals = sorted(v for v in values if v is not None)
        return {
            "p50": _pct(vals, 0.5),
            "p99": _pct(vals, 0.99),
            "n": len(vals),
        }

    ok = {"ttft": 0, "tpot": 0}
    for tl in tls:
        v = _attained(tl, policy)
        for k in ok:
            ok[k] += int(v[k])
    n = len(tls)
    attainment = {k: round(ok[k] / n, 4) if n else 1.0 for k in ok}
    return {
        "n_requests": n,
        "n_failed": sum(1 for tl in tls if tl["state"] != "done"),
        "ttft_ms": _dist(tl["ttft_ms"] for tl in tls),
        "tpot_ms": _dist((tl["tpot_ms"] or {}).get("mean") for tl in tls),
        "queue_wait_ms": _dist(tl["queue_wait_ms"] for tl in tls),
        "prefill_ms": _dist(tl["prefill_ms"] for tl in tls),
        "e2e_ms": _dist(tl["e2e_ms"] for tl in tls),
        "attainment": attainment,
        "burn_rate": {
            k: round((1.0 - attainment[k]) / budget, 4) if budget > 0
            else 0.0
            for k in attainment
        },
    }


class _TenantLedger:
    __slots__ = ("requests", "ok", "failed")

    def __init__(self):
        self.requests = 0
        self.ok = {"ttft": 0, "tpot": 0}
        self.failed = 0


class SloTracker:
    """Thread-safe per-tenant SLO attainment over finished requests.

    ``track()`` registers a request in flight, ``observe()`` consumes it
    at its finish (installed as ``Request.observer``, so every terminal
    path, EOS, budget, deadline, preemption give-up, watchdog or engine
    death, lands here exactly once), and ``snapshot()``/``publish()``
    read the accounting."""

    def __init__(self, policy: Optional[SloPolicy] = None,
                 metrics: Optional[ServingMetrics] = None,
                 keep_timelines: int = 64):
        if keep_timelines < 1:
            raise ValueError(
                f"keep_timelines must be >= 1, got {keep_timelines}"
            )
        self.policy = policy if policy is not None else SloPolicy()
        self._metrics = metrics
        self._lock = threading.Lock()
        self._active: Dict[int, object] = {}       # id -> live Request
        self._timelines: collections.deque = collections.deque(
            maxlen=keep_timelines
        )
        self._tenants: Dict[str, _TenantLedger] = {}

    # -- recording -------------------------------------------------------

    def track(self, req) -> None:
        """Register a request in flight (``context_payload`` then shows
        its timeline so far).  A request that already finished (a queued
        expiry can race the submit path) is not registered again:
        ``observe`` popped it already."""
        with self._lock:
            if not req._observed:
                self._active[req.id] = req

    def forget(self, req) -> None:
        """Drop an in-flight registration without consuming it: a
        cancelled request (``Server.cancel``) is no SLO miss, so the
        accounting neither keeps its entry nor claims its timeline."""
        with self._lock:
            self._active.pop(req.id, None)

    def observe(self, req) -> None:
        """Consume one FINISHED request's timeline into the accounting.
        Called from ``Request.finish`` (any thread, exactly once)."""
        tl = req.timeline()
        verdict = _attained(tl, self.policy)
        with self._lock:
            self._active.pop(tl["id"], None)
            self._timelines.append(tl)
            t = self._tenants.get(tl["tenant"])
            if t is None:
                t = self._tenants[tl["tenant"]] = _TenantLedger()
            t.requests += 1
            if tl["state"] != "done":
                t.failed += 1
            for k, ok in verdict.items():
                if ok:
                    t.ok[k] += 1
        # The completion-side latency feeds (the admission side, TTFT and
        # queue wait, is recorded by the engine at the first token) run
        # outside the tracker lock.
        if self._metrics is not None:
            deltas = req.tpot_deltas()
            if deltas:
                self._metrics.record_tpot(deltas, tenant=tl["tenant"])
            if tl["e2e_ms"] is not None:
                self._metrics.record_e2e(
                    tl["e2e_ms"] / 1e3, tenant=tl["tenant"]
                )

    # -- reading ---------------------------------------------------------

    def _burn(self, attainment: float) -> float:
        budget = 1.0 - self.policy.target
        return round((1.0 - attainment) / budget, 4) if budget > 0 else 0.0

    def snapshot(self) -> dict:
        """Point-in-time attainment accounting (JSON-safe)."""
        with self._lock:
            tenants = {
                name: (t.requests, dict(t.ok), t.failed)
                for name, t in self._tenants.items()
            }
            n_active = len(self._active)
        total = sum(r for r, _, _ in tenants.values())
        ok_total = {
            k: sum(ok[k] for _, ok, _ in tenants.values())
            for k in ("ttft", "tpot")
        }

        def _att(ok, n):
            return round(ok / n, 4) if n else 1.0

        return {
            "policy": dataclasses.asdict(self.policy),
            "requests_observed": total,
            "requests_failed": sum(f for _, _, f in tenants.values()),
            "active_requests": n_active,
            "attainment": {
                k: _att(ok_total[k], total) for k in ok_total
            },
            "burn_rate": {
                k: self._burn(_att(ok_total[k], total)) for k in ok_total
            },
            "tenants": {
                name: {
                    "requests": r,
                    "failed": f,
                    "attainment": {k: _att(ok[k], r) for k in ok},
                    "burn_rate": {
                        k: self._burn(_att(ok[k], r)) for k in ok
                    },
                }
                for name, (r, ok, f) in sorted(tenants.items())
            },
        }

    def publish(self, registry=None) -> dict:
        """Mirror attainment + burn rate into the registry (and return
        the snapshot).  One labeled series per (slo, tenant), plus the
        ``tenant="all"`` aggregate and the policy targets — everything a
        dashboard needs to plot capacity vs SLO."""
        from ml_trainer_tpu_torch.telemetry.registry import default_registry

        r = registry if registry is not None else default_registry()
        snap = self.snapshot()
        att = r.gauge(
            "serving_slo_attainment",
            "fraction of finished requests meeting the SLO budget",
            labelnames=("slo", "tenant"),
        )
        burn = r.gauge(
            "serving_slo_burn_rate",
            "(1 - attainment) / (1 - target); >1 burns error budget "
            "faster than the target sustains",
            labelnames=("slo", "tenant"),
        )
        target = r.gauge(
            "serving_slo_target_ms", "SLO latency budget",
            labelnames=("slo",),
        )
        target.labels(slo="ttft").set(self.policy.ttft_ms)
        target.labels(slo="tpot").set(self.policy.tpot_ms)
        for k in ("ttft", "tpot"):
            att.labels(slo=k, tenant="all").set(snap["attainment"][k])
            burn.labels(slo=k, tenant="all").set(snap["burn_rate"][k])
        for name, t in snap["tenants"].items():
            for k in ("ttft", "tpot"):
                att.labels(slo=k, tenant=name).set(t["attainment"][k])
                burn.labels(slo=k, tenant=name).set(t["burn_rate"][k])
        r.gauge(
            "serving_slo_requests_observed",
            "finished requests consumed by the SLO accounting",
        ).set(float(snap["requests_observed"]))
        return snap

    def timelines(self, since: Optional[float] = None,
                  tenants=None, predicate=None) -> list:
        """The retained finished timelines (oldest first), optionally
        only those submitted at or after the monotonic stamp ``since``
        (one timed window's aggregation), of ``tenants`` (a container of
        names) and passing ``predicate`` (timeline dict -> bool)."""
        with self._lock:
            tls = list(self._timelines)
        if since is not None:
            tls = [tl for tl in tls if tl["submitted_at"] >= since]
        if tenants is not None:
            tls = [tl for tl in tls if tl.get("tenant") in tenants]
        if predicate is not None:
            tls = [tl for tl in tls if predicate(tl)]
        return tls

    def context_payload(self) -> dict:
        """The forensics context: the policy, the last 16 finished
        timelines and the timeline so far of every request in flight, so
        that a record of a watchdog trip names the requests it hurt with
        their lifecycles."""
        with self._lock:
            recent = list(self._timelines)
            active = list(self._active.values())
        return {
            "policy": dataclasses.asdict(self.policy),
            "recent": recent[-16:],
            "active": [req.timeline() for req in active],
        }

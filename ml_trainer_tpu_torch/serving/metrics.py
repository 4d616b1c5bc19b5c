"""Serving metrics: what a dashboard needs to judge a decode engine (the
JAX package's ``serving/metrics.py``, its snapshot's key set).

Tracked per engine, aggregated in-process:

* **time to first token** (TTFT): submit -> first token, split into the
  queue wait (submit -> first admission) and the prefill;
* **time per output token** (TPOT): the gaps between a request's pushed
  tokens, and the **end-to-end** latency (submit -> finish);
* **per-step decode latency** and **slot occupancy**: one decode step
  over all slots, and the share of the slots active in it;
* **tokens/s** over busy time (the sum of prefill and step seconds) and
  over wall time since the first step;
* **queue depth**, the per-tenant ledger, sheds, cancellations, engine
  errors and watchdog trips.

Every latency is taken on the host's clock at a point where the host
has read a result of the device (the prefill's first token, a decode
step's sampled tokens, the client's stream), so each spans the device
work before it and adds no synchronisation of its own.

``publish()`` mirrors the snapshot into the metrics registry
(``telemetry/registry.py``) as ``serving_*`` gauges plus the lifecycle
latency histograms, which the HTTP front end's ``GET /metrics`` serves
as Prometheus text; ``GET /metrics.json`` serves ``snapshot()``.

Concurrency: every ``record_*`` and ``snapshot()`` takes the one
instance lock, and ``publish`` holds it only to swap the pending
observations out, so a scrape never stalls the serving loop for longer
than that swap.  Every division in ``snapshot()`` is guarded.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return float(sorted_vals[i])


# Registry-histogram buckets for the spec acceptance distribution: one
# bucket per accepted-draft count.  Draft depths beyond 16 land in +Inf:
# acceptable resolution loss (spec_k above 16 is outside the useful
# range) in exchange for a FIXED bucket layout, which idempotent
# registration requires.
SPEC_ACCEPT_BUCKETS = tuple(float(i) for i in range(17))

# Latency histogram buckets (seconds) for the request-lifecycle
# distributions (TTFT / TPOT / queue-wait / end-to-end).  Sub-ms floor
# for a warm CPU decode tick, 60s ceiling for a cold-compile TTFT;
# FIXED so idempotent registration holds across servers in one process.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# The lifecycle latency histograms ``publish()`` maintains: snapshot
# field stem -> registry metric name.  Observations are queued by the
# ``record_*`` sites and DRAINED into the histograms at publish (the
# ``serving_spec_accept`` delta pattern: snapshots are point-in-time,
# histogram observations are not, so repeated scrapes never
# double-count).
LATENCY_HISTOGRAMS = {
    "ttft": "serving_ttft_seconds",
    "tpot": "serving_tpot_seconds",
    "queue_wait": "serving_queue_wait_seconds",
    "e2e": "serving_e2e_seconds",
}


class ServingMetrics:
    """Thread-safe rolling serving metrics (bounded windows)."""

    def __init__(self, window: int = 2048):
        if window < 1:
            # deque(maxlen=0) silently discards every observation — a
            # scrape would then report all-zero latencies while traffic
            # flows, which reads as an outage that is not happening.
            raise ValueError(f"window must be >= 1, got {window}")
        self._lock = threading.Lock()
        self._ttft = collections.deque(maxlen=window)
        self._prefill_secs = collections.deque(maxlen=window)
        self._step_secs = collections.deque(maxlen=window)
        self._occupancy = collections.deque(maxlen=window)
        # Request-lifecycle latency windows (snapshot percentiles) and
        # the publish-drained histogram queues: each entry is
        # ``(seconds, tenant)`` awaiting its one observation into the
        # registry histogram named in LATENCY_HISTOGRAMS.
        self._queue_wait = collections.deque(maxlen=window)
        self._tpot = collections.deque(maxlen=window)
        self._e2e = collections.deque(maxlen=window)
        self._hist_pending: dict = {k: [] for k in LATENCY_HISTOGRAMS}
        self.tokens_total = 0
        self.steps_total = 0
        self.busy_secs = 0.0
        self.requests_admitted = 0
        self.requests_rejected = 0
        self.requests_completed = 0
        self.requests_expired = 0
        # Overload control (serving/overload.py): requests shed by the
        # degradation ladder (structured 503 + retry_after), and
        # hedging losers cancelled after their duplicate won.
        self.requests_shed = 0
        self.requests_cancelled = 0
        # Resilience counters: engine-loop exceptions survived, and
        # watchdog wedge detections (each of which failed all in-flight
        # requests and poisoned the server).
        self.engine_errors = 0
        self.watchdog_trips = 0
        self.max_active_slots = 0
        self.queue_depth = 0
        # Paged KV, prefix cache and multi-tenant scheduling: pool
        # occupancy gauges, token-weighted prefix hit accounting,
        # preemption counters, and a per-tenant ledger published as
        # labeled ``serving_tenant_*`` gauges.
        self.kv_pages_total = 0
        self.kv_pages_free = 0
        self.kv_pages_used = 0
        # Device bytes of one KV page (page geometry x dtype x layers x
        # K/V), so the pool gauges price in bytes as well as pages.
        self.kv_page_bytes = 0
        self.prefix_cache_nodes = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.preemptions_total = 0
        self.admissions_blocked = 0
        # Chunked prefill (engine prefill_chunk mode): admissions that
        # took the chunked path, and total prefill windows dispatched.
        self.chunked_admissions_total = 0
        self.prefill_chunks_total = 0
        # Batched LoRA adapter pool (serving/adapter_pool.py): slot
        # occupancy (free/used/total EXCLUDING the trash slot), resident
        # count, hit/load/eviction counters, and the device bytes one
        # slot occupies across every stack leaf — the pricing behind
        # serving_adapter_pool_bytes{state=}.
        self.adapter_slots_free = 0
        self.adapter_slots_used = 0
        self.adapter_slots_total = 0
        self.adapters_resident = 0
        self.adapter_hits = 0
        self.adapter_loads = 0
        self.adapter_evictions = 0
        self.adapter_slot_bytes = 0
        self._tenants: dict = {}
        # Speculative decoding (engine spec mode): acceptance accounting.
        # One histogram entry per (verify step, active slot); keys are
        # accepted-draft counts 0..K.
        self.spec_draft_k = 0
        self.spec_steps_total = 0
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_accept_hist: collections.Counter = collections.Counter()
        # Watermark of what publish() already observed into the registry
        # histogram: the snapshot is cumulative, histogram observations
        # are not, so publish() feeds only the delta.
        self._spec_hist_published: collections.Counter = collections.Counter()
        self._first_step_at: Optional[float] = None
        self._last_step_at: Optional[float] = None

    # -- recording -------------------------------------------------------

    def record_ttft(self, seconds: float,
                    tenant: Optional[str] = None) -> None:
        with self._lock:
            self._ttft.append(float(seconds))
            self._hist_pending["ttft"].append(
                (float(seconds), tenant or "default")
            )

    def record_queue_wait(self, seconds: float,
                          tenant: Optional[str] = None) -> None:
        """Submit -> first admission: the queueing half of TTFT (the
        other half is prefill compute), so saturation is attributable."""
        with self._lock:
            self._queue_wait.append(float(seconds))
            self._hist_pending["queue_wait"].append(
                (float(seconds), tenant or "default")
            )

    def record_tpot(self, deltas, tenant: Optional[str] = None) -> None:
        """Inter-token latencies (seconds) of one finished request —
        the client-observed time-per-output-token distribution."""
        with self._lock:
            for d in deltas:
                self._tpot.append(float(d))
                self._hist_pending["tpot"].append(
                    (float(d), tenant or "default")
                )

    def record_e2e(self, seconds: float,
                   tenant: Optional[str] = None) -> None:
        """Submit -> finish wall latency of one completed request."""
        with self._lock:
            self._e2e.append(float(seconds))
            self._hist_pending["e2e"].append(
                (float(seconds), tenant or "default")
            )

    def record_prefill(self, seconds: float, tokens: int = 1) -> None:
        """One out-of-band prefill: its latency counts as busy time and
        it emits the request's first token."""
        with self._lock:
            self._prefill_secs.append(float(seconds))
            self.busy_secs += float(seconds)
            self.tokens_total += int(tokens)

    def record_step(self, seconds: float, active_slots: int,
                    total_slots: int, tokens: int) -> None:
        now = time.monotonic()
        with self._lock:
            self._step_secs.append(float(seconds))
            self._occupancy.append(
                active_slots / total_slots if total_slots else 0.0
            )
            self.busy_secs += float(seconds)
            self.tokens_total += int(tokens)
            self.steps_total += 1
            self.max_active_slots = max(self.max_active_slots, active_slots)
            if self._first_step_at is None:
                self._first_step_at = now - seconds
            self._last_step_at = now

    def _tenant(self, tenant: str) -> dict:
        # Caller holds the lock.
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = {
                "admitted": 0, "rejected": 0, "preempted": 0,
                "queue_depth": 0,
            }
        return t

    def record_admission(self, queue_depth: int,
                         tenant: Optional[str] = None,
                         tenant_depth: Optional[int] = None) -> None:
        with self._lock:
            self.requests_admitted += 1
            self.queue_depth = int(queue_depth)
            if tenant is not None:
                t = self._tenant(tenant)
                t["admitted"] += 1
                if tenant_depth is not None:
                    t["queue_depth"] = int(tenant_depth)

    def record_rejection(self, tenant: Optional[str] = None) -> None:
        with self._lock:
            self.requests_rejected += 1
            if tenant is not None:
                self._tenant(tenant)["rejected"] += 1

    def record_completion(self) -> None:
        with self._lock:
            self.requests_completed += 1

    def record_expiry(self) -> None:
        with self._lock:
            self.requests_expired += 1

    def record_shed(self, tenant: Optional[str] = None) -> None:
        """One request shed by the degradation ladder (overload.py)."""
        with self._lock:
            self.requests_shed += 1
            if tenant is not None:
                t = self._tenant(tenant)
                t["shed"] = t.get("shed", 0) + 1

    def record_cancellation(self) -> None:
        """One hedging loser dropped after its duplicate won."""
        with self._lock:
            self.requests_cancelled += 1

    def record_engine_error(self) -> None:
        with self._lock:
            self.engine_errors += 1

    def record_watchdog_trip(self) -> None:
        with self._lock:
            self.watchdog_trips += 1

    def record_queue_depth(self, depth: int,
                           tenant: Optional[str] = None,
                           tenant_depth: Optional[int] = None) -> None:
        with self._lock:
            self.queue_depth = int(depth)
            if tenant is not None and tenant_depth is not None:
                self._tenant(tenant)["queue_depth"] = int(tenant_depth)

    def record_preemption(self, tenant: str) -> None:
        """One preempt-and-requeue under page pressure."""
        with self._lock:
            self.preemptions_total += 1
            self._tenant(tenant)["preempted"] += 1

    def record_admission_blocked(self) -> None:
        """An admission deferred because the page pool could not hold
        the prompt (the request re-queued, not rejected)."""
        with self._lock:
            self.admissions_blocked += 1

    def record_chunked_admission(self) -> None:
        """One long prompt admitted via the chunked-prefill path."""
        with self._lock:
            self.chunked_admissions_total += 1

    def record_prefill_chunk(self) -> None:
        """One chunked-prefill window dispatched (decode ticks run
        between windows — the interleaving behind unblocked TTFT)."""
        with self._lock:
            self.prefill_chunks_total += 1

    def record_kv(self, free: int, used: int, total: int,
                  prefix_nodes: int,
                  bytes_per_page: Optional[int] = None) -> None:
        """Paged-pool occupancy snapshot (allocatable pages — the trash
        page is excluded from ``total``).  ``bytes_per_page`` (device
        bytes of one page across all layers, K and V) turns the page
        counts into ``serving_kv_pool_bytes{state=}`` gauges."""
        with self._lock:
            self.kv_pages_free = int(free)
            self.kv_pages_used = int(used)
            self.kv_pages_total = int(total)
            self.prefix_cache_nodes = int(prefix_nodes)
            if bytes_per_page is not None:
                self.kv_page_bytes = int(bytes_per_page)

    def record_adapters(self, free: int, used: int, total: int,
                        resident, hits: int, loads: int, evictions: int,
                        bytes_per_slot: Optional[int] = None) -> None:
        """Adapter-pool snapshot (serving/adapter_pool.py): slot
        occupancy, cumulative hit/load/eviction counters, and the
        per-slot device-byte price."""
        with self._lock:
            self.adapter_slots_free = int(free)
            self.adapter_slots_used = int(used)
            self.adapter_slots_total = int(total)
            self.adapters_resident = len(resident) if not isinstance(
                resident, int
            ) else int(resident)
            self.adapter_hits = int(hits)
            self.adapter_loads = int(loads)
            self.adapter_evictions = int(evictions)
            if bytes_per_slot is not None:
                self.adapter_slot_bytes = int(bytes_per_slot)

    def record_prefix_stats(self, hits: int, misses: int,
                            hit_tokens: int, lookup_tokens: int) -> None:
        """Cumulative prefix-cache counters (token-weighted hit rate:
        hit_tokens / lookup_tokens)."""
        with self._lock:
            self.prefix_hits = int(hits)
            self.prefix_misses = int(misses)
            self.prefix_hit_tokens = int(hit_tokens)
            self.prefix_lookup_tokens = int(lookup_tokens)

    def record_spec(self, accepted_counts, draft_k: int) -> None:
        """One speculative verify step: per-active-slot accepted-draft
        counts (each slot advanced ``accepted + 1`` tokens)."""
        with self._lock:
            self.spec_draft_k = int(draft_k)
            self.spec_steps_total += 1
            for a in accepted_counts:
                self.spec_accept_hist[int(a)] += 1
                self.spec_drafted_tokens += int(draft_k)
                self.spec_accepted_tokens += int(a)

    # -- reading ---------------------------------------------------------

    def snapshot(self) -> dict:
        """One flat dict of the current aggregates (JSON-safe floats).
        The lock is held to copy the windows and read the counters; the
        windows are sorted after it is released."""
        with self._lock:
            windows = [list(w) for w in (
                self._ttft, self._step_secs, self._prefill_secs,
                self._queue_wait, self._tpot, self._e2e)]
            wall = (
                self._last_step_at - self._first_step_at
                if self._first_step_at is not None
                and self._last_step_at is not None
                and self._last_step_at > self._first_step_at
                else 0.0
            )
            occ = (
                sum(self._occupancy) / len(self._occupancy)
                if self._occupancy else 0.0
            )
            rest = self._counters_snapshot(wall, occ)
        ttft, steps, prefill, queue_wait, tpot, e2e = (
            sorted(w) for w in windows)
        return {
            "ttft_p50_ms": round(_percentile(ttft, 0.5) * 1e3, 3),
            "ttft_p99_ms": round(_percentile(ttft, 0.99) * 1e3, 3),
            "decode_step_p50_ms": round(_percentile(steps, 0.5) * 1e3, 3),
            "decode_step_p99_ms": round(_percentile(steps, 0.99) * 1e3, 3),
            "prefill_p50_ms": round(_percentile(prefill, 0.5) * 1e3, 3),
            # TTFT decomposition: submit -> admit queue wait against the
            # admit -> first token prefill, so a saturated queue and a
            # slow prefill read differently.
            "prefill_p99_ms": round(_percentile(prefill, 0.99) * 1e3, 3),
            "queue_wait_p50_ms": round(
                _percentile(queue_wait, 0.5) * 1e3, 3),
            "queue_wait_p99_ms": round(
                _percentile(queue_wait, 0.99) * 1e3, 3),
            "tpot_p50_ms": round(_percentile(tpot, 0.5) * 1e3, 3),
            "tpot_p99_ms": round(_percentile(tpot, 0.99) * 1e3, 3),
            "e2e_p50_ms": round(_percentile(e2e, 0.5) * 1e3, 3),
            "e2e_p99_ms": round(_percentile(e2e, 0.99) * 1e3, 3),
            **rest,
        }

    def _counters_snapshot(self, wall: float, occ: float) -> dict:
        # Caller holds the lock.
        return {
            "tokens_total": self.tokens_total,
            "decode_steps_total": self.steps_total,
            "tokens_per_sec_busy": round(
                self.tokens_total / self.busy_secs, 1
            ) if self.busy_secs > 0 else 0.0,
            "tokens_per_sec_wall": round(
                self.tokens_total / wall, 1
            ) if wall > 0 else 0.0,
            "slot_occupancy_mean": round(occ, 4),
            "max_active_slots": self.max_active_slots,
            "queue_depth": self.queue_depth,
            "requests_admitted": self.requests_admitted,
            "requests_rejected": self.requests_rejected,
            "requests_completed": self.requests_completed,
            "requests_expired": self.requests_expired,
            "requests_shed": self.requests_shed,
            "requests_cancelled": self.requests_cancelled,
            "engine_errors": self.engine_errors,
            "watchdog_trips": self.watchdog_trips,
            "kv_pages_total": self.kv_pages_total,
            "kv_pages_free": self.kv_pages_free,
            "kv_pages_used": self.kv_pages_used,
            # Page counts priced in device bytes (geometry × dtype):
            # the serving end of the HBM ledger.
            "kv_pool_bytes": {
                "free": self.kv_pages_free * self.kv_page_bytes,
                "used": self.kv_pages_used * self.kv_page_bytes,
                "total": self.kv_pages_total * self.kv_page_bytes,
            },
            "prefix_cache_nodes": self.prefix_cache_nodes,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_tokens_saved": self.prefix_hit_tokens,
            "prefix_hit_rate": round(
                self.prefix_hit_tokens / self.prefix_lookup_tokens, 4
            ) if self.prefix_lookup_tokens else 0.0,
            "preemptions_total": self.preemptions_total,
            "admissions_blocked": self.admissions_blocked,
            "chunked_admissions_total": self.chunked_admissions_total,
            "prefill_chunks_total": self.prefill_chunks_total,
            "adapter_slots_free": self.adapter_slots_free,
            "adapter_slots_used": self.adapter_slots_used,
            "adapter_slots_total": self.adapter_slots_total,
            "adapters_resident": self.adapters_resident,
            "adapter_hits_total": self.adapter_hits,
            "adapter_loads_total": self.adapter_loads,
            "adapter_evictions_total": self.adapter_evictions,
            # Slot counts priced in device bytes (stack geometry x
            # dtype): the adapter end of the HBM ledger, beside
            # kv_pool_bytes.
            "adapter_pool_bytes": {
                "free": self.adapter_slots_free
                * self.adapter_slot_bytes,
                "used": self.adapter_slots_used
                * self.adapter_slot_bytes,
                "total": self.adapter_slots_total
                * self.adapter_slot_bytes,
            },
            "tenants": {
                name: dict(stats)
                for name, stats in sorted(self._tenants.items())
            },
            "spec_draft_k": self.spec_draft_k,
            "spec_steps_total": self.spec_steps_total,
            "spec_drafted_tokens": self.spec_drafted_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_acceptance_rate": round(
                self.spec_accepted_tokens / self.spec_drafted_tokens, 4
            ) if self.spec_drafted_tokens else 0.0,
            # Mean tokens committed per slot per verify step (1..K+1).
            "spec_tokens_per_step": round(
                sum((a + 1) * c for a, c in self.spec_accept_hist.items())
                / sum(self.spec_accept_hist.values()), 3
            ) if self.spec_accept_hist else 0.0,
            "spec_accept_hist": {
                str(a): self.spec_accept_hist[a]
                for a in sorted(self.spec_accept_hist)
            },
        }

    def publish(self, registry=None) -> dict:
        """Mirror the snapshot into the telemetry registry
        (``telemetry/registry.py``) as ``serving_*`` gauges, and return
        the snapshot.  Gauges, not counters: the snapshot is a
        point-in-time view and several of its fields move both ways
        (queue depth, occupancy).

        The spec acceptance distribution is the exception: it publishes
        as the registry's REAL ``Histogram`` type
        (``serving_spec_accept``, one bucket per accepted-draft count),
        so Prometheus scrapes get proper cumulative ``_bucket{le=...}``
        exposition and ``histogram_quantile`` works on it.  The snapshot
        counts are cumulative while histogram observations are not, so a
        per-instance watermark feeds only the delta — publish() stays
        idempotent under repeated scrapes and safe under the concurrent
        record/scrape hammer (the watermark update holds the instance
        lock)."""
        from ml_trainer_tpu_torch.telemetry.registry import default_registry

        r = registry if registry is not None else default_registry()
        snap = self.snapshot()
        # Request-lifecycle latency histograms (TTFT / TPOT / queue-wait
        # / e2e): drain the pending observations queued by record_* into
        # the registry's REAL Histogram type — proper cumulative
        # ``_bucket{le=...}`` exposition, per-tenant labels, and
        # publish() stays idempotent under repeated scrapes (each
        # observation is consumed exactly once).
        with self._lock:
            drained = {
                k: v for k, v in self._hist_pending.items() if v
            }
            for k in drained:
                self._hist_pending[k] = []
        for stem, obs in drained.items():
            h = r.histogram(
                LATENCY_HISTOGRAMS[stem],
                f"request {stem} latency (seconds)",
                labelnames=("tenant",),
                buckets=LATENCY_BUCKETS,
            )
            for seconds, tenant in obs:
                h.labels(tenant=tenant).observe(seconds)
        for key, value in snap.items():
            if key == "tenants":
                # Per-tenant ledger -> labeled serving_tenant_* gauges:
                # one series per (field, tenant).
                for tenant, stats in value.items():
                    for fname, fval in stats.items():
                        r.gauge(
                            f"serving_tenant_{fname}",
                            f"per-tenant {fname}",
                            labelnames=("tenant",),
                        ).labels(tenant=tenant).set(float(fval))
                continue
            if key == "adapter_pool_bytes":
                g = r.gauge(
                    "serving_adapter_pool_bytes",
                    "LoRA adapter pool device bytes by state "
                    "(stack geometry x dtype, all targets/layers)",
                    labelnames=("state",),
                )
                for state_name, v in value.items():
                    g.labels(state=state_name).set(float(v))
                continue
            if key == "kv_pool_bytes":
                # Labeled by pool state, next to the kv_pages_* gauges,
                # so one scrape prices the serving engine's HBM.
                g = r.gauge(
                    "serving_kv_pool_bytes",
                    "paged KV pool device bytes by state "
                    "(page geometry x dtype x layers x K/V)",
                    labelnames=("state",),
                )
                for state_name, v in value.items():
                    g.labels(state=state_name).set(float(v))
                continue
            if key == "spec_accept_hist":
                h = r.histogram(
                    "serving_spec_accept",
                    "accepted draft tokens per verify step per slot",
                    buckets=SPEC_ACCEPT_BUCKETS,
                )
                with self._lock:
                    deltas = [
                        (int(a), int(c) - self._spec_hist_published[int(a)])
                        for a, c in value.items()
                    ]
                    for a, d in deltas:
                        self._spec_hist_published[a] += max(d, 0)
                for a, d in deltas:
                    for _ in range(d):
                        h.observe(float(a))
                continue
            r.gauge(f"serving_{key}").set(float(value))
        return snap

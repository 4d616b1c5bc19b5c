"""Admission control: weighted multi-tenant scheduling and slot
bookkeeping (the JAX package's ``serving/scheduler.py``).

* **Per-tenant queues and quotas.**  Every request carries a ``tenant``;
  each tenant has a :class:`TenantConfig`: admission ``weight``,
  ``max_active`` (the slots it may hold at once) and ``max_queued`` (its
  own watermark inside the global one).  An unknown tenant gets the
  default config, so one tenant at the default config is a bounded FIFO
  (arrival order, ``AdmissionError`` past the watermark).
* **Weighted admission (stride scheduling).**  Each admission charges
  the picked tenant ``1 / weight`` of virtual time, and ``acquire``
  picks the eligible tenant with the lowest pass: under contention a
  weight-3 tenant admits 3 times as often as a weight-1 tenant, and a
  tenant that comes back from idle starts at the current pass floor
  instead of spending its saved-up credit in a burst.
* **Priorities.**  Within a tenant, a higher ``priority`` admits first;
  ties admit in arrival order.
* **Preempt and requeue.**  The paged engine preempts under page
  pressure; ``requeue`` puts the victim back at the head of its tenant's
  queue (it keeps its arrival ``seq``) with its generated tokens, from
  which the re-admission resumes.

A queued request whose deadline passes is expired instead of admitted;
the engine expires active ones between decode steps.  Each request
records its lifecycle (``mark()`` events, the stamp of every pushed
token) for the SLO accounting (``slo.py``).
"""

from __future__ import annotations

import heapq
import itertools
import queue as _queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


class AdmissionError(RuntimeError):
    """The pending queue (global or the tenant's) is at its watermark,
    or the server is draining; the request was rejected."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it finished."""


class EngineUnhealthy(RuntimeError):
    """The serving engine is wedged or dead: the requests in flight were
    failed with a structured error and new submissions are refused until
    the server is replaced."""


_ids = itertools.count()

# Stream sentinel (queue items are plain ints otherwise).
_DONE = ("done", None)

DEFAULT_TENANT = "default"


@dataclass
class TenantConfig:
    """Per-tenant scheduling policy.

    ``weight``: share of admissions under contention (stride
    scheduling — a weight-2 tenant admits twice as often as weight-1).
    ``max_active``: concurrent slots the tenant may occupy (None =
    engine-wide limit only).  ``max_queued``: the tenant's own pending
    watermark inside the global ``max_queue`` (None = global only).
    """

    weight: float = 1.0
    max_active: Optional[int] = None
    max_queued: Optional[int] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.max_active is not None and self.max_active < 1:
            raise ValueError(
                f"max_active must be >= 1 or None, got {self.max_active}"
            )
        if self.max_queued is not None and self.max_queued < 0:
            raise ValueError(
                f"max_queued must be >= 0 or None, got {self.max_queued}"
            )



@dataclass
class Request:
    """One generation request moving through queue -> slot -> done.

    ``deadline`` is a budget in seconds from submission.  ``rng`` is the
    int seed of a sampled request (``temperature > 0``); token ``t`` is
    drawn with ``generate._token_seed(rng, t)``, so a request reproduces
    the port's ``generate(..., rng=seed)`` for the same prompt.
    ``tenant``/``priority`` feed the multi-tenant scheduler."""

    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    rng: Optional[int] = None
    eos_token_id: Optional[int] = None
    deadline: Optional[float] = None
    tenant: str = DEFAULT_TENANT
    priority: int = 0
    # The LoRA adapter this request decodes with (``serving/
    # adapter_pool.py``); None is the base model (slot 0, the trash
    # adapter: bitwise an engine without adapters).
    adapter: Optional[str] = None

    id: int = field(default_factory=lambda: next(_ids))
    submitted_at: float = field(default_factory=time.monotonic)
    state: str = "queued"  # queued | active | done | expired | error | shed
    slot: int = -1
    tokens: list = field(default_factory=list)
    # Speculative decoding (engine spec mode): this request's verify
    # steps and the drafts they accepted.
    spec_steps: int = 0
    spec_accepted_tokens: int = 0
    # The scheduler's arrival seq (a requeued victim keeps its own, so it
    # resumes ahead of later arrivals), the preemptions, and the prompt
    # tokens the prefix cache let the prefill skip.
    seq: Optional[int] = None
    preemptions: int = 0
    prefix_hit_tokens: int = 0
    # Chunked prefill (engine prefill_chunk mode): the prefill windows
    # this request's prompt ran in (0: unchunked).
    prefill_chunks: int = 0
    # A "no_memory" admission is being retried: retries skip the prefix
    # cache's stats and LRU stamps.
    kv_blocked: bool = False
    # Overload control (``overload.py``): ``retry_after`` rides a shed
    # request's structured 503 (state "shed"); ``Server.cancel`` sets
    # ``cancel_requested`` and the serving loop drops the request, queued
    # or active, at its next boundary.
    retry_after: Optional[float] = None
    cancel_requested: bool = False
    # Disaggregated serving (``router.py``): a callable ``(request,
    # export)`` the serving loop hands the slot's KV export to right
    # after the prefill, instead of decoding here.
    migration_sink: object = None
    admitted_at: Optional[float] = None
    error: Optional[str] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # The lifecycle: the monotonic stamp of every pushed token (TPOT is
    # their gaps), the ordered ``mark()`` events, the FIRST admission
    # (queue wait; ``admitted_at`` moves on a preempt-resume), the
    # prefill seconds (each taken at a host read of the prefill's
    # token), and the finish observer (the server's SloTracker), called
    # once, before the stream's end.
    token_times: list = field(default_factory=list)
    events: list = field(default_factory=list)
    first_admitted_at: Optional[float] = None
    prefill_secs: float = 0.0
    observer: object = None
    _observed: bool = False
    _stream: _queue.Queue = field(default_factory=_queue.Queue)
    # Set at the finish: ``TokenStream.result`` waits on it instead of
    # waking for every token (each wake-up takes the GIL from the loop).
    _finished: threading.Event = field(default_factory=threading.Event)

    @property
    def deadline_at(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.submitted_at + self.deadline

    def expired(self, now: Optional[float] = None) -> bool:
        d = self.deadline_at
        return d is not None and (now or time.monotonic()) > d

    # -- engine-side hand-off -------------------------------------------

    def mark(self, event: str, **extra) -> None:
        """Append one lifecycle event to the request's timeline (the
        scheduler's and the engine's hand-off points call this; the list
        is read after ``finish`` or copied)."""
        row = {"t": round(time.monotonic(), 6), "event": event}
        if extra:
            row.update(extra)
        self.events.append(row)

    def push_token(self, token: int) -> None:
        now = time.monotonic()
        self.tokens.append(int(token))
        self.token_times.append(now)
        if self.first_token_at is None:
            self.first_token_at = now
        self._stream.put(int(token))

    def finish(self, state: str = "done", error: Optional[str] = None) -> None:
        self.state = state
        self.error = error
        self.finished_at = time.monotonic()
        self.mark("finish", state=state)
        # Observer BEFORE the stream sentinel: when result() returns,
        # the request's timeline is already in the SLO accounting.
        obs = self.observer
        if obs is not None and not self._observed:
            self._observed = True
            try:
                obs(self)
            except Exception:  # noqa: BLE001 - accounting never blocks the end
                pass
        self._stream.put(_DONE)
        self._finished.set()

    # -- timeline --------------------------------------------------------

    def tpot_deltas(self) -> list:
        """Inter-token latencies in seconds (the TPOT a client sees): the
        gaps between consecutive pushed tokens.  Empty under 2 tokens."""
        tt = list(self.token_times)
        return [tt[i] - tt[i - 1] for i in range(1, len(tt))]

    def timeline(self) -> dict:
        """The request's lifecycle record (JSON-safe), which the SLO
        tracker aggregates.  Safe on a request in flight (copies; a
        derived field is None until its anchor exists)."""
        first_admit = self.first_admitted_at
        ttft = (
            self.first_token_at - self.submitted_at
            if self.first_token_at is not None else None
        )
        queue_wait = (
            first_admit - self.submitted_at
            if first_admit is not None else None
        )
        e2e = (
            self.finished_at - self.submitted_at
            if self.finished_at is not None else None
        )
        deltas = self.tpot_deltas()
        deltas.sort()

        def _pct(q):
            if not deltas:
                return None
            i = min(len(deltas) - 1, int(q * (len(deltas) - 1) + 0.5))
            return round(deltas[i] * 1e3, 3)

        def _ms(v):
            return round(v * 1e3, 3) if v is not None else None

        return {
            "id": self.id,
            "tenant": self.tenant,
            "adapter": self.adapter,
            "priority": self.priority,
            "state": self.state,
            "prompt_tokens": int(np.asarray(self.prompt).size),
            "new_tokens": len(self.tokens),
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "preemptions": self.preemptions,
            "submitted_at": round(self.submitted_at, 6),
            "finished_at": (
                round(self.finished_at, 6)
                if self.finished_at is not None else None
            ),
            "queue_wait_ms": _ms(queue_wait),
            "prefill_ms": _ms(self.prefill_secs) if self.prefill_secs
            else 0.0,
            "ttft_ms": _ms(ttft),
            "e2e_ms": _ms(e2e),
            "tpot_ms": {
                "mean": round(
                    sum(deltas) / len(deltas) * 1e3, 3
                ) if deltas else None,
                "p50": _pct(0.5),
                "p99": _pct(0.99),
                "max": round(deltas[-1] * 1e3, 3) if deltas else None,
            },
            "error": self.error,
            "events": [dict(e) for e in list(self.events)],
        }


class TenantScheduler:
    """Weighted multi-tenant admission plus the free-slot pool
    (thread-safe).  With one tenant at the default config it is a
    bounded FIFO: global watermark, arrival order, ``AdmissionError``
    past the watermark (memory stays bounded by ``max_queue +
    max_batch`` requests)."""

    def __init__(self, max_batch: int, max_queue: int = 64,
                 metrics=None,
                 tenants: Optional[Dict[str, TenantConfig]] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.max_queue = max_queue
        self._lock = threading.Lock()
        self.tenants: Dict[str, TenantConfig] = dict(tenants or {})
        # heap entries (-priority, seq, req) per tenant
        self._queues: Dict[str, list] = {}
        self._passes: Dict[str, float] = {}
        self._active: Dict[str, int] = {}
        self._slot_tenant: Dict[int, str] = {}
        self._total_queued = 0
        self._seq = itertools.count()
        self._free_slots = list(range(max_batch - 1, -1, -1))  # pop() -> 0 first
        self._metrics = metrics

    def _cfg(self, tenant: str) -> TenantConfig:
        cfg = self.tenants.get(tenant)
        if cfg is None:
            cfg = self.tenants[tenant] = TenantConfig()
        return cfg

    # -- producer side ---------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue or raise ``AdmissionError`` past a watermark (global
        first, then the tenant's own)."""
        with self._lock:
            cfg = self._cfg(req.tenant)
            if self._total_queued >= self.max_queue:
                if self._metrics is not None:
                    self._metrics.record_rejection(req.tenant)
                raise AdmissionError(
                    f"pending queue at watermark ({self.max_queue}); "
                    f"request {req.id} rejected"
                )
            q = self._queues.setdefault(req.tenant, [])
            if cfg.max_queued is not None and len(q) >= cfg.max_queued:
                if self._metrics is not None:
                    self._metrics.record_rejection(req.tenant)
                raise AdmissionError(
                    f"tenant '{req.tenant}' queue at its quota "
                    f"({cfg.max_queued}); request {req.id} rejected"
                )
            self._enqueue(req, q)
            req.mark("queued", tenant_depth=len(q))
            if self._metrics is not None:
                self._metrics.record_admission(
                    self._total_queued, req.tenant, len(q)
                )

    def requeue(self, req: Request) -> None:
        """Put a PREEMPTED request back at the head of its tenant's
        queue (original seq, so it sorts ahead of later arrivals at the
        same priority).  Bypasses the watermarks — the request was
        already admitted once and its client is still streaming."""
        req.state = "queued"
        req.slot = -1
        req.mark("requeued", preemptions=req.preemptions)
        with self._lock:
            self._enqueue(req, self._queues.setdefault(req.tenant, []))

    def _enqueue(self, req: Request, q: list) -> None:
        if req.seq is None:
            req.seq = next(self._seq)
        if not q:
            # A tenant re-entering from idle starts at the current pass
            # floor: it competes fairly from NOW instead of spending its
            # idle time as a burst of back-to-back admissions.
            floor = min(
                (self._passes[t] for t, tq in self._queues.items() if tq),
                default=0.0,
            )
            self._passes[req.tenant] = max(
                self._passes.get(req.tenant, 0.0), floor
            )
        heapq.heappush(q, (-req.priority, req.seq, req))
        self._total_queued += 1

    def queue_depth(self) -> int:
        with self._lock:
            return self._total_queued

    def tenant_depths(self) -> Dict[str, int]:
        with self._lock:
            return {t: len(q) for t, q in self._queues.items() if q}

    # -- engine side -----------------------------------------------------

    def _pick_tenant(self) -> Optional[str]:
        best = None
        for t, q in self._queues.items():
            if not q:
                continue
            cfg = self._cfg(t)
            if (
                cfg.max_active is not None
                and self._active.get(t, 0) >= cfg.max_active
            ):
                continue
            key = (self._passes.get(t, 0.0), t)
            if best is None or key < best[0]:
                best = (key, t)
        return best[1] if best is not None else None

    def acquire(self) -> Optional[tuple]:
        """Next admissible (request, slot) pair, or None.

        Picks the lowest-pass eligible tenant (stride scheduling), then
        that tenant's highest-priority oldest request.  Skips (and
        expires) queued requests whose deadline already passed — they
        would only waste a prefill.  Returns None when no slot is free,
        nothing is queued, or every queued tenant is at its
        ``max_active`` quota."""
        with self._lock:
            while self._free_slots and self._total_queued:
                tenant = self._pick_tenant()
                if tenant is None:
                    return None
                q = self._queues[tenant]
                req = heapq.heappop(q)[2]
                self._total_queued -= 1
                if self._metrics is not None:
                    self._metrics.record_queue_depth(
                        self._total_queued, tenant, len(q)
                    )
                if req.expired():
                    req.finish(
                        "expired",
                        f"deadline ({req.deadline}s) passed while queued",
                    )
                    if self._metrics is not None:
                        self._metrics.record_expiry()
                    continue
                if req.cancel_requested:
                    # Server.cancel cleared its observer already.
                    req.finish("error", "cancelled: hedge superseded")
                    continue
                cfg = self._cfg(tenant)
                self._passes[tenant] = (
                    self._passes.get(tenant, 0.0) + 1.0 / cfg.weight
                )
                self._active[tenant] = self._active.get(tenant, 0) + 1
                slot = self._free_slots.pop()
                self._slot_tenant[slot] = tenant
                req.slot = slot
                req.state = "active"
                req.admitted_at = time.monotonic()
                if req.first_admitted_at is None:
                    req.first_admitted_at = req.admitted_at
                req.mark("admitted", slot=slot)
                return req, slot
            return None

    def acquire_direct(self, req: Request) -> Optional[int]:
        """Claim a free slot for a request placed from outside, past the
        queues (``Server.adopt``: a KV migration from another replica's
        prefill).  Its tenant's ``max_active`` quota is not applied (the
        request was admitted and charged where it came from), but its
        active count is, so ``release`` stays balanced.  Returns the
        slot, or None when no slot is free."""
        with self._lock:
            if not self._free_slots:
                return None
            self._cfg(req.tenant)
            slot = self._free_slots.pop()
            self._slot_tenant[slot] = req.tenant
            self._active[req.tenant] = self._active.get(req.tenant, 0) + 1
            req.slot = slot
            req.state = "active"
            req.admitted_at = time.monotonic()
            if req.first_admitted_at is None:
                req.first_admitted_at = req.admitted_at
            req.mark("adopt_admitted", slot=slot)
            return slot

    def active_counts(self) -> Dict[str, int]:
        with self._lock:
            return {t: n for t, n in self._active.items() if n}

    def shed_queued(self, below_priority: int,
                    retry_after: Optional[float] = None,
                    cause: str = "overload") -> int:
        """Shed every QUEUED request with ``priority`` strictly below
        ``below_priority`` (the degradation ladder's rung 4).  Each
        victim finishes in the structured ``shed`` state (the client
        sees a 503 with ``retry_after``, never a hang); requests holding
        slots are untouched (running streams finish undegraded).  Returns
        the count shed."""
        with self._lock:
            victims = []
            for q in self._queues.values():
                keep = [e for e in q if e[2].priority >= below_priority]
                if len(keep) != len(q):
                    victims.extend(
                        e[2] for e in q if e[2].priority < below_priority
                    )
                    q[:] = keep
                    heapq.heapify(q)
            self._total_queued -= len(victims)
        for req in victims:
            req.retry_after = retry_after
            req.finish(
                "shed",
                f"request {req.id} (tenant '{req.tenant}', priority "
                f"{req.priority}) shed from the queue under overload "
                f"({cause}); retry after {retry_after}s",
            )
            if self._metrics is not None:
                self._metrics.record_shed(req.tenant)
        return len(victims)

    def drain_pending(self) -> list:
        """Pop and return every queued request (no slot): the shutdown
        and watchdog paths fail them instead of leaving their streams
        blocked."""
        with self._lock:
            out = [
                entry[2] for q in self._queues.values() for entry in q
            ]
            out.sort(key=lambda r: (-r.priority, r.seq or 0))
            self._queues.clear()
            self._total_queued = 0
            return out

    def release(self, slot: int) -> None:
        """Return a slot to the pool (its request finished: EOS, budget,
        deadline, preemption or error)."""
        with self._lock:
            if slot in self._free_slots:
                raise ValueError(f"slot {slot} is already free")
            tenant = self._slot_tenant.pop(slot, None)
            if tenant is not None:
                self._active[tenant] = max(self._active.get(tenant, 1) - 1, 0)
            self._free_slots.append(slot)

    def free_slot_count(self) -> int:
        with self._lock:
            return len(self._free_slots)

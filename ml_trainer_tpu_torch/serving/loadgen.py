"""Open-loop load generation for the serving stack (the JAX package's
``serving/loadgen.py``).

A CLOSED-loop client (send, wait for the reply, send the next) measures
a different system than production traffic does: when the server slows
down, a closed-loop client slows its own arrivals, so the latency
numbers silently exclude exactly the overload the test was supposed to
find — **coordinated omission**.  This module generates OPEN-loop load:
the arrival schedule is fixed BEFORE the run (every request has an
absolute send time drawn from a Poisson process or replayed from a
recorded trace), and requests fire at their scheduled instant whether
or not earlier ones completed.  Queueing delay under saturation then
lands in the measured latencies instead of vanishing into the
generator.

Pieces:

* :class:`TenantLoad` — one tenant's traffic shape: arrival share,
  prompt/output length distributions, optional shared prefix (system
  prompt) so the prefix cache sees production-shaped reuse;
* :func:`poisson_schedule` — a seeded, deterministic schedule (same
  seed => byte-identical prompts and arrival times, test-pinned);
* :func:`schedule_from_trace` / :func:`schedule_to_records` — recorded
  traces as plain JSON-safe records, replayable as a schedule;
* :func:`run_open_loop` — drive the real HTTP ``Server`` (or the
  in-process API) to the schedule: one dispatcher thread sleeps to each
  absolute arrival and hands the request to a worker thread; results
  report client-side latency, scheduling fidelity (how late sends
  actually fired) and error counts.

Host-only module: prompts are numpy token ids drawn from
``np.random.default_rng(seed)`` in the JAX package's order, so one seed
gives both packages byte-identical schedules; the server owns every
device interaction.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TenantLoad:
    """One tenant's share of the offered load.

    ``weight``: fraction of arrivals (normalized across tenants).
    ``prompt_len``/``output_len``: inclusive ``(lo, hi)`` uniform
    ranges.  ``shared_prefix_len`` > 0 prepends a tenant-wide shared
    prefix (drawn once per schedule from the seed) to ``shared_frac``
    of the tenant's prompts — the system-prompt reuse pattern the radix
    prefix cache exists for.  ``adapters`` names the tenant's LoRA
    adapter mix (docs/serving.md "Batched LoRA adapters"): each request
    draws one entry uniformly — include ``None`` entries for base-model
    traffic interleaved with adapter traffic.  The draw rides the
    recorded trace, so a replay drives the same adapter per request."""

    weight: float = 1.0
    prompt_len: tuple = (8, 24)
    output_len: tuple = (4, 16)
    shared_prefix_len: int = 0
    shared_frac: float = 0.0
    adapters: tuple = ()

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        for name, rng in (("prompt_len", self.prompt_len),
                          ("output_len", self.output_len)):
            lo, hi = rng
            if lo < 1 or hi < lo:
                raise ValueError(f"{name} must be (lo>=1, hi>=lo), got {rng}")
        if not 0.0 <= self.shared_frac <= 1.0:
            raise ValueError(
                f"shared_frac must be in [0, 1], got {self.shared_frac}"
            )
        for a in self.adapters:
            if a is not None and (not isinstance(a, str) or not a):
                raise ValueError(
                    f"adapters entries must be names or None, got {a!r}"
                )


@dataclasses.dataclass
class ScheduledRequest:
    """One arrival in the fixed open-loop schedule.  ``session`` rides
    through to the router's sticky decode placement (ignored by a
    single-replica server — the field exists so ONE recorded trace can
    drive both topologies)."""

    arrival_s: float           # absolute offset from the run's t0
    tenant: str
    prompt: np.ndarray         # int32 token ids
    max_new_tokens: int
    session: Optional[str] = None
    adapter: Optional[str] = None  # LoRA adapter (None = base model)


def poisson_schedule(rate_rps: float, n_requests: int, vocab_size: int,
                     tenants: Optional[Dict[str, TenantLoad]] = None,
                     seed: int = 0) -> List[ScheduledRequest]:
    """A deterministic open-loop schedule: ``n_requests`` Poisson
    arrivals at ``rate_rps`` requests/second, tenants drawn by weight,
    prompts/budgets by each tenant's distributions.  The same seed
    yields a byte-identical schedule (test-pinned) — the property that
    makes a load sweep comparable across engines and rounds."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    tenants = tenants or {"default": TenantLoad()}
    rng = np.random.default_rng(seed)
    names = sorted(tenants)
    weights = np.asarray([tenants[n].weight for n in names], np.float64)
    weights = weights / weights.sum()
    # Tenant-wide shared prefixes, drawn once (stable within a seed).
    prefixes = {
        n: rng.integers(
            0, vocab_size, tenants[n].shared_prefix_len
        ).astype(np.int32)
        for n in names if tenants[n].shared_prefix_len > 0
    }
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, n_requests))
    out: List[ScheduledRequest] = []
    for i in range(n_requests):
        name = names[int(rng.choice(len(names), p=weights))]
        cfg = tenants[name]
        p_lo, p_hi = cfg.prompt_len
        o_lo, o_hi = cfg.output_len
        prompt = rng.integers(
            0, vocab_size, int(rng.integers(p_lo, p_hi + 1))
        ).astype(np.int32)
        if name in prefixes and rng.random() < cfg.shared_frac:
            prompt = np.concatenate([prefixes[name], prompt])
        adapter = None
        if cfg.adapters:
            adapter = cfg.adapters[int(rng.integers(len(cfg.adapters)))]
        out.append(ScheduledRequest(
            arrival_s=float(arrivals[i]), tenant=name, prompt=prompt,
            max_new_tokens=int(rng.integers(o_lo, o_hi + 1)),
            adapter=adapter,
        ))
    return out


def schedule_to_records(schedule: Sequence[ScheduledRequest]) -> list:
    """JSON-safe records of a schedule (a recorded trace)."""
    return [
        {
            "arrival_s": round(s.arrival_s, 6),
            "tenant": s.tenant,
            "prompt": [int(t) for t in s.prompt],
            "max_new_tokens": s.max_new_tokens,
            **({"session": s.session} if s.session else {}),
            **({"adapter": s.adapter} if s.adapter else {}),
        }
        for s in schedule
    ]


def schedule_from_trace(records) -> List[ScheduledRequest]:
    """A schedule from recorded-trace records — the list
    :func:`schedule_to_records` emits, or a path to a JSON file of it.
    Replay keeps the original absolute arrival offsets, so a production
    trace drives the harness with its real burstiness."""
    if isinstance(records, str):
        with open(records, encoding="utf-8") as fp:
            records = json.load(fp)
    out = []
    for r in records:
        out.append(ScheduledRequest(
            arrival_s=float(r["arrival_s"]),
            tenant=str(r.get("tenant", "default")),
            prompt=np.asarray(r["prompt"], np.int32),
            max_new_tokens=int(r["max_new_tokens"]),
            session=r.get("session"),
            adapter=r.get("adapter"),
        ))
    out.sort(key=lambda s: s.arrival_s)
    return out


def _percentile_ms(sorted_s: list, q: float) -> float:
    if not sorted_s:
        return 0.0
    i = min(len(sorted_s) - 1, int(q * (len(sorted_s) - 1) + 0.5))
    return round(sorted_s[i] * 1e3, 3)


def run_open_loop(schedule: Sequence[ScheduledRequest],
                  url: Optional[str] = None, server=None,
                  timeout: float = 300.0,
                  time_scale: float = 1.0,
                  collect_tokens: bool = False) -> dict:
    """Fire ``schedule`` open-loop at the real server and report.

    ``url`` is the explicit TARGET — a single replica's front end or
    the disaggregated router's, interchangeably (POST
    ``{url}/v1/generate`` per request: the full production path — JSON
    parse, admission/routing, engine, response), so one recorded trace
    drives both topologies; ``server`` drives the in-process API (a
    ``Server`` or a ``Router``).  Exactly one must be given.  A dispatcher thread sleeps to
    each ABSOLUTE scheduled arrival and hands the request to its own
    worker thread — completions never gate arrivals (no coordinated
    omission), and the report's ``send_lag_ms`` records how faithfully
    the schedule fired.  ``time_scale`` stretches (>1) or compresses
    (<1) the schedule's arrival offsets without touching its content.
    ``collect_tokens`` keeps each request's full output ids on its
    per-request row — the byte-identity evidence a topology comparison
    needs."""
    if (url is None) == (server is None):
        raise ValueError("exactly one of url/server must be given")
    results = [None] * len(schedule)

    def _worker(i: int, s: ScheduledRequest, scheduled_at: float):
        sent_at = time.monotonic()
        row = {
            "tenant": s.tenant,
            **({"adapter": s.adapter} if s.adapter else {}),
            "scheduled_s": round(s.arrival_s * time_scale, 6),
            "send_lag_ms": round((sent_at - scheduled_at) * 1e3, 3),
            "ok": False, "error": None, "tokens": 0,
        }
        try:
            if url is not None:
                payload = {
                    "prompt": [int(t) for t in s.prompt],
                    "max_new_tokens": s.max_new_tokens,
                    "tenant": s.tenant,
                }
                if s.session:
                    payload["session"] = s.session
                if s.adapter:
                    payload["adapter"] = s.adapter
                body = json.dumps(payload).encode()
                req = urllib.request.Request(
                    f"{url}/v1/generate", data=body,
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    out = json.loads(resp.read())
                row["tokens"] = len(out["tokens"]) - s.prompt.size
                # Which replica served the decode (router replies name
                # it; a single-replica server replies its own name or
                # None) — per-row attribution for fleet debugging.
                row["replica"] = out.get("replica")
                if collect_tokens:
                    row["output"] = [int(t) for t in out["tokens"]]
            else:
                out = server.complete(
                    s.prompt, s.max_new_tokens, tenant=s.tenant,
                    timeout=timeout,
                    **({"adapter": s.adapter} if s.adapter else {}),
                )
                row["tokens"] = int(np.asarray(out).size - s.prompt.size)
                if collect_tokens:
                    row["output"] = [int(t) for t in np.asarray(out)]
            row["ok"] = True
        except urllib.error.HTTPError as e:
            # A STRUCTURED refusal (shed/backpressure/deadline) carries
            # a JSON body naming the cause — keep it, plus the status
            # and retry_after, so the chaos harness can prove every
            # failed request got a structured error, not a hang or a
            # stdlib HTML page.
            row["status"] = e.code
            try:
                body = json.loads(e.read())
                row["error"] = body.get("error") or f"HTTP {e.code}"
                if "retry_after" in body:
                    row["retry_after"] = body["retry_after"]
                row["structured"] = bool(body.get("error"))
            except Exception:
                row["error"] = f"HTTPError: HTTP {e.code}"
                row["structured"] = False
        except Exception as e:  # the harness reports failures, it
            row["error"] = f"{type(e).__name__}: {e}"  # never dies on one
        row["latency_s"] = round(time.monotonic() - sent_at, 6)
        results[i] = row

    threads = []
    t0 = time.monotonic()
    for i, s in enumerate(schedule):
        target = t0 + s.arrival_s * time_scale
        wait = target - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        th = threading.Thread(
            target=_worker, args=(i, s, target), daemon=True,
            name=f"loadgen-{i}",
        )
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=timeout)
    makespan = time.monotonic() - t0
    done = [r for r in results if r is not None]
    ok = [r for r in done if r["ok"]]
    lat = sorted(r["latency_s"] for r in ok)
    total_tokens = sum(r["tokens"] for r in ok)
    return {
        "n_scheduled": len(schedule),
        "n_completed": len(ok),
        "n_errors": len(done) - len(ok),
        "errors": sorted({r["error"] for r in done if r["error"]})[:4],
        "makespan_s": round(makespan, 3),
        "offered_rps": round(
            len(schedule) / (schedule[-1].arrival_s * time_scale), 3
        ) if schedule and schedule[-1].arrival_s * time_scale > 0 else None,
        "tokens_per_sec": round(total_tokens / makespan, 1)
        if makespan > 0 else 0.0,
        "useful_tokens": total_tokens,
        "client_e2e_p50_ms": _percentile_ms(lat, 0.5),
        "client_e2e_p99_ms": _percentile_ms(lat, 0.99),
        "send_lag_p99_ms": _percentile_ms(
            sorted(r["send_lag_ms"] / 1e3 for r in done), 0.99
        ),
        "per_request": done,
    }

"""Serving counters and timings (the part of the JAX package's
``serving/metrics.py`` that ``Server.health()`` and the chip smoke read).

Host-clock timings only: prefill seconds and TTFT per request, and the
seconds of every decode step (each step ends in the one host read of the
sampled tokens, so the host clock spans the device work).  Thread-safe:
the serving loop writes, any thread reads ``snapshot()``.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional


def _pct(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))]


class ServingMetrics:
    _COUNTERS = (
        "requests_completed", "requests_rejected", "requests_expired",
        "preemptions", "admission_blocked", "engine_errors",
        "tokens_generated", "decode_steps",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {k: 0 for k in self._COUNTERS}
        self.ttft: List[float] = []
        self.prefill: List[float] = []
        self.step_secs: List[float] = []
        self.kv: Dict[str, int] = {}
        self.prefix: Dict[str, int] = {}
        # The LoRA adapter pool (serving/adapter_pool.py): slots free,
        # used and in all (the trash slot 0 not counted), the adapters
        # resident, the hit/load/eviction counters and the device bytes
        # one slot takes over every stack.
        self.adapters: Dict[str, int] = {}
        # Chunked prefill: admissions that took the chunked path and the
        # prefill windows run.
        self.chunked_admissions_total = 0
        self.prefill_chunks_total = 0
        # Speculative decoding: one histogram entry per (verify step,
        # active slot), keyed by the accepted-draft count 0..K.
        self.spec_draft_k = 0
        self.spec_steps_total = 0
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_accept_hist: collections.Counter = collections.Counter()

    def _inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def record_completion(self) -> None:
        self._inc("requests_completed")

    def record_rejection(self) -> None:
        self._inc("requests_rejected")

    def record_expiry(self) -> None:
        self._inc("requests_expired")

    def record_preemption(self) -> None:
        self._inc("preemptions")

    def record_admission_blocked(self) -> None:
        self._inc("admission_blocked")

    def record_engine_error(self) -> None:
        self._inc("engine_errors")

    def record_ttft(self, secs: float) -> None:
        with self._lock:
            self.ttft.append(float(secs))

    def record_prefill(self, secs: float) -> None:
        with self._lock:
            self.prefill.append(float(secs))

    def record_step(self, secs: float, emitted: int) -> None:
        with self._lock:
            self.step_secs.append(float(secs))
            self.counters["decode_steps"] += 1
            self.counters["tokens_generated"] += int(emitted)

    def record_chunked_admission(self) -> None:
        """One long prompt admitted through the chunked-prefill path."""
        with self._lock:
            self.chunked_admissions_total += 1

    def record_prefill_chunk(self) -> None:
        """One chunked-prefill window run."""
        with self._lock:
            self.prefill_chunks_total += 1

    def record_spec(self, accepted_counts, draft_k: int) -> None:
        """One speculative verify step: each active slot's accepted-draft
        count (the slot advanced ``accepted + 1`` tokens)."""
        with self._lock:
            self.spec_draft_k = int(draft_k)
            self.spec_steps_total += 1
            for a in accepted_counts:
                self.spec_accept_hist[int(a)] += 1
                self.spec_drafted_tokens += int(draft_k)
                self.spec_accepted_tokens += int(a)

    def record_kv(self, free: int, used: int, total: int,
                  prefix_blocks: int) -> None:
        with self._lock:
            self.kv = {"free": free, "used": used, "total": total,
                       "prefix_blocks": prefix_blocks}

    def record_prefix_stats(self, hits: int, misses: int, hit_tokens: int,
                            lookup_tokens: int) -> None:
        with self._lock:
            self.prefix = {"hits": hits, "misses": misses,
                           "hit_tokens": hit_tokens,
                           "lookup_tokens": lookup_tokens}

    def record_adapters(self, free: int, used: int, total: int, resident,
                        hits: int, loads: int, evictions: int,
                        bytes_per_slot: Optional[int] = None) -> None:
        """The adapter pool's occupancy, counters and per-slot bytes."""
        with self._lock:
            self.adapters = {
                "free": int(free), "used": int(used), "total": int(total),
                "resident": (int(resident) if isinstance(resident, int)
                             else len(resident)),
                "hits": int(hits), "loads": int(loads),
                "evictions": int(evictions),
                "slot_bytes": int(bytes_per_slot or
                                  self.adapters.get("slot_bytes", 0)),
            }

    def snapshot(self) -> dict:
        with self._lock:
            steps = list(self.step_secs)
            return {
                **self.counters,
                "ttft_p50_s": _pct(self.ttft, 0.5),
                "ttft_p99_s": _pct(self.ttft, 0.99),
                "prefill_p50_s": _pct(self.prefill, 0.5),
                "decode_step_mean_s": (sum(steps) / len(steps)
                                       if steps else None),
                "decode_step_p50_s": _pct(steps, 0.5),
                "kv": dict(self.kv),
                "prefix": dict(self.prefix),
                **self._adapter_snapshot(),
                "chunked_admissions_total": self.chunked_admissions_total,
                "prefill_chunks_total": self.prefill_chunks_total,
                **self._spec_snapshot(),
            }

    def _spec_snapshot(self) -> dict:
        """The JAX snapshot's speculative keys."""
        hist = self.spec_accept_hist
        return {
            "spec_draft_k": self.spec_draft_k,
            "spec_steps_total": self.spec_steps_total,
            "spec_drafted_tokens": self.spec_drafted_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_acceptance_rate": round(
                self.spec_accepted_tokens / self.spec_drafted_tokens, 4
            ) if self.spec_drafted_tokens else 0.0,
            # Mean tokens committed per slot per verify step (1..K+1).
            "spec_tokens_per_step": round(
                sum((a + 1) * c for a, c in hist.items())
                / sum(hist.values()), 3) if hist else 0.0,
            "spec_accept_hist": {str(a): hist[a] for a in sorted(hist)},
        }

    def _adapter_snapshot(self) -> dict:
        """The JAX snapshot's adapter keys (zeros without a pool); the
        pool's bytes priced per state from the slot counts."""
        a = self.adapters
        per = a.get("slot_bytes", 0)
        return {
            "adapter_slots_free": a.get("free", 0),
            "adapter_slots_used": a.get("used", 0),
            "adapter_slots_total": a.get("total", 0),
            "adapters_resident": a.get("resident", 0),
            "adapter_hits_total": a.get("hits", 0),
            "adapter_loads_total": a.get("loads", 0),
            "adapter_evictions_total": a.get("evictions", 0),
            "adapter_pool_bytes": {
                "free": a.get("free", 0) * per,
                "used": a.get("used", 0) * per,
                "total": a.get("total", 0) * per,
            },
        }

"""Overload survival: the graceful-degradation ladder, circuit breakers
and rolling latency quantiles (the JAX package's ``serving/overload.py``).

* **Degradation ladder** (:class:`DegradationLadder`): five rungs of
  progressively cheaper service, engaged when SLO burn is high and no
  capacity can be added, left on recovery; each transition is a history
  row and the ``serving_degradation_level`` gauge:

  ====  ==================  ==============================================
  rung  name                effect (NEW admissions only, see below)
  ====  ==================  ==============================================
  0     ``normal``          full service
  1     ``clamp_tokens``    ``max_new_tokens`` clamped for fresh requests
  2     ``spec_off``        speculative decoding off (verify compute
                            freed; greedy streams keep their tokens)
  3     ``hits_only``       a fresh admission must hit the prefix cache:
                            a miss is shed with a structured 503
  4     ``shed_queued``     the low-priority QUEUED requests shed
                            (structured 503 + ``retry_after``), and fresh
                            low-priority submissions refused the same way
  ====  ==================  ==============================================

  Every rung acts at admission only: a request already streaming when a
  rung engages keeps its token budget and its committed tokens; a greedy
  stream crossing ``spec_off`` finishes with the tokens of its
  undegraded run (speculative greedy equals vanilla greedy), and a
  resumed request (committed tokens) is never clamped or shed.

* **Circuit breakers** (:class:`CircuitBreaker`): K consecutive failures
  against a replica open its breaker; after a cooldown it goes half-open
  and admits ONE probe, whose success closes it and whose failure
  re-opens it.

* **Rolling quantiles** (:class:`RollingQuantile`): bounded windows of
  recent latencies with on-demand quantiles (the router's hedging clock,
  Queue A 5).

* **Shed errors** (:class:`OverloadShed`): the structured refusal,
  carrying ``retry_after`` seconds; the HTTP front end answers it with
  503 and a ``Retry-After`` header.

Host-only: overload control is host policy.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import List, Optional


class OverloadShed(RuntimeError):
    """The deployment refused this request to protect its SLOs (a
    degradation-ladder rung shed it).  ``retry_after`` is the seconds
    the client should back off before retrying; the HTTP front ends
    map this to 503 + ``Retry-After``."""

    def __init__(self, message: str, retry_after: Optional[float] = None):
        super().__init__(message)
        self.retry_after = retry_after


# Ladder rung names, index == level (gauge value).
RUNGS = ("normal", "clamp_tokens", "spec_off", "hits_only", "shed_queued")
MAX_LEVEL = len(RUNGS) - 1


@dataclasses.dataclass(frozen=True)
class DegradationConfig:
    """Ladder knobs.

    ``clamp_tokens``: the per-request ``max_new_tokens`` ceiling rung 1
    imposes on FRESH admissions.  ``retry_after_s``: the backoff a shed
    client is told.  ``shed_below_priority``: rung 4 sheds queued/fresh
    requests with ``priority`` strictly below this (default 1 — the
    default priority 0 traffic sheds, explicitly prioritized traffic
    survives)."""

    clamp_tokens: int = 16
    retry_after_s: float = 2.0
    shed_below_priority: int = 1

    def __post_init__(self):
        if self.clamp_tokens < 1:
            raise ValueError(
                f"clamp_tokens must be >= 1, got {self.clamp_tokens}"
            )
        if self.retry_after_s <= 0:
            raise ValueError(
                f"retry_after_s must be > 0, got {self.retry_after_s}"
            )


class DegradationLadder:
    """The brownout state machine over a set of ``Server`` replicas.

    ``servers`` is a zero-argument callable returning the current list
    of servers, or a plain list.  ``set_level`` applies the rung to every
    server (idempotent), records the transition as a history row, and on
    entering rung 4 sheds the servers' queued low-priority backlog.
    Thread-safe."""

    def __init__(self, servers, config: Optional[DegradationConfig] = None,
                 name: str = "serving"):
        self.config = config if config is not None else DegradationConfig()
        self._servers = servers if callable(servers) else (lambda: list(servers))
        self.name = name
        self._lock = threading.Lock()
        self._level = 0
        self.history: List[dict] = []
        self.shed_total = 0

    @property
    def level(self) -> int:
        return self._level

    @property
    def rung(self) -> str:
        return RUNGS[self._level]

    def set_level(self, level: int, cause: str = "") -> int:
        """Move to ``level`` (clamped to [0, MAX_LEVEL]); returns the
        new level.  Applies the rung to every current server, and on
        entering rung 4 sheds their queued low-priority backlog."""
        level = max(0, min(int(level), MAX_LEVEL))
        with self._lock:
            old = self._level
            if level == old:
                return old
            self._level = level
            row = {
                "t": round(time.monotonic(), 3),
                "from": old, "to": level,
                "from_rung": RUNGS[old], "to_rung": RUNGS[level],
                "cause": cause,
            }
            self.history.append(row)
        shed = 0
        for server in self._servers():
            server.set_degradation(level, self.config)
            if level >= 4 and old < 4:
                shed += server.shed_queued(
                    self.config.shed_below_priority,
                    self.config.retry_after_s,
                    cause=cause or "degradation ladder rung 4",
                )
        if shed:
            with self._lock:
                self.shed_total += shed
        return level

    def step_up(self, cause: str = "") -> int:
        return self.set_level(self._level + 1, cause)

    def step_down(self, cause: str = "") -> int:
        return self.set_level(self._level - 1, cause)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "level": self._level,
                "rung": RUNGS[self._level],
                "transitions": len(self.history),
                "shed_total": self.shed_total,
                "history": [dict(r) for r in self.history],
            }

    def publish(self, registry=None) -> None:
        """``serving_degradation_level`` (the dashboard's brownout
        gauge) + transition/shed counters."""
        from ml_trainer_tpu_torch.telemetry.registry import default_registry

        r = registry if registry is not None else default_registry()
        with self._lock:
            level, transitions, shed = (
                self._level, len(self.history), self.shed_total
            )
        r.gauge(
            "serving_degradation_level",
            "active degradation-ladder rung (0 normal .. 4 shed_queued)",
        ).set(float(level))
        r.gauge(
            "serving_degradation_transitions_total",
            "degradation-ladder rung transitions",
        ).set(float(transitions))
        r.gauge(
            "serving_degradation_shed_total",
            "queued/fresh requests shed by the ladder",
        ).set(float(shed))


# ------------------------------------------------------ circuit breaker

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Three-state per-replica breaker (thread-safe).

    ``threshold`` consecutive failures open the breaker; after
    ``cooldown_s`` it half-opens and ``allow()`` admits exactly one
    probe; the probe's ``record_success``/``record_failure`` closes or
    re-opens it.  ``clock`` is injectable for tests."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 2.0,
                 clock=time.monotonic):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got {cooldown_s}")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_out = False
        self.transitions: List[dict] = []

    def _transition(self, state: str, cause: str) -> None:
        # Caller holds the lock.
        if state == self._state:
            return
        self.transitions.append({
            "t": round(self._clock(), 3),
            "from": self._state, "to": state, "cause": cause,
        })
        self._state = state

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        # Caller holds the lock.
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.cooldown_s
        ):
            self._transition(HALF_OPEN, "cooldown elapsed")
            self._probe_out = False

    def allow(self) -> bool:
        """May the caller place a request on this replica right now?
        Closed: yes.  Open: no (until the cooldown half-opens it).
        Half-open: exactly one caller gets True (the probe) until its
        outcome is recorded."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_out:
                self._probe_out = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._probe_out = False
            if self._state != CLOSED:
                self._transition(CLOSED, "probe succeeded")

    def record_failure(self, cause: str = "") -> None:
        with self._lock:
            self._consecutive += 1
            self._probe_out = False
            if self._state == HALF_OPEN:
                self._opened_at = self._clock()
                self._transition(OPEN, cause or "probe failed")
            elif (
                self._state == CLOSED
                and self._consecutive >= self.threshold
            ):
                self._opened_at = self._clock()
                self._transition(
                    OPEN,
                    cause or f"{self._consecutive} consecutive failures",
                )

    def gauge_value(self) -> int:
        return _STATE_GAUGE[self.state]


# ----------------------------------------------------- rolling quantile

class RollingQuantile:
    """Bounded window of recent observations with on-demand quantiles —
    the hedging clock (``hedge after the rolling p99``).  Thread-safe;
    ``quantile`` returns ``default`` until ``min_samples`` arrive so a
    cold fleet never hedges off two data points."""

    def __init__(self, window: int = 256, min_samples: int = 8,
                 default: float = 1.0):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._lock = threading.Lock()
        self._vals: collections.deque = collections.deque(maxlen=window)
        self.min_samples = int(min_samples)
        self.default = float(default)

    def observe(self, value: float) -> None:
        with self._lock:
            self._vals.append(float(value))

    def __len__(self) -> int:
        with self._lock:
            return len(self._vals)

    def quantile(self, q: float) -> float:
        with self._lock:
            vals = sorted(self._vals)
        if len(vals) < self.min_samples:
            return self.default
        i = min(len(vals) - 1, int(q * (len(vals) - 1) + 0.5))
        return vals[i]

"""Admission control: the request record and FIFO admission with slot
bookkeeping (the part of the JAX package's ``serving/scheduler.py`` that
the single-tenant serving path needs).

``FifoScheduler`` admits in arrival order behind a global watermark
(``AdmissionError`` past it), hands out free slots, expires queued
requests whose deadline passed, and puts a preempted request back at the
HEAD of the queue so that it resumes ahead of later arrivals.  Weighted
multi-tenant admission, priorities and quotas are later work (ROADMAP.md
Queue A); ``tenant`` is kept on the request because the prefix cache is
namespaced by it.
"""

from __future__ import annotations

import collections
import itertools
import queue as _queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class AdmissionError(RuntimeError):
    """The pending queue is at its watermark; the request was rejected."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it finished."""


_ids = itertools.count()

# Stream sentinel (queue items are plain ints otherwise).
_DONE = ("done", None)

DEFAULT_TENANT = "default"


@dataclass
class Request:
    """One generation request moving through queue -> slot -> done.

    ``deadline`` is a budget in seconds from submission.  ``rng`` is the
    int seed of a sampled request (``temperature > 0``); token ``t`` is
    drawn with ``generate._token_seed(rng, t)``, so a request reproduces
    the port's ``generate(..., rng=seed)`` for the same prompt."""

    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    rng: Optional[int] = None
    eos_token_id: Optional[int] = None
    deadline: Optional[float] = None
    tenant: str = DEFAULT_TENANT
    # The LoRA adapter this request decodes with (``serving/
    # adapter_pool.py``); None is the base model (slot 0, the trash
    # adapter: bitwise an engine without adapters).
    adapter: Optional[str] = None

    id: int = field(default_factory=lambda: next(_ids))
    submitted_at: float = field(default_factory=time.monotonic)
    state: str = "queued"  # queued | active | done | expired | error
    slot: int = -1
    tokens: list = field(default_factory=list)
    preemptions: int = 0
    prefix_hit_tokens: int = 0
    # A "no_memory" admission is being retried: retries skip the prefix
    # cache's stats and LRU stamps.
    kv_blocked: bool = False
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    error: Optional[str] = None
    _stream: _queue.Queue = field(default_factory=_queue.Queue)

    @property
    def deadline_at(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.submitted_at + self.deadline

    def expired(self, now: Optional[float] = None) -> bool:
        d = self.deadline_at
        return d is not None and (now or time.monotonic()) > d

    def push_token(self, token: int) -> None:
        self.tokens.append(int(token))
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self._stream.put(int(token))

    def finish(self, state: str = "done", error: Optional[str] = None) -> None:
        self.state = state
        self.error = error
        self._stream.put(_DONE)


class FifoScheduler:
    """Bounded FIFO admission plus the free-slot pool (thread-safe)."""

    def __init__(self, max_batch: int, max_queue: int = 64, metrics=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.max_queue = max_queue
        self._lock = threading.Lock()
        self._queue: collections.deque = collections.deque()
        self._free_slots = list(range(max_batch - 1, -1, -1))  # pop() -> 0
        self._metrics = metrics

    def submit(self, req: Request) -> None:
        """Enqueue, or raise ``AdmissionError`` past the watermark."""
        with self._lock:
            if len(self._queue) >= self.max_queue:
                if self._metrics is not None:
                    self._metrics.record_rejection()
                raise AdmissionError(
                    f"pending queue at watermark ({self.max_queue}); "
                    f"request {req.id} rejected"
                )
            self._queue.append(req)

    def requeue(self, req: Request) -> None:
        """Put a preempted request back at the head of the queue
        (bypassing the watermark: it was admitted once already)."""
        req.state = "queued"
        req.slot = -1
        with self._lock:
            self._queue.appendleft(req)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def acquire(self) -> Optional[tuple]:
        """Next admissible ``(request, slot)``, or None.  Queued requests
        whose deadline already passed are expired, not admitted."""
        with self._lock:
            while self._free_slots and self._queue:
                req = self._queue.popleft()
                if req.expired():
                    req.finish(
                        "expired",
                        f"deadline ({req.deadline}s) passed while queued",
                    )
                    if self._metrics is not None:
                        self._metrics.record_expiry()
                    continue
                slot = self._free_slots.pop()
                req.slot = slot
                req.state = "active"
                req.admitted_at = time.monotonic()
                return req, slot
            return None

    def drain_pending(self) -> list:
        """Pop and return every queued request (shutdown path)."""
        with self._lock:
            out = list(self._queue)
            self._queue.clear()
            return out

    def release(self, slot: int) -> None:
        with self._lock:
            if slot in self._free_slots:
                raise ValueError(f"slot {slot} is already free")
            self._free_slots.append(slot)

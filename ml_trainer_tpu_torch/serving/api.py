"""Thread-safe serving front end over the slot decode engine (the JAX
package's ``serving/api.py``, without the fleet: Queue A 5).

``Server`` owns the engine, the weighted multi-tenant scheduler
(``scheduler.py``), the SLO tracker (``slo.py``), one worker thread
driving the admit/step loop and one watchdog thread.  Callers use:

* ``submit(prompt, max_new_tokens, ..., tenant=, priority=) ->
  TokenStream``: non-blocking; the stream iterates tokens as they decode,
  and ``result()`` blocks for the whole sequence (prompt + continuation,
  ``generate()``'s layout); ``submit_request`` enqueues a built
  ``Request``;
* ``complete(...)``: the blocking one-shot;
* ``serve_http(host, port)`` (or ``Server(http_port=...)``): a stdlib
  ``ThreadingHTTPServer``.  ``POST /v1/generate`` with ``{"prompt":
  [ids...], "max_new_tokens": n, "temperature"?, "seed"?,
  "eos_token_id"?, "deadline"?, "tenant"?, "priority"?, "adapter"?}``
  returns ``{"tokens": [...], "replica": null}``; ``GET /healthz`` the
  health payload (503 when not ``ok``); ``GET /metrics`` the Prometheus
  text of the process registry after ``metrics.publish`` and
  ``slo.publish``; ``GET /metrics.json`` the metrics snapshot; ``GET
  /slo`` the SLO snapshot; any other path 404.  A bad body is 400, a
  full queue or a draining server 429, a wedged or dead engine, a shed
  (with ``Retry-After``) or another structured failure 503, a deadline
  504;
* ``set_degradation(level)`` / ``shed_queued``: the overload ladder's
  rungs (``overload.py``), which act on new admissions only;
  ``cancel(req)`` drops a request at the loop's next boundary;
* ``health()``: the JAX package's payload (``ok`` is healthy, not
  draining and not closed); ``drain()`` stops admission and waits for
  the work in flight; ``load_adapter`` hot-loads a LoRA adapter;
* ``close()`` or the context manager: stop the loop, fail whatever is
  queued or in flight, and drop the engine's decode graph.

Failure contract: a client never hangs on a dead engine.  The watchdog
sees the loop's heartbeat; when work is pending and the loop has not
beaten for ``watchdog_timeout`` seconds (a wedged decode step), it fails
every stream with a structured "wedged" error, marks the server
unhealthy (``/healthz`` 503) and refuses new submissions.  An exception
that escapes the loop's per-iteration handler does the same.

Threads: the worker thread owns the card (on it, the engine's prefills
and the decode graph's warm-up, capture and replays).  The kernels'
libraries are loaded on the constructor's thread, before the watchdog
starts, so a cold build cannot read as a wedge.  ``health()``, the
watchdog and the HTTP handlers read host state only (counts, the page
pool, the metrics under their lock) and never touch CUDA, so a wedged
device cannot hang ``/healthz``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import numpy as np

from ml_trainer_tpu_torch.serving.engine import SlotDecodeEngine
from ml_trainer_tpu_torch.serving.metrics import ServingMetrics
from ml_trainer_tpu_torch.serving.overload import (
    DegradationConfig,
    OverloadShed,
)
from ml_trainer_tpu_torch.serving.scheduler import (
    _DONE,
    AdmissionError,
    DeadlineExceeded,
    EngineUnhealthy,
    Request,
    TenantScheduler,
)
from ml_trainer_tpu_torch.serving.slo import SloPolicy, SloTracker
from ml_trainer_tpu_torch.telemetry.registry import default_registry


class TokenStream:
    """Streaming view of one request: iterate tokens as they arrive, or
    ``result()`` for the whole sequence."""

    def __init__(self, req: Request, prompt: np.ndarray):
        self._req = req
        self._prompt = prompt

    @property
    def request(self) -> Request:
        return self._req

    def __iter__(self):
        while True:
            item = self._req._stream.get()
            if item == _DONE:
                self._raise_on_failure()
                return
            yield item

    def _raise_on_failure(self):
        if self._req.state == "expired":
            raise DeadlineExceeded(self._req.error or "deadline exceeded")
        if self._req.state == "shed":
            raise OverloadShed(
                self._req.error or "request shed under overload",
                retry_after=self._req.retry_after)
        if self._req.state == "error":
            raise RuntimeError(self._req.error or "serving engine error")

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request finishes; returns ``[prompt + new
        tokens]`` (1-D int32).  Raises ``DeadlineExceeded`` /
        ``OverloadShed`` / ``RuntimeError`` on failure and
        ``TimeoutError`` past ``timeout``, also when the engine is stuck,
        so that a blocking caller always gets control back.  It waits for
        the finish alone: a waiter woken at every token would take the
        GIL from the serving loop once a token."""
        if not self._req._finished.wait(timeout):
            raise TimeoutError(
                f"request {self._req.id} not finished within {timeout}s "
                f"({len(self._req.tokens)} token(s) so far; engine may be "
                "wedged: see Server.health())")
        self._raise_on_failure()
        return np.concatenate(
            [self._prompt, np.asarray(self._req.tokens, np.int32)])

    @property
    def tokens(self) -> list:
        return list(self._req.tokens)


class Server:
    """Continuous-batching server: engine + scheduler + one worker
    thread + the watchdog.  ``device`` defaults to the CUDA card and must
    be where ``model`` lives.

    ``tenants`` maps a tenant's name to its ``TenantConfig`` (weight,
    ``max_active``, ``max_queued``); a request names its tenant at
    ``submit`` and an unknown tenant gets the default config.  ``slo``
    is the ``SloPolicy`` the tracker (``server.slo``) judges finished
    requests by; ``slo_timelines`` bounds its ring of timelines.
    ``watchdog_timeout`` is the seconds the loop may go without a
    heartbeat while work is pending before the server is declared wedged
    (None: no watchdog); size it above the slowest single prefill or
    decode step, the decode graph's warm-up and capture included.
    ``http_port`` starts ``serve_http`` on it (0: a free port).

    ``quant_int8`` serves the decode step with int8-quantized
    qkv/proj/fc_in/fc_out weights and per-column scales
    (``ops/kernels/int8_matmul.py``; the prefill stays fp32).  It is
    opt-in and quality-gated (argmax agreement and relative logit error
    against fp32), NOT bit-identical to fp32, and refused with
    ``spec_k > 0`` or ``adapters``.

    ``adapters`` (an ``AdapterConfig`` or its kwargs; the GPT-2 family)
    serves LoRA adapters from a pool of slots beside the base
    (``serving/adapter_pool.py``): ``submit(..., adapter=name)``.

    ``spec_k > 0`` decodes speculatively: ``drafter`` ("ngram", the
    lookup over ``ngram_n``-grams, or a draft model of the same
    vocabulary) proposes ``spec_k`` tokens a slot and one verify forward
    scores them; greedy requests get the vanilla tokens.  A request then
    needs ``spec_k`` positions of slack under ``max_len``.
    ``prefill_chunk`` (paged, a page multiple) prefills prompts longer
    than it in windows of that many tokens, one per loop iteration, so
    that a long prompt does not hold back the first tokens of the short
    requests behind it."""

    # Seconds the idle loop waits for a submission before looking again.
    _IDLE_POLL = 0.02

    def __init__(self, model, max_batch: int = 8, max_queue: int = 64,
                 kv_page_size: int = 0,
                 kv_pages: int = 0, paged_kernel: bool = False,
                 prefix_cache: bool = True, prefix_scope: str = "tenant",
                 max_preemptions: int = 8, spec_k: int = 0,
                 drafter="ngram", ngram_n: int = 3, adapters=None,
                 quant_int8: bool = False, prefill_chunk: int = 0,
                 tenants: Optional[dict] = None,
                 slo: Optional[SloPolicy] = None, slo_timelines: int = 64,
                 watchdog_timeout: Optional[float] = 60.0,
                 http_port: Optional[int] = None, device=None):
        if watchdog_timeout is not None and watchdog_timeout <= 0:
            raise ValueError(f"watchdog_timeout must be positive or None, "
                             f"got {watchdog_timeout}")
        self.metrics = ServingMetrics()
        self.slo = SloTracker(policy=slo, metrics=self.metrics,
                              keep_timelines=slo_timelines)
        self.engine = SlotDecodeEngine(
            model, max_batch=max_batch, metrics=self.metrics,
            kv_page_size=kv_page_size, kv_pages=kv_pages,
            paged_kernel=paged_kernel, prefix_cache=prefix_cache,
            prefix_scope=prefix_scope, max_preemptions=max_preemptions,
            spec_k=spec_k, drafter=drafter, ngram_n=ngram_n,
            adapters=adapters, quant_int8=quant_int8,
            prefill_chunk=prefill_chunk, device=device,
        )
        self.scheduler = TenantScheduler(max_batch, max_queue=max_queue,
                                         metrics=self.metrics,
                                         tenants=tenants)
        # Build (if need be) and load the kernels the loop will launch,
        # here: an nvcc run on the loop thread would read as a wedge.
        t0 = time.perf_counter()
        if self.engine.kernel_sources():
            from ml_trainer_tpu_torch.ops.kernels._build import load

            for name in self.engine.kernel_sources():
                load(name)
        self.kernel_load_s = time.perf_counter() - t0
        self._wake = threading.Event()
        self._stop = threading.Event()  # wakes the watchdog at close()
        self._stopping = False
        self._draining = False
        self.healthy = True
        self._unhealthy_reason: Optional[str] = None
        self._health_lock = threading.Lock()
        self._last_beat = time.monotonic()
        self._admitting: Optional[Request] = None
        # The ladder's rung and its config (level 0: full service).
        self._degradation_level = 0
        self._degradation_cfg: Optional[DegradationConfig] = None
        self._started_at = time.monotonic()
        # The replica name a fleet gives a server (Queue A 5); a
        # standalone server answers "replica": null.
        self.name = ""
        self._httpd = None
        self._http_thread = None
        self._watchdog_timeout = watchdog_timeout
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-engine")
        self._thread.start()
        self._watchdog_thread = None
        if watchdog_timeout is not None:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog, daemon=True, name="serving-watchdog")
            self._watchdog_thread.start()
        if http_port is not None:
            self.serve_http(port=http_port)

    # -- client surface --------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               rng: Optional[int] = None, eos_token_id: Optional[int] = None,
               deadline: Optional[float] = None,
               tenant: str = "default", priority: int = 0,
               adapter: Optional[str] = None) -> TokenStream:
        """Enqueue one request (thread-safe).  Raises ``AdmissionError``
        past the queue's watermark (global or the tenant's) or while
        draining, ``EngineUnhealthy`` once the engine is wedged or dead,
        ``OverloadShed`` when a degradation rung refuses it, and
        ``ValueError`` for a request the engine could never serve.
        ``priority`` orders a tenant's queue (higher first).  ``adapter``
        names the LoRA adapter to decode with (needs
        ``Server(adapters=...)``; None: the base model); an unknown
        adapter or a full pool fails the stream with a structured
        error."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        spec_k = self.engine.spec_k
        if prompt.size + max_new_tokens + spec_k > self.engine.max_len:
            extra = (f" + spec_k ({spec_k}) — the speculative verify "
                     "window needs spec_k tokens of cache slack"
                     if spec_k else "")
            raise ValueError(
                f"prompt ({prompt.size}) + new tokens ({max_new_tokens})"
                f"{extra} exceeds the model's max_len ({self.engine.max_len})"
            )
        if eos_token_id is not None and not (
                0 <= eos_token_id < self.engine.vocab_size):
            raise ValueError(f"eos_token_id must be in [0, "
                             f"{self.engine.vocab_size}), got {eos_token_id}")
        if not isinstance(tenant, str) or not tenant:
            raise ValueError(f"tenant must be a non-empty string, got "
                             f"{tenant!r}")
        if adapter is not None:
            if not isinstance(adapter, str) or not adapter:
                raise ValueError(f"adapter must be a non-empty string or "
                                 f"None, got {adapter!r}")
            if self.engine.adapters is None:
                raise ValueError(
                    f"request names adapter '{adapter}' but this server "
                    "has no adapter pool (construct with "
                    "Server(adapters=AdapterConfig(...)))")
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), rng=rng,
                      eos_token_id=eos_token_id, deadline=deadline,
                      tenant=tenant, priority=int(priority), adapter=adapter)
        self.submit_request(req)
        return TokenStream(req, prompt)

    def submit_request(self, req: Request) -> None:
        """Enqueue a built :class:`Request` (thread-safe; the caller
        checked its shape, this checks the server's state).  One that
        carries committed ``tokens`` resumes from them and is never
        clamped or shed by a degradation rung."""
        if self._stopping:
            raise RuntimeError("server is closed")
        if not self.healthy:
            raise EngineUnhealthy(self._unhealthy_reason
                                  or "serving engine unhealthy")
        if self._draining:
            raise AdmissionError("server is draining: admission stopped, "
                                 "in-flight requests are finishing")
        level, cfg = self._degradation_level, self._degradation_cfg
        if level and cfg is not None and not req.tokens:
            if level >= 4 and req.priority < cfg.shed_below_priority:
                self.metrics.record_shed(req.tenant)
                raise OverloadShed(
                    f"request {req.id} (tenant '{req.tenant}', priority "
                    f"{req.priority}) shed at admission: degradation rung "
                    f"shed_queued rejects priority < "
                    f"{cfg.shed_below_priority}; retry after "
                    f"{cfg.retry_after_s}s", retry_after=cfg.retry_after_s)
            if req.max_new_tokens > cfg.clamp_tokens:
                req.max_new_tokens = cfg.clamp_tokens
                req.mark("degraded_clamp", level=level,
                         clamp=cfg.clamp_tokens)
        # The observer goes on before the enqueue, so that every terminal
        # path (a queued expiry too) reaches the SLO accounting; a
        # refused submit never enqueues and its observer never fires.
        req.observer = self.slo.observe
        self.scheduler.submit(req)
        self.slo.track(req)
        self._wake.set()

    def complete(self, prompt, max_new_tokens: int,
                 timeout: Optional[float] = None, **kwargs) -> np.ndarray:
        """Blocking one-shot: submit and wait for the full sequence."""
        return self.submit(prompt, max_new_tokens, **kwargs).result(
            timeout=timeout)

    def load_adapter(self, name: str, source) -> dict:
        """Hot-load (or replace) a LoRA adapter artifact (a path, bytes or
        a ``(meta, leaves)`` pair) under live traffic; thread-safe.
        Returns the artifact's meta.  Raises ``ValueError`` without a
        pool or for an artifact that does not fit its rank or targets."""
        if self.engine.adapters is None:
            raise ValueError(
                "this server has no adapter pool (construct with "
                "Server(adapters=AdapterConfig(...)))")
        return self.engine.adapters.register(name, source)

    # -- overload control (serving/overload.py) --------------------------

    def set_degradation(self, level: int,
                        config: Optional[DegradationConfig] = None) -> None:
        """Apply a degradation rung (thread-safe, idempotent): 0 full
        service, 1 fresh token budgets clamped, 2 speculative decoding
        off, 3 prefix-cache hits only, 4 low priority shed.  Each acts on
        new admissions only; running streams finish undegraded."""
        cfg = config if config is not None else DegradationConfig()
        self._degradation_cfg = cfg
        self._degradation_level = int(level)
        engine = self.engine
        engine.degradation_level = int(level)
        engine.shed_retry_after = cfg.retry_after_s
        engine.spec_enabled = int(level) < 2

    def shed_queued(self, below_priority: int, retry_after: float,
                    cause: str = "overload") -> int:
        """Shed the queued requests below ``below_priority`` (the
        ladder's rung 4); returns the count."""
        return self.scheduler.shed_queued(below_priority, retry_after,
                                          cause=cause)

    def cancel(self, req: Request) -> None:
        """Withdraw a request: the SLO tracker forgets it (no miss), and
        the loop drops it at its next boundary (a queued one never
        admits, an active one frees its slot with its pages donated)."""
        self.slo.forget(req)
        req.observer = None
        req.cancel_requested = True
        self._wake.set()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admission (``submit`` raises ``AdmissionError``) and
        block until every queued and in-flight request finished, or
        ``timeout`` passed, or the engine went unhealthy.  Returns True
        when drained; ``drain(); close()`` is the graceful shutdown."""
        self._draining = True
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.healthy and not self._stopping:
            if self._idle():
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(min(self._IDLE_POLL, 0.05))
        return self._idle()

    def _idle(self) -> bool:
        engine = self.engine
        return (engine.active_count() == 0 and engine.chunking_count() == 0
                and self.scheduler.queue_depth() == 0)

    def health(self) -> dict:
        """The ``/healthz`` payload: the JAX package's keys and meaning.
        Host state only.  The keys of modules not ported yet are null or
        0: ``compile_events_post_warmup_total`` (compile watch), the
        span clock's ``trace_now_us``/``mono_epoch`` (Queue A 7),
        ``weights_fp`` and ``adoptions_pending`` (Queue A 5).  ``role``
        is "both": a server prefills and decodes, and the split roles
        come with the router (Queue A 5)."""
        engine = self.engine
        busy = engine.active_count() + engine.chunking_count()
        depth = self.scheduler.queue_depth()
        return {
            "ok": self.healthy and not self._draining and not self._stopping,
            "healthy": self.healthy,
            "draining": self._draining,
            "closed": self._stopping,
            "reason": self._unhealthy_reason,
            "role": "both",
            "pid": os.getpid(),
            "uptime_s": round(time.monotonic() - self._started_at, 3),
            "transport": "inproc",
            "compile_events_post_warmup_total": None,
            "trace_now_us": None,
            "mono_epoch": None,
            "active_requests": busy,
            "active_slots": busy,
            "max_slots": engine.max_batch,
            "queued_requests": depth,
            "queue_depth": depth,
            "adoptions_pending": 0,
            "degradation_level": self._degradation_level,
            "weights_fp": None,
            "kv_pages_free": (engine.pool.free_count() if engine.paged
                              else None),
            "kv_pages_total": engine.kv_pages - 1 if engine.paged else None,
            "adapters_resident": (engine.adapters.resident()
                                  if engine.adapters is not None else None),
        }

    def close(self) -> None:
        """Stop the loop; its exit fails whatever is queued, in flight or
        mid-chunk with a structured error and drops the decode graph.  A
        ``decode_wedge`` holding the loop is released first."""
        self._stopping = True
        self._stop.set()
        self._wake.set()
        deadline = time.monotonic() + 60.0
        while self._thread.is_alive() and time.monotonic() < deadline:
            holding = self.engine._holding
            if holding is not None:
                holding.release_wedge()
            self._thread.join(timeout=0.05)
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=10.0)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._http_thread.join(timeout=10.0)
            self._httpd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- engine loop and watchdog ----------------------------------------

    def _release(self, slot: int) -> None:
        try:
            self.scheduler.release(slot)
        except ValueError:
            pass

    def _fail_in_flight(self, msg: str) -> None:
        """Fail the requests being admitted, active, chunking or
        preempted with a structured error and free their slots and
        pages (the loop thread's path; queued requests stay queued)."""
        engine = self.engine
        admitting, self._admitting = self._admitting, None
        if admitting is not None and admitting.state == "active":
            # Failed mid-prefill: not in the engine's tables yet.
            admitting.finish("error", msg)
            if (admitting.slot >= 0 and admitting.slot not in engine._active
                    and admitting.slot not in engine._chunked):
                engine._release_slot_pages(admitting.slot, donate=False)
                self._release(admitting.slot)
        for slot, req in list(engine._active.items()):
            if req.state == "active":
                req.finish("error", msg)
            del engine._active[slot]
            engine._release_slot_pages(slot, donate=False)
            self._release(slot)
        for slot in engine.abort_chunked(msg):
            self._release(slot)
        for req in engine.drain_preempted():
            req.finish("error", msg)

    def _fail_all(self, msg: str, release_slots: bool) -> None:
        """Fail every request in flight and queued with a structured
        error.  ``release_slots=False`` is the watchdog's path: the loop
        thread may still be inside the engine, so only the streams are
        failed (the clients unblock) and the loop frees the slots when
        it returns."""
        if release_slots:
            self._fail_in_flight(msg)
        else:
            engine = self.engine
            admitting = self._admitting
            reqs = ([admitting] if admitting is not None else []) + list(
                engine._active.values()) + [
                st["req"] for st in list(engine._chunked.values())]
            for req in reqs:
                if req.state == "active":
                    req.finish("error", msg)
        for req in self.scheduler.drain_pending():
            req.finish("error", msg)

    def _mark_unhealthy(self, reason: str) -> None:
        """Declare the engine wedged or dead (idempotent): stop
        admission, fail every waiting client with a structured error and
        surface the reason through ``health()``."""
        with self._health_lock:
            if not self.healthy:
                return
            self.healthy = False
            self._unhealthy_reason = reason
        self._fail_all(f"serving engine unhealthy: {reason}",
                       release_slots=False)
        self._wake.set()

    def _watchdog(self) -> None:
        """Trip when work is pending and the loop has not beaten within
        ``watchdog_timeout`` (it is stuck in a prefill or a decode step).
        It cannot unstick the device; it fails the clients at once and
        poisons the server so that callers go elsewhere."""
        poll = max(min(self._watchdog_timeout / 5.0, 1.0), 0.01)
        while not self._stopping and self.healthy:
            if self._stop.wait(poll):
                return
            engine = self.engine
            busy = (engine.active_count() > 0 or engine.chunking_count() > 0
                    or self.scheduler.queue_depth() > 0
                    or self._admitting is not None)
            stale = time.monotonic() - self._last_beat
            if busy and stale > self._watchdog_timeout:
                self.metrics.record_watchdog_trip()
                self._mark_unhealthy(
                    f"decode engine wedged: no heartbeat for {stale:.1f}s "
                    f"with {engine.active_count()} active and "
                    f"{self.scheduler.queue_depth()} queued request(s)")
                return

    def _loop(self) -> None:
        try:
            self._loop_inner()
        except BaseException as e:  # noqa: BLE001 - the thread's death
            self._mark_unhealthy(
                f"engine thread died: {type(e).__name__}: {e}")
        finally:
            msg = ("server closed" if self.healthy else
                   f"serving engine unhealthy: {self._unhealthy_reason}")
            self._fail_all(msg, release_slots=True)
            self.engine.close()  # frees the decode graph's memory

    def _loop_inner(self) -> None:
        while not self._stopping and self.healthy:
            self._last_beat = time.monotonic()
            try:
                self._iteration()
            except Exception as e:  # noqa: BLE001 - the loop survives
                # Fail the requests in flight, then serve the queue on.
                self.metrics.record_engine_error()
                self._fail_in_flight(f"{type(e).__name__}: {e}")

    def _iteration(self) -> None:
        engine, sched = self.engine, self.scheduler
        progressed = False
        while engine.free_capacity() > 0:
            got = sched.acquire()
            if got is None:
                break
            req, slot = got
            # Tracked, so that a wedge or a crash inside the prefill (the
            # request is out of the queue, not yet in the engine) fails
            # its stream too.
            self._admitting = req
            status = engine.admit(req, slot)
            self._admitting = None
            progressed = True
            if status == "no_memory":
                # Page pressure: give the slot back, re-queue at the
                # head of the tenant's queue, and let running requests
                # free pages first.
                sched.release(slot)
                sched.requeue(req)
                break
            if status == "finished":
                sched.release(slot)
            # "chunking" holds its slot: advance_chunks runs its windows.
        # One chunked-prefill window per slot per iteration, after the
        # admissions: short requests admit (and decode, below) between a
        # long prompt's windows.
        for slot, _, status in engine.advance_chunks():
            progressed = True
            if status == "finished":
                sched.release(slot)
        if engine.active_count():
            for slot in engine.step():
                sched.release(slot)
            # Preempted requests resume from their committed tokens, at
            # the head of their tenant's queue.
            for req in engine.drain_preempted():
                sched.requeue(req)
            progressed = True
        if not progressed:
            self._wake.wait(timeout=self._IDLE_POLL)
            self._wake.clear()

    # -- HTTP front end --------------------------------------------------

    def serve_http(self, host: str = "127.0.0.1", port: int = 0):
        """Start the stdlib HTTP front end on a daemon thread; returns
        the bound ``(host, port)``.  Nothing listens unless this is
        called (or ``http_port`` was given)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        if self._httpd is not None:
            raise RuntimeError("the HTTP front end is already serving on "
                               f"{self._httpd.server_address}")
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet: the metrics count
                pass

            def _send(self, code: int, payload: dict,
                      retry_after: Optional[float] = None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if retry_after is not None:
                    self.send_header("Retry-After",
                                     str(max(1, int(round(retry_after)))))
                self.end_headers()
                self.wfile.write(body)

            def _send_text(self, code: int, text: str, content_type: str):
                body = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    payload = server.health()
                    # 503 while wedged, draining or closed, so that a load
                    # balancer stops sending here; the payload says why.
                    self._send(200 if payload["ok"] else 503, payload)
                elif self.path == "/metrics":
                    registry = default_registry()
                    server.metrics.publish(registry)
                    server.slo.publish(registry)
                    self._send_text(
                        200, registry.prometheus_text(),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif self.path == "/metrics.json":
                    self._send(200, server.metrics.snapshot())
                elif self.path == "/slo":
                    self._send(200, server.slo.snapshot())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/generate":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    deadline = body.get("deadline")
                    out = server.complete(
                        np.asarray(body["prompt"], np.int32),
                        int(body.get("max_new_tokens", 16)),
                        temperature=float(body.get("temperature", 0.0)),
                        rng=body.get("seed"),
                        eos_token_id=body.get("eos_token_id"),
                        deadline=deadline,
                        tenant=str(body.get("tenant", "default")),
                        priority=int(body.get("priority", 0)),
                        adapter=body.get("adapter"),
                        # The wait is capped by the client's own deadline
                        # (plus slack): a deadline'd request gets its 504
                        # near the deadline even when the engine stalls.
                        timeout=(float(deadline) + 30.0
                                 if deadline is not None else None),
                    )
                    self._send(200, {"tokens": [int(t) for t in out],
                                     "replica": server.name or None})
                except OverloadShed as e:
                    payload = {"error": str(e)}
                    if e.retry_after is not None:
                        payload["retry_after"] = e.retry_after
                    self._send(503, payload, retry_after=e.retry_after)
                except AdmissionError as e:
                    self._send(429, {"error": str(e)})
                except EngineUnhealthy as e:
                    self._send(503, {"error": str(e)})
                except (DeadlineExceeded, TimeoutError) as e:
                    self._send(504, {"error": str(e)})
                except (KeyError, TypeError, ValueError) as e:
                    # json.JSONDecodeError is a ValueError.
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                except RuntimeError as e:
                    # Structured terminal errors (a wedge, a failed
                    # engine step, a closed server) reach the client as
                    # JSON, never a stdlib 500 page.
                    self._send(503, {"error": str(e)})

        class HTTPServer(ThreadingHTTPServer):
            # The listen backlog: socketserver's 5 drops a burst of
            # connects, whose clients then retry after a second.
            request_queue_size = 128

        self._httpd = HTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="serving-http")
        self._http_thread.start()
        return self._httpd.server_address

"""Thread-safe serving front end over the slot decode engine (the JAX
package's ``serving/api.py``).

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

The fleet surface (``router.py``, ``fleet.py``): ``role`` ("prefill",
"decode" or "both") labels the replica for the router (routing policy
only: the engine can always do both); a request with a
``migration_sink`` prefills here and hands its slot's KV export to the
sink instead of decoding (``_export_for_migration``); ``adopt(req,
export)`` takes a migration in, which the loop imports into a free slot
before any fresh admission (``_drain_adoptions``; a pool that cannot
hold the chain falls back to requeue-and-reprefill, or with a
``resolver`` reports the verdict to the remote router); ``evacuate``
exports every active slot to a sink (a role reassignment).  Over HTTP
(``serve_http``): ``POST /v1/stream`` (NDJSON: the admission verdict,
then ``{"t": token}`` lines, then ``{"done": ...}``, or an ``{"m":
payload}`` line when the request migrates), ``POST /v1/adopt`` (the raw
payload, CRC-verified here; its first line is the import verdict, then
the tokens), ``POST /v1/cancel`` (a stream by the router's id), ``GET
/v1/spec`` (the geometry a ``RemoteServer`` mirrors) and ``POST
/admin/{role,replica_index,degradation,shed_queued,fail,faults,evacuate,
shutdown}``.  The chaos hooks: ``replica_slow`` in ``_fault_hooks``,
``healthz_flap`` in ``health()`` (``resilience/faults.py``).

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

import base64
import collections
import json
import os
import queue
import threading
import time
from typing import Dict, Optional

import numpy as np

from ml_trainer_tpu_torch.resilience.faults import active_plan
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

# The stream item a migration sink pushes between tokens: the router's
# pump adopts the export when it reads it, and the fleet's stream
# endpoint turns it into an ``{"m": payload}`` line.  The string is the
# wire contract ``router.py`` shares.
_KV_MIGRATE = "__kv_migrate__"
# That line around the payload's base64: the bytes ``json.dumps({"m":
# b64}) + "\n"`` gives, written and read in pieces (``fleet.py``) so that
# ~100 MB of base64 is neither scanned by the JSON codec nor copied.
_M_LINE = (b'{"m": "', b'"}\n')


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


def _exit_after_close(server) -> None:
    """``/admin/shutdown`` in a fleet worker: let the reply leave, close
    the server (its loop frees the card), then end the process."""
    time.sleep(0.25)
    try:
        server.close()
    finally:
        os._exit(0)


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
    requests behind it.

    ``role`` ("prefill", "decode" or "both") is the replica's label for
    the router, advertised on ``/healthz``."""

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
                 http_port: Optional[int] = None, role: str = "both",
                 device=None):
        if watchdog_timeout is not None and watchdog_timeout <= 0:
            raise ValueError(f"watchdog_timeout must be positive or None, "
                             f"got {watchdog_timeout}")
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f"role must be 'prefill', 'decode' or 'both', "
                             f"got {role!r}")
        self.role = role
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
        # KV adoptions from another replica's prefill: (request, export,
        # resolver) triples the loop drains (one consumer; producers only
        # append).
        self._adoptions: collections.deque = collections.deque()
        # The fleet's plumbing: the index the chaos faults name replicas
        # by, the replica_slow latch, the evacuation sink a role
        # reassignment installs, how the server is reached ("inproc"
        # until a fleet worker serves it over "http"), the replica name
        # (a standalone server answers "replica": null) and the wire id
        # -> request map that lets /v1/cancel reach a stream.
        self.replica_index = 0
        self._slow_until = 0.0
        self._busy_iters = 0
        self._evacuate_sink = None
        self._evacuated = threading.Event()
        self.transport = "inproc"
        self.name = ""
        self._wire_streams: Dict[int, Request] = {}
        self._wire_lock = threading.Lock()
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
        self._check_open()
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

    def _check_open(self) -> None:
        if self._stopping:
            raise RuntimeError("server is closed")
        if not self.healthy:
            raise EngineUnhealthy(self._unhealthy_reason
                                  or "serving engine unhealthy")
        if self._draining:
            raise AdmissionError("server is draining: admission stopped, "
                                 "in-flight requests are finishing")

    def adopt(self, req: Request, export, resolver=None) -> None:
        """Take a KV migration in (thread-safe): ``req`` was prefilled on
        another replica and ``export`` is its slot's ``KVSlotExport``.
        The loop imports it into a free slot and decodes from there; a
        pool that cannot hold the chain (or a corrupt payload) falls back
        to requeue-and-reprefill from the committed tokens.  Raises
        ``EngineUnhealthy``/``AdmissionError``/``RuntimeError`` when this
        replica cannot take work.

        ``resolver`` (the fleet's ``/v1/adopt``): ``callable(status,
        detail)`` the loop calls with the outcome, ``"adopted"``,
        ``"corrupt"``, ``"weights_mismatch"``, ``"no_memory"``,
        ``"error"``, ``"expired"``, ``"cancelled"``, ``"draining"`` or
        ``"unhealthy"``; with one, a refusal is reported instead of
        requeued here (the remote router holds the payload and its next
        candidates)."""
        self._check_open()
        # This replica's tracker owns the request from here (the prefill
        # replica forgot it at the export).
        req.observer = self.slo.observe
        self.slo.track(req)
        self._adoptions.append((req, export, resolver))
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

    def evacuate(self, sink, timeout: float = 30.0) -> bool:
        """Empty this replica through the migration machinery (a role
        reassignment): the loop exports every active slot's KV and hands
        ``(request, export)`` to ``sink``, hands pending adoptions on,
        and fails queued and mid-chunk requests with a retryable
        ``draining`` error the router redistributes.  Blocks up to
        ``timeout`` for the loop's sweep; True when it ran.  The server
        stays healthy and serving."""
        if not self.engine.paged:
            raise ValueError(
                "evacuate needs a paged engine: the page chain is the "
                "migration unit (kv_page_size > 0)")
        self._evacuated.clear()
        self._evacuate_sink = sink
        self._wake.set()
        return self._evacuated.wait(timeout=timeout)

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
                and self.scheduler.queue_depth() == 0
                and not self._adoptions)

    def _busy(self) -> bool:
        engine = self.engine
        return (engine.active_count() > 0 or engine.chunking_count() > 0
                or self.scheduler.queue_depth() > 0
                or len(self._adoptions) > 0)

    def health(self) -> dict:
        """The ``/healthz`` payload: the JAX package's keys and meaning;
        the router places requests on ``role``, ``queue_depth``,
        ``active_slots``, ``adoptions_pending`` and ``kv_pages_free``.
        Host state only.  The keys of modules not ported yet are null:
        ``compile_events_post_warmup_total`` (compile watch) and the span
        clock's ``trace_now_us``/``mono_epoch`` (ROADMAP.md Queue A 7).
        A matching ``healthz_flap`` fault answers one dropped poll."""
        plan = active_plan()
        if plan is not None and plan.fire("healthz_flap",
                                          host=self.replica_index):
            return {"ok": False, "healthy": False, "draining": False,
                    "closed": False, "flap": True,
                    "reason": "injected healthz flap (transient)"}
        engine = self.engine
        busy = engine.active_count() + engine.chunking_count()
        depth = self.scheduler.queue_depth()
        return {
            "ok": self.healthy and not self._draining and not self._stopping,
            "healthy": self.healthy,
            "draining": self._draining,
            "closed": self._stopping,
            "reason": self._unhealthy_reason,
            "role": self.role,
            "pid": os.getpid(),
            "uptime_s": round(time.monotonic() - self._started_at, 3),
            "transport": self.transport,
            "compile_events_post_warmup_total": None,
            "trace_now_us": None,
            "mono_epoch": None,
            "active_requests": busy,
            "active_slots": busy,
            "max_slots": engine.max_batch,
            "queued_requests": depth,
            "queue_depth": depth,
            "adoptions_pending": len(self._adoptions),
            "degradation_level": self._degradation_level,
            "weights_fp": engine.weights_fp,
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
        while self._adoptions:
            try:
                req, _, resolver = self._adoptions.popleft()
            except IndexError:
                break
            if req.state in ("active", "queued"):
                req.finish("error", msg)
            if resolver is not None:
                # The remote router holds its own copy of the payload:
                # "unhealthy" sends it to its next candidate.
                resolver("unhealthy", msg)
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
            busy = self._busy() or self._admitting is not None
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
        self._fault_hooks()
        if self._evacuate_sink is not None:
            self._run_evacuation()
        # Adoptions first: they already spent a prefill on another
        # replica.
        progressed = self._drain_adoptions()
        while engine.free_capacity() > 0:
            got = sched.acquire()
            if got is None:
                break
            req, slot = got
            self._maybe_slow()
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
            elif status == "active" and req.migration_sink is not None:
                self._export_for_migration(req, slot)
            # "chunking" holds its slot: advance_chunks runs its windows.
        # One chunked-prefill window per slot per iteration, after the
        # admissions: short requests admit (and decode, below) between a
        # long prompt's windows.
        for slot, req, status in engine.advance_chunks():
            progressed = True
            if status == "finished":
                sched.release(slot)
            elif status == "active" and req.migration_sink is not None:
                self._export_for_migration(req, slot)
        if engine.active_count():
            self._maybe_slow()
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

    # -- KV migration and the fleet's hooks (loop thread only) -----------

    def _drain_adoptions(self) -> bool:
        """Import the queued adoptions into free slots.  A chain the
        pool cannot hold, or a payload refused at import, falls back to
        the requeue path (admission re-prefills from the committed
        tokens), or with a resolver is reported to the remote router."""
        from ml_trainer_tpu_torch.serving.transfer import (
            MigrationCorrupt,
            WeightsMismatch,
        )

        engine, sched = self.engine, self.scheduler
        progressed = False
        for _ in range(len(self._adoptions)):
            try:
                req, export, resolver = self._adoptions.popleft()
            except IndexError:
                break
            if req.expired():
                req.finish("expired",
                           f"deadline ({req.deadline}s) passed awaiting "
                           "adoption")
                self.metrics.record_expiry()
                if resolver is not None:
                    self.slo.forget(req)
                    resolver("expired", req.error)
                progressed = True
                continue
            if req.cancel_requested:
                req.finish("error", "cancelled: hedge superseded")
                self.metrics.record_cancellation()
                if resolver is not None:
                    resolver("cancelled", req.error)
                progressed = True
                continue
            slot = sched.acquire_direct(req)
            if slot is None:
                # No free slot: the oldest adoption takes the next one.
                self._adoptions.appendleft((req, export, resolver))
                break
            self._admitting = req
            try:
                status = engine.import_slot(req, slot, export)
            except (MigrationCorrupt, ValueError) as e:
                # Refused before any page was written: never adopt
                # garbage, never poison the loop.  A WeightsMismatch is
                # its own verdict: another candidate of the same weights
                # cannot help, the router re-prefills.
                self._admitting = None
                sched.release(slot)
                verdict = ("weights_mismatch" if isinstance(e, WeightsMismatch)
                           else "corrupt" if isinstance(e, MigrationCorrupt)
                           else "error")
                req.mark(f"adopt_{verdict}", error=str(e))
                if resolver is not None:
                    self.slo.forget(req)
                    resolver(verdict, str(e))
                elif verdict == "error":
                    req.finish("error", f"kv adoption refused: {e}")
                else:
                    sched.requeue(req)
                progressed = True
                continue
            self._admitting = None
            if status == "no_memory":
                sched.release(slot)
                req.mark("adopt_no_memory",
                         kv_pages_free=engine.pool.free_count())
                if resolver is not None:
                    self.slo.forget(req)
                    resolver("no_memory", "kv pool cannot hold the chain")
                else:
                    sched.requeue(req)
            elif status == "error":
                # The import finished the request (an adapter this
                # replica cannot serve); nothing stayed bound.
                sched.release(slot)
                if resolver is not None:
                    resolver("error", req.error)
            else:
                req.mark("adopted", slot=slot)
                if resolver is not None:
                    resolver("adopted", None)
            progressed = True
        return progressed

    def _export_for_migration(self, req: Request, slot: int) -> None:
        """The request just prefilled into ``slot`` and carries a
        ``migration_sink``: ship its KV instead of decoding here.  The
        slot's pages go back with the prefix donation, so the prompt stays
        hot on this replica for the requests placed after it."""
        engine = self.engine
        export = engine.export_slot(slot)
        engine._active.pop(slot, None)
        engine._release_slot_pages(slot, req, donate=True)
        self.scheduler.release(slot)
        # The decode replica's tracker takes over at its adopt().
        self.slo.forget(req)
        req.mark("kv_exported", pages=export.n_pages,
                 kv_bytes=export.nbytes())
        sink, req.migration_sink = req.migration_sink, None
        try:
            sink(req, export)
        except Exception as e:  # noqa: BLE001 - the sink is router code
            req.finish("error",
                       f"kv migration sink failed: {type(e).__name__}: {e}")

    def _fault_hooks(self) -> None:
        """``replica_slow``: a matching fault (its ``step`` counts this
        replica's busy loop iterations) latches a window of ``secs``
        seconds in which every dispatch pays 0.5 s."""
        plan = active_plan()
        if plan is None:
            return
        if self._busy():
            self._busy_iters += 1
            fault = plan.fire("replica_slow", step=self._busy_iters,
                              host=self.replica_index)
            if fault is not None:
                self._slow_until = time.monotonic() + fault.secs
        self._maybe_slow()

    def _maybe_slow(self) -> None:
        """Inside a ``replica_slow`` window: 0.5 s a dispatch, so the
        replica's queue grows under load as a throttled one's does."""
        if time.monotonic() < self._slow_until:
            time.sleep(0.5)

    def _run_evacuation(self) -> None:
        """The role reassignment's sweep: every active slot exported to
        the installed sink, the pending adoptions handed along, the
        mid-chunk and queued requests failed with a retryable
        ``draining`` error.  The replica is empty and healthy after."""
        sink, self._evacuate_sink = self._evacuate_sink, None
        engine, sched = self.engine, self.scheduler
        drain_msg = ("replica draining for role reassignment: request "
                     "redistributed")
        for slot in sorted(engine._active):
            req = engine._active[slot]
            export = engine.export_slot(slot)
            engine._active.pop(slot, None)
            engine._release_slot_pages(slot, req, donate=True)
            sched.release(slot)
            self.slo.forget(req)
            req.mark("evacuated", slot=slot, pages=export.n_pages)
            try:
                sink(req, export)
            except Exception as e:  # noqa: BLE001 - the sink is router code
                req.finish("error",
                           "replica draining for role reassignment; "
                           f"evacuation sink failed: {type(e).__name__}: {e}")
        # Mid-chunk prompts have half-written pages and no token yet: the
        # router resubmits them from scratch.
        for st in engine._chunked.values():
            self.slo.forget(st["req"])
        for slot in engine.abort_chunked(drain_msg):
            self._release(slot)
        while self._adoptions:
            try:
                req, export, resolver = self._adoptions.popleft()
            except IndexError:
                break
            self.slo.forget(req)
            if resolver is not None:
                resolver("draining", "replica draining for role "
                         "reassignment")
                continue
            try:
                sink(req, export)
            except Exception as e:  # noqa: BLE001
                req.finish("error",
                           "replica draining for role reassignment; "
                           f"evacuation sink failed: {type(e).__name__}: {e}")
        for req in sched.drain_pending():
            self.slo.forget(req)
            req.finish("error", drain_msg)
        self._evacuated.set()

    # -- HTTP front end --------------------------------------------------

    def _register_wire(self, wire_id, req: Request) -> None:
        with self._wire_lock:
            self._wire_streams[int(wire_id)] = req

    def _forget_wire(self, wire_id) -> None:
        with self._wire_lock:
            self._wire_streams.pop(int(wire_id), None)

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

            # -- the fleet's NDJSON streams (fleet.py) --------------------
            # HTTP/1.0 bodies that end when the connection closes: the
            # client reads line by line until EOF.

            def _ndjson_start(self):
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.end_headers()

            def _ndjson(self, obj) -> bool:
                return self._write(json.dumps(obj).encode() + b"\n")

            def _write(self, *parts) -> bool:
                try:
                    for part in parts:
                        self.wfile.write(part)
                    self.wfile.flush()
                    return True
                except OSError:  # the client went away
                    return False

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def _stream_tokens(self, req):
                """``req``'s stream as NDJSON until its end: ``{"t":
                token}`` a token, then ``{"done": {...}}``; a migration
                sends ``{"m": base64 payload}`` and ``{"done": {"state":
                "migrated"}}``.  A client that went away cancels the
                request here."""
                from ml_trainer_tpu_torch.serving import transfer

                while True:
                    try:
                        item = req._stream.get(timeout=600.0)
                    except queue.Empty:
                        server.cancel(req)
                        self._ndjson({"done": {
                            "state": "error",
                            "error": "serving engine unhealthy: stream "
                                     "stalled past 600s"}})
                        return
                    if item == _DONE:
                        done = {"state": req.state}
                        if req.error is not None:
                            done["error"] = req.error
                        if req.retry_after is not None:
                            done["retry_after"] = req.retry_after
                        self._ndjson({"done": done})
                        return
                    if (isinstance(item, tuple) and len(item) == 2
                            and item[0] == _KV_MIGRATE):
                        b64 = base64.b64encode(transfer.to_bytes(item[1]))
                        if self._write(_M_LINE[0], b64, _M_LINE[1]):
                            self._ndjson({"done": {"state": "migrated"}})
                        return
                    if not self._ndjson({"t": int(item)}):
                        server.cancel(req)
                        return

            def _refusal(self, e) -> dict:
                """The first line of a refused stream or adoption."""
                if isinstance(e, OverloadShed):
                    return {"status": "shed", "error": str(e),
                            "retry_after": e.retry_after}
                if isinstance(e, AdmissionError):
                    return {"status": "draining", "error": str(e)}
                if isinstance(e, EngineUnhealthy):
                    return {"status": "unhealthy", "error": str(e)}
                return {"status": "closed", "error": str(e)}

            def _post_stream(self):
                """``POST /v1/stream``: the fleet's ``submit_request``.
                The first line is the admission verdict; with
                ``"migrate": true`` the request prefills here and its
                export leaves as an ``m`` line."""
                from ml_trainer_tpu_torch.serving.transfer import (
                    request_from_wire,
                )

                try:
                    body = self._body()
                    req = request_from_wire(body)
                except (KeyError, TypeError, ValueError) as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                if body.get("migrate"):
                    req.migration_sink = (
                        lambda r, exp: r._stream.put((_KV_MIGRATE, exp)))
                wire_id = body.get("id", req.id)
                self._ndjson_start()
                try:
                    server.submit_request(req)
                except RuntimeError as e:  # every refusal's base class
                    self._ndjson(self._refusal(e))
                    return
                server._register_wire(wire_id, req)
                try:
                    self._ndjson({"status": "accepted",
                                  "replica": server.name or None})
                    self._stream_tokens(req)
                finally:
                    server._forget_wire(wire_id)

            def _post_adopt(self):
                """``POST /v1/adopt``: the fleet's ``adopt``.  The raw
                body is the payload (the request's identity in the
                ``X-Request-Meta`` header), CRC-verified here; the first
                line is the import's verdict, then the tokens."""
                from ml_trainer_tpu_torch.serving import transfer

                try:
                    meta = json.loads(self.headers.get("X-Request-Meta",
                                                       "{}"))
                    n = int(self.headers.get("Content-Length", 0))
                    payload = self.rfile.read(n)
                    req = transfer.request_from_wire(meta)
                except (KeyError, TypeError, ValueError) as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                self._ndjson_start()
                try:
                    export = transfer.from_bytes(payload, verify=True)
                except transfer.MigrationCorrupt as e:
                    self._ndjson({"status": "corrupt", "error": str(e)})
                    return
                resolved: queue.Queue = queue.Queue()
                try:
                    server.adopt(req, export,
                                 resolver=lambda s, d: resolved.put((s, d)))
                except RuntimeError as e:
                    self._ndjson(self._refusal(e))
                    return
                wire_id = meta.get("id", req.id)
                server._register_wire(wire_id, req)
                try:
                    try:
                        status, detail = resolved.get(timeout=120.0)
                    except queue.Empty:
                        server.cancel(req)
                        self._ndjson({"status": "error",
                                      "error": "adoption timed out"})
                        return
                    if status != "adopted":
                        line = {"status": status}
                        if detail:
                            line["error"] = detail
                        self._ndjson(line)
                        return
                    self._ndjson({"status": "adopted"})
                    self._stream_tokens(req)
                finally:
                    server._forget_wire(wire_id)

            def _post_cancel(self):
                try:
                    wire_id = int(self._body()["id"])
                except (KeyError, TypeError, ValueError) as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                with server._wire_lock:
                    req = server._wire_streams.get(wire_id)
                if req is not None:
                    server.cancel(req)
                self._send(200, {"ok": req is not None})

            def _post_admin(self) -> bool:
                """The fleet's control plane; False for an unknown
                path."""
                from ml_trainer_tpu_torch.resilience import faults

                try:
                    body = self._body()
                except (TypeError, ValueError) as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                    return True
                path = self.path
                try:
                    if path == "/admin/role":
                        role = body["role"]
                        if role not in ("prefill", "decode", "both"):
                            raise ValueError(f"bad role {role!r}")
                        server.role = role
                        self._send(200, {"ok": True, "role": role})
                    elif path == "/admin/replica_index":
                        server.replica_index = int(
                            body["index"] if "index" in body
                            else body["replica_index"])
                        self._send(200, {"ok": True})
                    elif path == "/admin/degradation":
                        cfg = body.get("config")
                        server.set_degradation(
                            int(body.get("level", 0)),
                            DegradationConfig(**cfg) if cfg else None)
                        self._send(200, {"ok": True})
                    elif path == "/admin/shed_queued":
                        shed = server.shed_queued(
                            int(body.get("below_priority", 0)),
                            float(body.get("retry_after", 1.0)),
                            cause=str(body.get("cause", "overload")))
                        self._send(200, {"shed": shed})
                    elif path == "/admin/fail":
                        server._mark_unhealthy(
                            str(body.get("reason", "failed by admin")))
                        self._send(200, {"ok": True})
                    elif path == "/admin/faults":
                        # A chaos plan in this process (faults.py's
                        # syntax); an empty spec uninstalls.
                        spec = str(body.get("spec", ""))
                        if spec:
                            faults.install(faults.FaultPlan.parse(spec))
                        else:
                            faults.uninstall()
                        self._send(200, {"ok": True, "spec": spec})
                    elif path == "/admin/evacuate":
                        # Each active slot's export rides its own open
                        # stream as an "m" line.
                        ok = server.evacuate(
                            lambda req, exp: req._stream.put(
                                (_KV_MIGRATE, exp)),
                            timeout=float(body.get("timeout", 30.0)))
                        self._send(200, {"ok": ok})
                    elif path == "/admin/shutdown":
                        self._send(200, {"ok": True})
                        if server.transport == "http":
                            # A fleet worker: the process exits once the
                            # reply is on the wire and the server closed.
                            threading.Thread(target=_exit_after_close,
                                             args=(server,),
                                             daemon=True).start()
                        else:
                            threading.Thread(target=server.close,
                                             daemon=True).start()
                    else:
                        return False
                except (KeyError, TypeError, ValueError,
                        NotImplementedError) as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return True

            def do_GET(self):
                if self.path == "/healthz":
                    payload = server.health()
                    # 503 while wedged, draining or closed, so that a load
                    # balancer stops sending here; the payload says why.
                    self._send(200 if payload["ok"] else 503, payload)
                elif self.path == "/v1/spec":
                    # What a RemoteServer mirrors, plus this process's
                    # kernel launches and the decode graph's captures.
                    from ml_trainer_tpu_torch.device import launch_counts

                    eng = server.engine
                    self._send(200, {
                        "max_len": eng.max_len,
                        "vocab_size": eng.vocab_size,
                        "spec_k": eng.spec_k,
                        "kv_page_size": eng.kv_page_size,
                        "paged": eng.paged,
                        "prefill_chunk": eng.prefill_chunk,
                        "max_batch": eng.max_batch,
                        "max_queue": server.scheduler.max_queue,
                        "role": server.role,
                        "pid": os.getpid(),
                        "weights_fp": eng.weights_fp,
                        "compiles": None,
                        "device": str(eng.device),
                        "graph_captures": eng.graph_captures,
                        "launches": launch_counts(),
                    })
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
                if self.path == "/v1/stream":
                    self._post_stream()
                    return
                if self.path == "/v1/adopt":
                    self._post_adopt()
                    return
                if self.path == "/v1/cancel":
                    self._post_cancel()
                    return
                if self.path.startswith("/admin/") and self._post_admin():
                    return
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

"""Thread-safe serving front end over the slot decode engine (the JAX
package's ``serving/api.py``, without the HTTP front end, the router,
the watchdog and the fleet, which are later work).

``Server`` owns the engine, the FIFO scheduler and one worker thread
driving the admit/step loop:

* ``submit(prompt, max_new_tokens, ...) -> TokenStream``: non-blocking;
  the stream iterates tokens as they decode, and ``result()`` blocks for
  the whole sequence (prompt + continuation, ``generate()``'s layout);
* ``complete(...)``: the blocking one-shot;
* ``health()``: a structured snapshot (queue, slots, pages, resident
  adapters, metrics);
* ``load_adapter(name, source)``: hot-load (or replace) a LoRA adapter
  artifact (``Server(adapters=AdapterConfig(...))``); registration is
  host-only, and the upload runs in the engine loop at the adapter's
  next admission;
* ``close()`` or the context manager: stop the loop and fail whatever
  is still queued or in flight, so that no client blocks forever; the
  engine drops its decode graph (``SlotDecodeEngine.close``), so that
  the graph's memory goes back to the allocator.

The worker thread owns the engine: on the card it warms up, captures and
replays the decode step's CUDA graph, while other threads may synchronise
or profile the card.

An exception inside the loop fails the requests in flight with a
structured error and the loop keeps serving new ones.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from ml_trainer_tpu_torch.serving.engine import SlotDecodeEngine
from ml_trainer_tpu_torch.serving.metrics import ServingMetrics
from ml_trainer_tpu_torch.serving.scheduler import (
    _DONE,
    DeadlineExceeded,
    FifoScheduler,
    Request,
)


class TokenStream:
    """Streaming view of one request: iterate tokens as they arrive, or
    ``result()`` for the whole sequence."""

    def __init__(self, req: Request, prompt: np.ndarray):
        self._req = req
        self._prompt = prompt
        self._drained = False

    @property
    def request(self) -> Request:
        return self._req

    def __iter__(self):
        while True:
            item = self._req._stream.get()
            if item == _DONE:
                self._drained = True
                self._raise_on_failure()
                return
            yield item

    def _raise_on_failure(self):
        if self._req.state == "expired":
            raise DeadlineExceeded(self._req.error or "deadline exceeded")
        if self._req.state == "error":
            raise RuntimeError(self._req.error or "serving engine error")

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request finishes; returns ``[prompt + new
        tokens]`` (1-D int32).  Raises ``DeadlineExceeded`` /
        ``RuntimeError`` on failure and ``TimeoutError`` past
        ``timeout``."""
        import queue as _q

        if not self._drained:
            deadline = None if timeout is None else time.monotonic() + timeout
            while True:
                left = None
                if deadline is not None:
                    left = max(deadline - time.monotonic(), 1e-3)
                try:
                    item = self._req._stream.get(timeout=left)
                except _q.Empty:
                    raise TimeoutError(
                        f"request {self._req.id} not finished within "
                        f"{timeout}s ({len(self._req.tokens)} token(s) so far)"
                    ) from None
                if item == _DONE:
                    self._drained = True
                    break
        self._raise_on_failure()
        return np.concatenate(
            [self._prompt, np.asarray(self._req.tokens, np.int32)])

    @property
    def tokens(self) -> list:
        return list(self._req.tokens)


class Server:
    """Continuous-batching server: engine + scheduler + one
    worker thread.  ``device`` defaults to the CUDA card and must be
    where ``model`` lives.

    ``quant_int8`` serves the decode step with int8-quantized
    qkv/proj/fc_in/fc_out weights and per-column scales
    (``ops/kernels/int8_matmul.py``; the prefill stays fp32).  It is
    opt-in and quality-gated (argmax agreement and relative logit error
    against fp32), NOT bit-identical to fp32, and refused with
    ``spec_k > 0`` or ``adapters``.

    ``adapters`` (an ``AdapterConfig`` or its kwargs; the GPT-2 family)
    serves LoRA adapters from a pool of slots beside the base
    (``serving/adapter_pool.py``): ``submit(..., adapter=name)``."""

    # Seconds the idle loop waits for a submission before looking again.
    _IDLE_POLL = 0.02

    def __init__(self, model, max_batch: int = 8, max_queue: int = 64,
                 kv_page_size: int = 0,
                 kv_pages: int = 0, paged_kernel: bool = False,
                 prefix_cache: bool = True, prefix_scope: str = "tenant",
                 max_preemptions: int = 8, spec_k: int = 0, adapters=None,
                 quant_int8: bool = False, prefill_chunk: int = 0,
                 http_port: Optional[int] = None, device=None):
        if http_port is not None:
            raise NotImplementedError(
                "the HTTP front end is not ported yet; see ROADMAP.md Queue A"
            )
        self.metrics = ServingMetrics()
        self.engine = SlotDecodeEngine(
            model, max_batch=max_batch, metrics=self.metrics,
            kv_page_size=kv_page_size, kv_pages=kv_pages,
            paged_kernel=paged_kernel, prefix_cache=prefix_cache,
            prefix_scope=prefix_scope, max_preemptions=max_preemptions,
            spec_k=spec_k, adapters=adapters, quant_int8=quant_int8,
            prefill_chunk=prefill_chunk, device=device,
        )
        self.scheduler = FifoScheduler(max_batch, max_queue=max_queue,
                                       metrics=self.metrics)
        self._wake = threading.Event()
        self._stopping = False
        self._admitting: Optional[Request] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-engine")
        self._thread.start()

    # -- client surface --------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               rng: Optional[int] = None, eos_token_id: Optional[int] = None,
               deadline: Optional[float] = None,
               tenant: str = "default",
               adapter: Optional[str] = None) -> TokenStream:
        """Enqueue one request (thread-safe).  Raises ``AdmissionError``
        past the queue watermark and ``ValueError`` for a request the
        engine could never serve.  ``adapter`` names the LoRA adapter to
        decode with (needs ``Server(adapters=...)``; None: the base
        model); an unknown adapter or a full pool fails the stream with
        a structured error."""
        if self._stopping:
            raise RuntimeError("server is closed")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if prompt.size + max_new_tokens > self.engine.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + new tokens ({max_new_tokens}) "
                f"exceeds the model's max_len ({self.engine.max_len})"
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
                      tenant=tenant, adapter=adapter)
        self.scheduler.submit(req)
        self._wake.set()
        return TokenStream(req, prompt)

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

    def health(self) -> dict:
        engine = self.engine
        return {
            "ok": not self._stopping and self._thread.is_alive(),
            "closed": self._stopping,
            "device": str(engine.device),
            "active_slots": engine.active_count(),
            "max_slots": engine.max_batch,
            "queue_depth": self.scheduler.queue_depth(),
            "kv_pages_free": engine.pool.free_count() if engine.paged else None,
            "kv_pages_total": engine.kv_pages - 1 if engine.paged else None,
            "adapters_resident": (engine.adapters.resident()
                                  if engine.adapters is not None else None),
            "metrics": self.metrics.snapshot(),
        }

    def close(self) -> None:
        self._stopping = True
        self._wake.set()
        self._thread.join(timeout=60.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- engine loop -----------------------------------------------------

    def _release(self, slot: int) -> None:
        try:
            self.scheduler.release(slot)
        except ValueError:
            pass

    def _fail_all(self, msg: str) -> None:
        """Fail every request in flight, being admitted, preempted or
        queued, and free their slots."""
        engine = self.engine
        admitting, self._admitting = self._admitting, None
        if admitting is not None and admitting.state == "active":
            admitting.finish("error", msg)
            if admitting.slot >= 0 and admitting.slot not in engine._active:
                engine._release_slot_pages(admitting.slot, donate=False)
                self._release(admitting.slot)
        for slot, req in list(engine._active.items()):
            if req.state == "active":
                req.finish("error", msg)
            del engine._active[slot]
            engine._release_slot_pages(slot, donate=False)
            self._release(slot)
        for req in engine.drain_preempted() + self.scheduler.drain_pending():
            req.finish("error", msg)

    def _loop(self) -> None:
        try:
            while not self._stopping:
                try:
                    self._iteration()
                except Exception as e:  # noqa: BLE001 - the loop survives
                    self.metrics.record_engine_error()
                    self._fail_all(f"{type(e).__name__}: {e}")
        finally:
            self._fail_all("server closed")
            self.engine.close()  # frees the decode graph's memory

    def _iteration(self) -> None:
        engine, sched = self.engine, self.scheduler
        progressed = False
        while engine.free_capacity() > 0:
            got = sched.acquire()
            if got is None:
                break
            req, slot = got
            self._admitting = req
            status = engine.admit(req, slot)
            self._admitting = None
            progressed = True
            if status == "no_memory":
                # Page pressure: give the slot back, re-queue at the
                # head, and let running requests free pages first.
                sched.release(slot)
                sched.requeue(req)
                break
            if status == "finished":
                sched.release(slot)
        if engine.active_count():
            for slot in engine.step():
                sched.release(slot)
            for req in engine.drain_preempted():
                sched.requeue(req)
            progressed = True
        if not progressed:
            self._wake.wait(timeout=self._IDLE_POLL)
            self._wake.clear()

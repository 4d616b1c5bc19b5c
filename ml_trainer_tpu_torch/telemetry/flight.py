"""Flight recorder: the last N step records and events, dumped on crash
(the JAX package's ``telemetry/flight.py``).

Logs scroll away and metrics aggregate; what a post-mortem needs is the
exact sequence of steps right before the failure.  The recorder is a
bounded ring buffer of small dicts — ``record()`` is a locked deque
append, cheap enough for per-step use — and ``dump()`` writes the whole
ring plus the triggering reason to ``flight_<timestamp>.json``.

Records in the port: the deploy state machine's ``deploy`` events
(``serving/deploy.py``), the autoscaler's actions
(``serving/autoscaler.py``), the router's ``fleet_change`` on
``add_replica``/``remove_replica``/``reassign_role`` and the alert
engine's ``alert`` events.  The dump sites (the trainer's rollback and
preemption, ``Server._mark_unhealthy``) are not wired yet (ROADMAP.md
Queue A 7); ``dump`` itself is whole.

The dump directory resolves, in order: the ``out_dir`` argument, the
``ML_TRAINER_TPU_FLIGHT_DIR`` env var, the recorder's ``default_dir``
(the trainer sets its ``model_dir``), then the system temp dir — so
chaos tests point everything at a tmpdir with one env var.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Optional

from ml_trainer_tpu_torch.utils.logging import get_logger

logger = get_logger("ml_trainer_tpu_torch.telemetry")

FLIGHT_DIR_ENV = "ML_TRAINER_TPU_FLIGHT_DIR"


class FlightRecorder:
    """Bounded ring of telemetry records with crash-dump-to-JSON."""

    def __init__(self, capacity: int = 256,
                 default_dir: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.default_dir = default_dir
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0
        self._context_providers: dict = {}
        self.last_dump_path: Optional[str] = None

    def register_context_provider(self, name: str, fn) -> None:
        """Attach ``fn()``'s JSON-safe payload to every future dump under
        ``context[name]`` — how the memory ledger and compile watch ride
        along on OOM/wedge forensics without the dump sites knowing them.
        Idempotent by name (latest wins); a provider that raises at dump
        time contributes its error string instead of killing the dump."""
        with self._lock:
            self._context_providers[name] = fn

    def _collect_context(self) -> dict:
        with self._lock:
            providers = dict(self._context_providers)
        out = {}
        for name, fn in providers.items():
            try:
                out[name] = fn()
            except Exception as e:  # forensics must never kill the dump
                out[name] = f"context provider failed: {e}"
        return out

    def record(self, kind: str, **data) -> None:
        """Append one record (thread-safe, O(1), never raises on data —
        non-JSON values are stringified at dump time)."""
        with self._lock:
            self._seq += 1
            self._ring.append(
                {"seq": self._seq, "t": round(time.time(), 6),
                 "kind": kind, **data}
            )

    def records(self) -> list:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def _resolve_dir(self, out_dir: Optional[str]) -> str:
        return (
            out_dir
            or os.environ.get(FLIGHT_DIR_ENV)
            or self.default_dir
            or tempfile.gettempdir()
        )

    def payload(self, reason: str, **extra) -> dict:
        """The full dump payload (ring + context providers) WITHOUT
        writing it — what ``dump()`` serializes, and what the fleet
        plane's ``GET /flight`` endpoint (serving/api.py) serves so a
        router can pull a live worker's forensics into an incident
        bundle without the worker touching its own disk."""
        payload = {
            "reason": reason,
            "dumped_at": time.time(),
            "pid": os.getpid(),
            **extra,
            "records": self.records(),
        }
        context = self._collect_context()
        if context:
            payload["context"] = context
        return payload

    def dump(self, reason: str, out_dir: Optional[str] = None,
             **extra) -> Optional[str]:
        """Write ``flight_<ts>.json`` with the ring + reason; returns the
        path, or None when the write itself fails (a dump must never
        take down the process it is documenting)."""
        payload = self.payload(reason, **extra)
        d = self._resolve_dir(out_dir)
        path = os.path.join(
            d, f"flight_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
        )
        try:
            os.makedirs(d, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fp:
                json.dump(payload, fp, default=str)
            os.replace(tmp, path)
        except OSError as e:
            logger.error(f"flight dump failed ({path}): {e}")
            return None
        self.last_dump_path = path
        logger.warning(f"flight recorder dumped: {path} (reason: {reason})")
        return path


# -- process-wide default recorder --------------------------------------
_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder()
        return _default


def reset_recorder() -> None:
    """Tests only: drop the process-wide recorder (long-lived holders of
    the old handle keep recording into it)."""
    global _default
    with _default_lock:
        _default = None

"""Deterministic fault injection (the JAX package's
``resilience/faults.py``), for the faults the port acts on:

* ``nan_grad``      — trainer: the batch at the matching step is turned
                      into NaNs, so the step's loss and gradients are
                      non-finite (the non-finite guard and rollback);
* ``preempt``       — trainer: the matching step requests preemption,
                      the path a SIGTERM takes (finish the step, write an
                      emergency checkpoint, leave ``fit()`` cleanly);
* ``ckpt_truncate`` — checkpoint writer: the checkpoint of the matching
                      epoch has its largest leaf file truncated after
                      the commit rename, a corruption only the CRC32
                      check catches;
* ``decode_error``  — ``NativeLoader``: the matching epoch counts one
                      more failed JPEG decode, so it raises at its end
                      as a corrupt stream makes it;
* ``decode_wedge``  — serving engine: the matching decode step (the
                      engine's ``_step_seq``) blocks before its replay
                      is issued, as a wedged device program would, until
                      ``FaultPlan.release_wedge`` or ``secs`` seconds
                      (default 300); the server's watchdog must fail the
                      clients meanwhile;
* ``replica_kill``  — router: at the matching busy health poll the
                      router kills the replica at fleet index ``host``
                      (``Router._fire_chaos_kill``); a fleet worker
                      process gets a real ``SIGKILL``;
* ``replica_slow``  — server: the matching replica's loop latches a
                      slow-down window of ``secs`` seconds once it is
                      busy (``Server._fault_hooks``), each dispatch in it
                      paying 0.5 s (``Server._maybe_slow``);
* ``healthz_flap``  — server: one ``health()`` of the matching replica
                      answers a dropped poll (the router's flap damping
                      must absorb it);
* ``migration_corrupt`` — router: the next KV migration payload has one
                      bit flipped in flight (``Router._adopt``); the
                      CRC32 check must refuse it.

The JAX package's ``host_kill`` and ``host_hang`` (elastic training)
have no hook here: a plan that names one raises ``NotImplementedError``
when it is parsed, so no fault is accepted and then never fired.

Spec syntax (also read from the ``ML_TRAINER_TPU_FAULTS`` environment
variable)::

    nan_grad@step=12;ckpt_truncate@epoch=1;preempt@step=40
    nan_grad@step=5,count=3;decode_wedge@step=8,secs=60
    replica_kill@step=3,host=2;replica_slow@step=1,host=0,secs=8

Entries are ``kind@key=value[,key=value...]`` separated by ``;``.
Trigger keys: ``step`` (the 1-based global train step, the engine's
decode step, a replica's busy loop iteration or the router's busy
health poll) or ``epoch``; ``count`` is the number of consecutive steps
to fire on (default 1); ``secs`` bounds a ``decode_wedge``'s hold and a
``replica_slow`` window (default 300); ``host`` names the replica's
fleet index for the serving kinds (default 0): a serving hook passes
its own index, so a fault naming ``host=2`` fires only in replica 2's
hook.  Every hook is a no-op when no plan is active, and every fault
fires a bounded number of times.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import List, Optional

ENV_VAR = "ML_TRAINER_TPU_FAULTS"

KINDS = ("nan_grad", "preempt", "ckpt_truncate", "decode_error",
         "decode_wedge", "replica_kill", "replica_slow", "healthz_flap",
         "migration_corrupt")
# The kinds whose ``host`` names a replica's fleet index.
HOSTED_KINDS = ("replica_kill", "replica_slow", "healthz_flap",
                "migration_corrupt")
# The kinds that take ``secs``.
TIMED_KINDS = ("decode_wedge", "replica_slow")
# The JAX package's kinds that have no hook in the port (elastic
# training: ROADMAP.md Queue A 6).
UNPORTED_KINDS = ("host_kill", "host_hang")


@dataclass
class Fault:
    """One injectable fault: fires when its trigger matches, at most
    ``count`` times (consecutive steps for a step trigger)."""

    kind: str
    step: Optional[int] = None
    epoch: Optional[int] = None
    count: int = 1
    secs: float = 300.0
    host: int = 0
    fired: int = 0

    def matches(self, step: Optional[int], epoch: Optional[int],
                host: Optional[int] = None) -> bool:
        if self.fired >= self.count:
            return False
        if host is not None and self.host != host:
            return False
        if self.step is not None:
            return step is not None and (
                self.step <= step < self.step + self.count)
        if self.epoch is not None:
            return epoch is not None and epoch == self.epoch
        return True  # unconditional: fires `count` times, then stops

    def spec(self) -> str:
        parts = []
        if self.step is not None:
            parts.append(f"step={self.step}")
        if self.epoch is not None:
            parts.append(f"epoch={self.epoch}")
        if self.count != 1:
            parts.append(f"count={self.count}")
        if self.kind in HOSTED_KINDS:
            parts.append(f"host={self.host}")
        return self.kind + ("@" + ",".join(parts) if parts else "")


class FaultPlan:
    """A parsed fault list plus the wedge-release latch.  ``fire(kind,
    step=..., epoch=...)`` is the hooks' one entry point: it returns the
    matching :class:`Fault` (one firing consumed) or ``None``; a fault
    conditioned on a key the hook did not pass never fires.
    Thread-safe."""

    def __init__(self, faults: List[Fault]):
        self.faults = list(faults)
        self._lock = threading.Lock()
        self._wedge_release = threading.Event()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        faults = []
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            kind, _, args = entry.partition("@")
            kind = kind.strip()
            if kind in UNPORTED_KINDS:
                raise NotImplementedError(
                    f"fault kind {kind!r} in {entry!r} has no hook in the "
                    "port yet; see ROADMAP.md Queue A")
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} in {entry!r}; "
                    f"expected one of {sorted(KINDS)}")
            kwargs = {}
            for pair in filter(None, (p.strip() for p in args.split(","))):
                key, sep, value = pair.partition("=")
                if not sep:
                    raise ValueError(
                        f"malformed fault trigger {pair!r} in {entry!r} "
                        "(expected key=value)")
                key = key.strip()
                keys = ("step", "epoch", "count") + (
                    ("secs",) if kind in TIMED_KINDS else ()) + (
                    ("host",) if kind in HOSTED_KINDS else ())
                if key not in keys:
                    raise ValueError(
                        f"unknown fault key {key!r} for {kind!r} in "
                        f"{entry!r}; expected {'|'.join(keys)}")
                kwargs[key] = float(value) if key == "secs" else int(value)
            faults.append(Fault(kind=kind, **kwargs))
        return cls(faults)

    def fire(self, kind: str, *, step: Optional[int] = None,
             epoch: Optional[int] = None,
             host: Optional[int] = None) -> Optional[Fault]:
        with self._lock:
            for fault in self.faults:
                if fault.kind == kind and fault.matches(step, epoch, host):
                    fault.fired += 1
                    return fault
        return None

    def hold_wedge(self, fault: Fault) -> None:
        """Block as a wedged decode step would, until ``release_wedge``
        or the fault's ``secs`` bound (an injected fault never hangs a
        process for good)."""
        self._wedge_release.wait(timeout=fault.secs)

    def release_wedge(self) -> None:
        self._wedge_release.set()

    def remaining(self) -> List[Fault]:
        with self._lock:
            return [f for f in self.faults if f.fired < f.count]

    def __repr__(self) -> str:
        return f"FaultPlan({'; '.join(f.spec() for f in self.faults)})"


# The process-wide active plan: a programmatic install wins over the
# environment variable, whose spec is parsed once per value.
_installed: Optional[FaultPlan] = None
_env_cache: tuple = ("", None)
_state_lock = threading.Lock()


def install(plan: FaultPlan) -> FaultPlan:
    global _installed
    with _state_lock:
        _installed = plan
    return plan


def uninstall() -> None:
    global _installed
    with _state_lock:
        _installed = None


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, else one parsed from ``ML_TRAINER_TPU_FAULTS``
    (cached per value), else None."""
    global _env_cache
    with _state_lock:
        if _installed is not None:
            return _installed
        spec = os.environ.get(ENV_VAR, "")
        if not spec:
            return None
        if _env_cache[0] != spec:
            _env_cache = (spec, FaultPlan.parse(spec))
        return _env_cache[1]


@contextlib.contextmanager
def injected(spec_or_plan):
    """Install a plan (or parse a spec string) for the block."""
    plan = (spec_or_plan if isinstance(spec_or_plan, FaultPlan)
            else FaultPlan.parse(spec_or_plan))
    install(plan)
    try:
        yield plan
    finally:
        uninstall()

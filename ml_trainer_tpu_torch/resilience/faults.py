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
                      as a corrupt stream makes it.

The JAX package's other kinds (``decode_wedge``, ``host_kill``, ``host_hang`` and the serving fleet's) have no hook here:
a plan that names one raises ``NotImplementedError`` when it is parsed,
so no fault is accepted and then never fired.

Spec syntax (also read from the ``ML_TRAINER_TPU_FAULTS`` environment
variable)::

    nan_grad@step=12;ckpt_truncate@epoch=1;preempt@step=40
    nan_grad@step=5,count=3

Entries are ``kind@key=value[,key=value...]`` separated by ``;``.
Trigger keys: ``step`` (the 1-based global train step) or ``epoch``;
``count`` is the number of consecutive steps to fire on (default 1).
Every hook is a no-op when no plan is active, and every fault fires a
bounded number of times.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import List, Optional

ENV_VAR = "ML_TRAINER_TPU_FAULTS"

KINDS = ("nan_grad", "preempt", "ckpt_truncate", "decode_error")
# The JAX package's kinds that have no hook in the port.
UNPORTED_KINDS = ("decode_wedge", "host_kill", "host_hang", "replica_kill",
                  "replica_slow", "healthz_flap", "migration_corrupt")


@dataclass
class Fault:
    """One injectable fault: fires when its trigger matches, at most
    ``count`` times (consecutive steps for a step trigger)."""

    kind: str
    step: Optional[int] = None
    epoch: Optional[int] = None
    count: int = 1
    fired: int = 0

    def matches(self, step: Optional[int], epoch: Optional[int]) -> bool:
        if self.fired >= self.count:
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
        return self.kind + ("@" + ",".join(parts) if parts else "")


class FaultPlan:
    """A parsed fault list.  ``fire(kind, step=..., epoch=...)`` is the
    hooks' one entry point: it returns the matching :class:`Fault`
    (one firing consumed) or ``None``; a fault conditioned on a key the
    hook did not pass never fires.  Thread-safe."""

    def __init__(self, faults: List[Fault]):
        self.faults = list(faults)
        self._lock = threading.Lock()

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
                if key not in ("step", "epoch", "count"):
                    raise ValueError(
                        f"unknown fault key {key!r} in {entry!r}; "
                        "expected step|epoch|count")
                kwargs[key] = int(value)
            faults.append(Fault(kind=kind, **kwargs))
        return cls(faults)

    def fire(self, kind: str, *, step: Optional[int] = None,
             epoch: Optional[int] = None) -> Optional[Fault]:
        with self._lock:
            for fault in self.faults:
                if fault.kind == kind and fault.matches(step, epoch):
                    fault.fired += 1
                    return fault
        return None

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

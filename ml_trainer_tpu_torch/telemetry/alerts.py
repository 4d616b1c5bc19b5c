"""Declarative alert rules over the Watchtower TSDB, one alerting path
(the JAX package's ``telemetry/alerts.py``).

The autoscaler's burn watch (``serving/autoscaler.py``) and the deploy
canary's burn watch (``serving/deploy.py``) run as :class:`AlertRule`
instances on an :class:`AlertEngine`, beside declarative rules evaluated
against a :class:`~.watchtower.TimeSeriesStore`, so every alert takes
the same path: a flight ``alert`` event, ``alert_active{rule=}`` /
``alerts_fired_total{rule=}`` instruments and the rule's action
callbacks.  The severity-``page`` incident trigger is an argument
(``incident_trigger``); the port's router leaves it unset until
incident bundles are ported (ROADMAP.md Queue A 7), so a ``page`` rule
fires and records and triggers nothing.

Rule grammar (``expr``)::

    serving_queue_depth > 8                      # threshold on last value
    serving_queue_depth{replica=decode0} > 8     # label-filtered
    rate(requests_total[30s]) < 0.1              # rate of change
    avg(serving_slo_burn_rate{slo=ttft}[60s]) >= 2.0   # windowed burn
    max(train_step_ms_p99[120s]) > 500
    delta(kv_pages_free[60s]) < -100
    quantile(0.5, serving_ttft_seconds[5s]) > 0.2      # histogram window
    absent(cluster_heartbeat_age_s[30s])         # missing / stale series

A selector matching several series evaluates per label group and holds
independent pending/firing state per group (the Prometheus model):
one rule watches every replica.  ``for_s`` holds a rule in ``pending``
until the predicate stays true that long; ``for_count`` requires that
many CONSECUTIVE true evaluations (the poll-streak semantics the
pre-existing watchers pinned); ``mode="event"`` fires on every true
evaluation with no latched state (the straggler detector's re-fire
behavior).  Watcher-hosted rules skip ``expr`` entirely and are driven
through :meth:`AlertEngine.observe` with an externally supplied clock,
which keeps the existing fake-clock tests pinning them intact.
"""

from __future__ import annotations

import collections
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ml_trainer_tpu_torch.telemetry.watchtower import (
    TimeSeriesStore, bucket_quantile, render_series_key,
)

SEVERITIES = ("info", "warn", "page")

_SEL = (
    r"(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"(?:\[(?P<window>[0-9.]+)s\])?"
)
_OP = r"(?P<op>>=|<=|==|!=|>|<)"
_NUM = r"(?P<threshold>[-+0-9.eE]+)"
_ABSENT_RE = re.compile(rf"^absent\(\s*{_SEL}\s*\)$")
_FUNC_RE = re.compile(
    rf"^(?P<fn>rate|avg|max|min|delta)\(\s*{_SEL}\s*\)\s*{_OP}\s*{_NUM}$"
)
_QUANT_RE = re.compile(
    rf"^quantile\(\s*(?P<q>[0-9.]+)\s*,\s*{_SEL}\s*\)\s*{_OP}\s*{_NUM}$"
)
_LAST_RE = re.compile(rf"^{_SEL}\s*{_OP}\s*{_NUM}$")

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


def _parse_labels(text: Optional[str]) -> dict:
    out: dict = {}
    for pair in filter(None, (p.strip() for p in (text or "").split(","))):
        key, sep, value = pair.partition("=")
        if not sep:
            raise ValueError(f"malformed label matcher {pair!r}")
        out[key.strip()] = value.strip().strip('"')
    return out


def _win(points: list, window_s: Optional[float],
         now: Optional[float]) -> list:
    return TimeSeriesStore._window(points, window_s, now)


def _rate_of(points: list) -> Optional[float]:
    if len(points) < 2:
        return None
    span = points[-1][0] - points[0][0]
    if span <= 0:
        return None
    increase = 0.0
    for (_, prev), (_, cur) in zip(points, points[1:]):
        increase += cur - prev if cur >= prev else cur
    return increase / span


def _compile_expr(expr: str) -> Callable:
    """``expr`` -> ``fn(store, now) -> [(labels, ok, value), ...]``.

    Per matched label group: ``ok`` is the predicate verdict, ``None``
    when the window holds no data (the caller decides whether no-data
    resolves or holds the rule)."""
    expr = expr.strip()

    m = _ABSENT_RE.match(expr)
    if m is not None:
        name = m.group("name")
        labels = _parse_labels(m.group("labels"))
        window = float(m.group("window")) if m.group("window") else None

        def _eval_absent(store, now):
            ok = store.absent(name, labels, within_s=window, now=now)
            return [(dict(labels), bool(ok), None)]

        return _eval_absent

    m = _QUANT_RE.match(expr)
    if m is not None:
        name = m.group("name")
        labels = _parse_labels(m.group("labels"))
        window = float(m.group("window")) if m.group("window") else None
        q = float(m.group("q"))
        cmp = _OPS[m.group("op")]
        threshold = float(m.group("threshold"))

        def _eval_quantile(store, now):
            out = []
            groups = store.bucket_deltas(name, labels, window, now)
            for gkey, deltas in sorted(groups.items()):
                value = bucket_quantile(deltas, q)
                ok = cmp(value, threshold) if value is not None else None
                out.append((dict(gkey), ok, value))
            return out

        return _eval_quantile

    m = _FUNC_RE.match(expr) or _LAST_RE.match(expr)
    if m is None:
        raise ValueError(f"unparseable alert expr {expr!r}")
    fn = m.groupdict().get("fn") or "last"
    name = m.group("name")
    labels = _parse_labels(m.group("labels"))
    window = float(m.group("window")) if m.group("window") else None
    cmp = _OPS[m.group("op")]
    threshold = float(m.group("threshold"))

    def _eval_series(store, now):
        out = []
        for slabels, points in store.select(name, labels):
            pts = _win(points, window, now)
            if fn == "last":
                value = pts[-1][1] if pts else None
            elif fn == "rate":
                value = _rate_of(pts)
            elif fn == "delta":
                value = (
                    pts[-1][1] - pts[0][1] if len(pts) >= 2 else None
                )
            elif fn == "avg":
                value = (
                    sum(v for _, v in pts) / len(pts) if pts else None
                )
            elif fn == "max":
                value = max((v for _, v in pts), default=None)
            else:  # min
                value = min((v for _, v in pts), default=None)
            ok = cmp(value, threshold) if value is not None else None
            out.append((slabels, ok, value))
        return out

    return _eval_series


class _GroupState:
    __slots__ = ("state", "count", "since", "value", "fired_at")

    def __init__(self):
        self.state = "inactive"  # inactive | pending | firing
        self.count = 0
        self.since: Optional[float] = None
        self.value: Optional[float] = None
        self.fired_at: Optional[float] = None


class AlertRule:
    """One declarative (``expr``) or externally-driven (``observe``)
    alert rule, with per-label-group pending/firing state."""

    def __init__(self, name: str, expr: Optional[str] = None, *,
                 for_s: float = 0.0, for_count: int = 1,
                 severity: str = "warn", mode: str = "level",
                 labels: Optional[dict] = None,
                 actions: Sequence[Callable] = (),
                 on_no_data: str = "resolve",
                 description: str = ""):
        if severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {severity!r}"
            )
        if mode not in ("level", "event"):
            raise ValueError(f"mode must be level|event, got {mode!r}")
        if on_no_data not in ("resolve", "skip"):
            raise ValueError(
                f"on_no_data must be resolve|skip, got {on_no_data!r}"
            )
        if for_count < 1:
            raise ValueError(f"for_count must be >= 1, got {for_count}")
        self.name = name
        self.expr = expr
        self._eval = _compile_expr(expr) if expr is not None else None
        self.for_s = float(for_s)
        self.for_count = int(for_count)
        self.severity = severity
        self.mode = mode
        self.labels = dict(labels or {})
        self.actions = list(actions)
        self.on_no_data = on_no_data
        self.description = description
        self._lock = threading.Lock()
        self._groups: Dict[tuple, _GroupState] = {}

    # -- state ------------------------------------------------------------

    def _group(self, labels: Optional[dict]) -> Tuple[tuple, _GroupState]:
        gkey = tuple(sorted(
            (str(k), str(v)) for k, v in (labels or {}).items()
        ))
        with self._lock:
            st = self._groups.get(gkey)
            if st is None:
                st = self._groups[gkey] = _GroupState()
        return gkey, st

    def firing(self, labels: Optional[dict] = None) -> bool:
        """True when the (label group's) state is ``firing``."""
        if labels is None:
            with self._lock:
                return any(
                    st.state == "firing" for st in self._groups.values()
                )
        _, st = self._group(labels)
        return st.state == "firing"

    def n_firing(self) -> int:
        with self._lock:
            return sum(
                1 for st in self._groups.values() if st.state == "firing"
            )

    def count(self, labels: Optional[dict] = None) -> int:
        """Consecutive true evaluations of the group — the poll streak
        the pre-engine watchers kept by hand."""
        _, st = self._group(labels)
        return st.count

    def reset(self, labels: Optional[dict] = None) -> None:
        """Forget state (all groups, or one) WITHOUT a resolved event —
        the watchers' post-action streak reset."""
        with self._lock:
            if labels is None:
                self._groups.clear()
            else:
                gkey = tuple(sorted(
                    (str(k), str(v)) for k, v in labels.items()
                ))
                self._groups.pop(gkey, None)

    def summary(self) -> dict:
        with self._lock:
            groups = {
                render_series_key("", dict(g)) or "<all>": {
                    "state": st.state, "count": st.count,
                    "since": st.since, "value": st.value,
                }
                for g, st in self._groups.items()
            }
        return {
            "name": self.name, "expr": self.expr,
            "severity": self.severity, "mode": self.mode,
            "for_s": self.for_s, "for_count": self.for_count,
            "description": self.description, "groups": groups,
        }


class AlertEngine:
    """Evaluates rules and owns the one firing path: flight ``alert``
    events, ``alert_active{rule=}`` / ``alerts_fired_total{rule=}``,
    rule actions, and the severity-``page`` incident trigger."""

    def __init__(self, rules: Sequence[AlertRule] = (), *,
                 store: Optional[TimeSeriesStore] = None,
                 registry=None, flight=None,
                 incident_trigger: Optional[Callable] = None,
                 history_cap: int = 256,
                 clock: Callable[[], float] = time.time):
        self.store = store
        self.rules: "collections.OrderedDict[str, AlertRule]" = (
            collections.OrderedDict()
        )
        self._registry = registry
        self._flight = flight
        self.incident_trigger = incident_trigger
        self._clock = clock
        self._lock = threading.Lock()
        self._history: collections.deque = collections.deque(
            maxlen=history_cap
        )
        self._active_g = None
        self._fired_c = None
        for rule in rules:
            self.add_rule(rule)

    # -- wiring -----------------------------------------------------------

    def add_rule(self, rule: AlertRule) -> AlertRule:
        with self._lock:
            self.rules[rule.name] = rule
        return rule

    def rule(self, name: str) -> AlertRule:
        return self.rules[name]

    def _instruments(self):
        if self._active_g is None:
            if self._registry is None:
                from ml_trainer_tpu_torch.telemetry.registry import (
                    default_registry,
                )

                self._registry = default_registry()
            self._active_g = self._registry.gauge(
                "alert_active",
                "label groups currently firing, by rule",
                labelnames=("rule",),
            )
            self._fired_c = self._registry.counter(
                "alerts_fired_total",
                "alert firings (incl. event-mode re-fires), by rule",
                labelnames=("rule",),
            )
        return self._active_g, self._fired_c

    def _recorder(self):
        if self._flight is not None:
            return self._flight
        from ml_trainer_tpu_torch.telemetry.flight import get_recorder

        return get_recorder()

    # -- the one firing path ----------------------------------------------

    def _emit(self, rule: AlertRule, state: str, value, labels: dict,
              now: float, extra: dict) -> dict:
        ev = {
            "t": round(float(now), 6), "rule": rule.name,
            "severity": rule.severity, "state": state,
            "value": value, "labels": dict(rule.labels, **labels),
        }
        if extra:
            ev.update(extra)
        with self._lock:
            self._history.append(ev)
        active_g, fired_c = self._instruments()
        if state in ("firing", "event"):
            fired_c.labels(rule=rule.name).inc()
        active_g.labels(rule=rule.name).set(float(rule.n_firing()))
        self._recorder().record("alert", **{
            k: v for k, v in ev.items() if k != "t"
        })
        for fn in rule.actions:
            try:
                fn(ev)
            except Exception:  # noqa: BLE001 — actions never kill the tick
                pass
        if (
            state in ("firing", "event")
            and rule.severity == "page"
            and self.incident_trigger is not None
        ):
            try:
                self.incident_trigger(
                    f"alert: {rule.name}"
                    + (f" {render_series_key('', ev['labels'])}"
                       if ev["labels"] else "")
                )
            except Exception:  # noqa: BLE001
                pass
        return ev

    def _transition(self, rule: AlertRule, ok: Optional[bool],
                    now: float, value, labels: dict,
                    extra: dict) -> bool:
        """Advance one label group's state machine; returns True when
        the group is firing after this evaluation."""
        if ok is None:
            if rule.on_no_data == "skip":
                return rule.firing(labels)
            ok = False
        if rule.mode == "event":
            if ok:
                self._emit(rule, "event", value, labels, now, extra)
            return bool(ok)
        _, st = rule._group(labels)
        if ok:
            st.count += 1
            st.value = value
            if st.since is None:
                st.since = now
            held = now - st.since >= rule.for_s
            if st.state == "inactive":
                st.state = "pending"
            if (
                st.state == "pending"
                and st.count >= rule.for_count
                and held
            ):
                st.state = "firing"
                st.fired_at = now
                self._emit(rule, "firing", value, labels, now, extra)
        else:
            was_firing = st.state == "firing"
            st.count = 0
            st.since = None
            st.state = "inactive"
            st.value = value
            if was_firing:
                self._emit(rule, "resolved", value, labels, now, extra)
        return st.state == "firing"

    def observe(self, rule_name: str, ok: bool,
                now: Optional[float] = None,
                value: Optional[float] = None,
                labels: Optional[dict] = None,
                extra: Optional[dict] = None) -> bool:
        """Externally-driven evaluation — how the autoscaler / deploy /
        straggler watchers feed their rules (their own clocks, their own
        predicates); returns True while the group is firing."""
        rule = self.rules[rule_name]
        if now is None:
            now = self._clock()
        return self._transition(
            rule, bool(ok), now, value, dict(labels or {}),
            dict(extra or {}),
        )

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One declarative tick: every ``expr`` rule against the store.
        A label group that vanished from the selector resolves (its
        series aged out or the replica left).  Returns the events
        emitted this tick."""
        if self.store is None:
            return []
        if now is None:
            now = self._clock()
        emitted_before = len(self._history)
        for rule in list(self.rules.values()):
            if rule._eval is None:
                continue
            try:
                results = rule._eval(self.store, now)
            except ValueError:
                continue
            seen = set()
            for labels, ok, value in results:
                gkey = tuple(sorted(
                    (str(k), str(v)) for k, v in labels.items()
                ))
                seen.add(gkey)
                self._transition(rule, ok, now, value, labels, {})
            with rule._lock:
                stale = [
                    g for g in rule._groups
                    if g not in seen and rule._groups[g].state != "inactive"
                ]
            for g in stale:
                self._transition(rule, False, now, None, dict(g), {})
        with self._lock:
            return list(self._history)[
                emitted_before - len(self._history):
            ] if len(self._history) > emitted_before else []

    # -- views ------------------------------------------------------------

    def history(self) -> List[dict]:
        with self._lock:
            return list(self._history)

    def active(self) -> List[dict]:
        out = []
        for rule in self.rules.values():
            with rule._lock:
                for g, st in rule._groups.items():
                    if st.state == "firing":
                        out.append({
                            "rule": rule.name,
                            "severity": rule.severity,
                            "labels": dict(g),
                            "since": st.since,
                            "value": st.value,
                        })
        return out

    def payload(self) -> dict:
        """JSON artifact for incident bundles (``alerts.json``)."""
        return {
            "rules": [r.summary() for r in self.rules.values()],
            "active": self.active(),
            "history": self.history(),
        }


def default_fleet_rules() -> List[AlertRule]:
    """A starter rule pack for the router's fleet store: not installed
    by default (existing tests pin the bare router), opt-in via
    ``Router(alert_rules=default_fleet_rules())``."""
    return [
        AlertRule(
            "replica_unreachable",
            'absent(serving_requests_completed[10s])',
            severity="warn",
            description="no fresh samples scraped from any replica",
        ),
        AlertRule(
            "slo_burn_high",
            'avg(serving_slo_burn_rate[60s]) >= 2.0',
            for_s=5.0, severity="page",
            description="fleet SLO burn sustained above budget",
        ),
        AlertRule(
            "kv_pool_exhausted",
            'serving_kv_pages_free < 1',
            for_count=3, severity="warn",
            description="paged KV pool fully allocated",
        ),
        AlertRule(
            "post_warmup_recompile",
            'delta(compile_events_post_warmup_total[300s]) > 0',
            severity="page",
            description="a compiled program changed after warmup",
        ),
    ]

"""Watchtower TSDB: bounded in-process time series behind every gauge
(the JAX package's ``telemetry/watchtower.py``).

The registry (``registry.py``) exposes point-in-time values; Watchtower
is the history behind them.  A :class:`TimeSeriesStore` keeps a bounded
ring of ``(t, value)`` points per series.  In the port the router's
health poll samples the process registry into its store
(``Router.watchtower``) and evaluates the alert rules on it; the other
feeds the JAX package has (the trainer's log-sync, a server's
``/metrics`` hit, the router's scrape of every worker's exposition) and
the ``/dash`` endpoints wait for the rest of the telemetry port
(ROADMAP.md Queue A 7).  ``ingest_exposition`` is whole.

Sampling is pure host work: no device calls.  Histograms are stored the
way Prometheus exposes them: cumulative ``name_bucket{le=...}`` series
plus ``name_sum`` / ``name_count``, so :meth:`quantile_over_time` can
diff the cumulative vectors across a window and interpolate inside the
winning bucket (the ``histogram_quantile`` arithmetic).

The alert engine (``alerts.py``) evaluates declarative rules over this
store; :func:`render_dashboard` renders it as one self-contained HTML
page of stat tiles and SVG sparklines (stdlib only).
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

CAPACITY_ENV = "ML_TRAINER_TPU_WATCHTOWER_CAP"
DEFAULT_CAPACITY = 512

# Series prefixes every flight dump carries (the `watchtower` context
# provider): the trend INTO a failure, not just the instant.
DEFAULT_FLIGHT_SERIES = (
    "train_goodput_fraction",
    "serving_slo_burn_rate",
    "serving_kv_pages_free",
    "compile_events_post_warmup_total",
)

_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return v.replace(r"\"", '"').replace(r"\n", "\n").replace(r"\\", "\\")


def _fmt_le(v: float) -> str:
    """Bucket bound rendered the way export.py renders ``le=`` values,
    so registry-sampled and exposition-ingested series share keys."""
    if math.isinf(v):
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _key(name: str, labels: Optional[dict]) -> tuple:
    return (
        name,
        tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items())),
    )


def render_series_key(name: str, labels: dict) -> str:
    """``name{a=b,c=d}`` — the human/JSON spelling of one series."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class TimeSeriesStore:
    """Bounded per-series rings of ``(t, value)`` samples (thread-safe).

    ``capacity`` bounds every series ring (oldest point evicted first);
    ``min_interval_s`` throttles :meth:`sample_registry` /
    :meth:`ingest_exposition` sweeps so a hammered ``/metrics`` endpoint
    cannot grow the store faster than the configured cadence."""

    def __init__(self, capacity: Optional[int] = None,
                 min_interval_s: float = 0.0):
        if capacity is None:
            capacity = int(os.environ.get(CAPACITY_ENV, DEFAULT_CAPACITY))
        if capacity < 2:
            # rate()/quantile_over_time() diff the window's first and
            # last points — a 1-point ring can never answer them.
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.capacity = int(capacity)
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        self._data: Dict[tuple, collections.deque] = {}
        self._kinds: Dict[str, str] = {}
        self._last_sweep: Dict[str, float] = {}

    # -- ingestion --------------------------------------------------------

    def append(self, name: str, value: float,
               labels: Optional[dict] = None,
               t: Optional[float] = None) -> None:
        """One point on one series (ring-bounded, O(1))."""
        if t is None:
            t = time.time()
        key = _key(name, labels)
        with self._lock:
            ring = self._data.get(key)
            if ring is None:
                ring = self._data[key] = collections.deque(
                    maxlen=self.capacity
                )
            ring.append((float(t), float(value)))

    def _sweep_ok(self, source: str, t: float) -> bool:
        if self.min_interval_s <= 0.0:
            return True
        with self._lock:
            last = self._last_sweep.get(source)
            if last is not None and t - last < self.min_interval_s:
                return False
            self._last_sweep[source] = t
            return True

    def sample_registry(self, registry, t: Optional[float] = None,
                        extra_labels: Optional[dict] = None,
                        force: bool = False) -> int:
        """One sweep over every registry instrument; returns the number
        of points appended.  Histogram series are stored CUMULATIVE per
        ``le`` (exposition shape) beside ``_sum`` / ``_count``."""
        if t is None:
            t = time.time()
        if not force and not self._sweep_ok("registry", t):
            return 0
        extra = dict(extra_labels or {})
        appended = 0
        for m in registry.collect():
            self._kinds.setdefault(m.name, m.kind)
            for key, _ in sorted(m.series().items()):
                labels = dict(zip(m.labelnames, key))
                labels.update(extra)
                if m.kind == "histogram":
                    h = m._get(key)
                    if h is None:
                        continue
                    self.append(f"{m.name}_count", h["count"], labels, t)
                    self.append(f"{m.name}_sum", h["sum"], labels, t)
                    cum = 0
                    for ub, c in zip(m.buckets, h["buckets"]):
                        cum += c
                        self.append(
                            f"{m.name}_bucket", cum,
                            dict(labels, le=_fmt_le(ub)), t,
                        )
                    self.append(
                        f"{m.name}_bucket", h["count"],
                        dict(labels, le="+Inf"), t,
                    )
                    appended += 3 + len(m.buckets)
                else:
                    self.append(m.name, float(m._get(key)), labels, t)
                    appended += 1
        return appended

    def ingest_exposition(self, text: str, t: Optional[float] = None,
                          extra_labels: Optional[dict] = None,
                          source: str = "exposition",
                          force: bool = False) -> int:
        """One Prometheus text exposition (a worker's scraped
        ``/metrics`` bytes) appended as points; ``extra_labels`` are
        merged in (existing labels win) — the federation relabeling
        applied to history.  Returns the number of points appended."""
        from ml_trainer_tpu_torch.telemetry.federation import (
            _SAMPLE_RE, parse_exposition,
        )

        if t is None:
            t = time.time()
        if not force and not self._sweep_ok(source, t):
            return 0
        extra = {
            str(k): str(v) for k, v in (extra_labels or {}).items()
        }
        appended = 0
        for fam in parse_exposition(text):
            if fam.get("type"):
                self._kinds.setdefault(fam["name"], fam["type"])
            for line in fam["samples"]:
                m = _SAMPLE_RE.match(line)
                if m is None:
                    continue
                try:
                    value = float(m.group("rest").split()[0])
                except (ValueError, IndexError):
                    continue
                if math.isnan(value):
                    continue
                labels = {
                    k: _unescape(v)
                    for k, v in _LABEL_RE.findall(m.group("labels") or "")
                }
                for k, v in extra.items():
                    labels.setdefault(k, v)
                self.append(m.group("name"), value, labels, t)
                appended += 1
        return appended

    # -- selection --------------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted({k[0] for k in self._data})

    def kind(self, name: str) -> Optional[str]:
        return self._kinds.get(name)

    def select(self, name: str,
               labels: Optional[dict] = None) -> List[Tuple[dict, list]]:
        """Every series named ``name`` whose labels are a superset of
        ``labels``: ``[(labels_dict, [(t, v), ...]), ...]``."""
        want = {
            (str(k), str(v)) for k, v in (labels or {}).items()
        }
        out = []
        with self._lock:
            for (n, lk), ring in self._data.items():
                if n == name and want <= set(lk):
                    out.append((dict(lk), list(ring)))
        out.sort(key=lambda p: sorted(p[0].items()))
        return out

    def _one(self, name: str, labels: Optional[dict]) -> Optional[list]:
        matched = self.select(name, labels)
        if not matched:
            return None
        if len(matched) > 1:
            raise ValueError(
                f"{render_series_key(name, labels or {})} matches "
                f"{len(matched)} series — add labels to disambiguate"
            )
        return matched[0][1]

    def last(self, name: str, labels: Optional[dict] = None,
             n: int = 1) -> List[Tuple[float, float]]:
        """The last ``n`` points of ONE series (ambiguity raises)."""
        points = self._one(name, labels)
        return list(points[-n:]) if points else []

    def last_value(self, name: str,
                   labels: Optional[dict] = None) -> Optional[float]:
        points = self.last(name, labels, n=1)
        return points[-1][1] if points else None

    def absent(self, name: str, labels: Optional[dict] = None,
               within_s: Optional[float] = None,
               now: Optional[float] = None) -> bool:
        """True when no matching series exists — or, with ``within_s``,
        when none has a sample newer than ``now - within_s`` (a stale
        feed is as alarming as a missing one)."""
        matched = self.select(name, labels)
        if not matched:
            return True
        if within_s is None:
            return False
        now = time.time() if now is None else now
        return all(
            not points or points[-1][0] < now - within_s
            for _, points in matched
        )

    # -- windowed arithmetic ----------------------------------------------

    @staticmethod
    def _window(points: list, window_s: Optional[float],
                now: Optional[float]) -> list:
        if window_s is None or not points:
            return points
        end = points[-1][0] if now is None else now
        lo = end - window_s
        return [p for p in points if lo <= p[0] <= end]

    def rate(self, name: str, labels: Optional[dict] = None,
             window_s: Optional[float] = None,
             now: Optional[float] = None) -> Optional[float]:
        """Counter increase per second over the window, reset-aware
        (a decrease — process restart — contributes the new value, the
        Prometheus ``rate()`` convention).  None without >= 2 points."""
        points = self._one(name, labels)
        points = self._window(points or [], window_s, now)
        if len(points) < 2:
            return None
        span = points[-1][0] - points[0][0]
        if span <= 0:
            return None
        increase = 0.0
        for (_, prev), (_, cur) in zip(points, points[1:]):
            increase += cur - prev if cur >= prev else cur
        return increase / span

    def delta(self, name: str, labels: Optional[dict] = None,
              window_s: Optional[float] = None,
              now: Optional[float] = None) -> Optional[float]:
        """last - first over the window (gauge movement)."""
        points = self._one(name, labels)
        points = self._window(points or [], window_s, now)
        if len(points) < 2:
            return None
        return points[-1][1] - points[0][1]

    def avg(self, name: str, labels: Optional[dict] = None,
            window_s: Optional[float] = None,
            now: Optional[float] = None) -> Optional[float]:
        points = self._one(name, labels)
        points = self._window(points or [], window_s, now)
        if not points:
            return None
        return sum(v for _, v in points) / len(points)

    def minmax(self, name: str, fn, labels: Optional[dict] = None,
               window_s: Optional[float] = None,
               now: Optional[float] = None) -> Optional[float]:
        points = self._one(name, labels)
        points = self._window(points or [], window_s, now)
        if not points:
            return None
        return fn(v for _, v in points)

    def bucket_deltas(self, name: str, labels: Optional[dict] = None,
                      window_s: Optional[float] = None,
                      now: Optional[float] = None) -> Dict[tuple, dict]:
        """Per-group cumulative observation counts accumulated INSIDE
        the window, from the stored ``name_bucket{le=}`` series:
        ``{group_labels_tuple: {le_float: cum_count}}`` — the input
        :func:`bucket_quantile` interpolates over.  Groups are the
        non-``le`` label sets (one per tenant/replica/...)."""
        groups: Dict[tuple, dict] = {}
        for slabels, points in self.select(f"{name}_bucket", labels):
            le = slabels.get("le")
            if le is None:
                continue
            le_f = float("inf") if le == "+Inf" else float(le)
            gkey = tuple(sorted(
                (k, v) for k, v in slabels.items() if k != "le"
            ))
            points = self._window(points, window_s, now)
            if len(points) < 2:
                continue
            d = points[-1][1] - points[0][1]
            groups.setdefault(gkey, {})[le_f] = max(d, 0.0)
        return {g: d for g, d in groups.items() if d}

    def quantile_over_time(self, name: str, q: float,
                           labels: Optional[dict] = None,
                           window_s: Optional[float] = None,
                           now: Optional[float] = None) -> Optional[float]:
        """``histogram_quantile(q, increase(name_bucket[window]))`` for
        ONE label group (ambiguity raises; None when the window holds
        no new observations)."""
        groups = self.bucket_deltas(name, labels, window_s, now)
        if not groups:
            return None
        if len(groups) > 1:
            raise ValueError(
                f"quantile_over_time({name}) matches {len(groups)} "
                "label groups — add labels to disambiguate"
            )
        (deltas,) = groups.values()
        return bucket_quantile(deltas, q)

    # -- persistence ------------------------------------------------------

    def dump(self) -> dict:
        """JSON-safe snapshot of every series (perf_diff input)."""
        with self._lock:
            series = [
                {
                    "name": name,
                    "labels": dict(lk),
                    "points": [[round(t, 6), v] for t, v in ring],
                }
                for (name, lk), ring in sorted(self._data.items())
            ]
        return {
            "version": 1,
            "capacity": self.capacity,
            "kinds": dict(self._kinds),
            "series": series,
        }

    def save(self, path: str) -> str:
        payload = self.dump()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fp:
            json.dump(payload, fp, default=str)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, payload: dict) -> "TimeSeriesStore":
        store = cls(capacity=int(payload.get("capacity",
                                             DEFAULT_CAPACITY)))
        store._kinds.update(payload.get("kinds", {}))
        for s in payload.get("series", []):
            for t, v in s.get("points", []):
                store.append(s["name"], v, s.get("labels") or {}, t)
        return store

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._last_sweep.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def total_points(self) -> int:
        with self._lock:
            return sum(len(r) for r in self._data.values())


def bucket_quantile(deltas: Dict[float, float], q: float) -> Optional[float]:
    """``histogram_quantile`` over one cumulative ``{le: count}`` vector:
    linear interpolation inside the winning bucket, the highest finite
    bound when the quantile lands in ``+Inf``."""
    if not deltas:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    les = sorted(deltas)
    total = deltas[les[-1]] if math.isinf(les[-1]) else max(
        deltas[le] for le in les
    )
    if total <= 0:
        return None
    target = q * total
    prev_le, prev_cum = 0.0, 0.0
    for le in les:
        cum = deltas[le]
        if cum >= target:
            if math.isinf(le):
                finite = [x for x in les if not math.isinf(x)]
                return finite[-1] if finite else None
            in_bucket = cum - prev_cum
            if in_bucket <= 0:
                return le
            frac = (target - prev_cum) / in_bucket
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = (0.0 if math.isinf(le) else le), cum
    finite = [x for x in les if not math.isinf(x)]
    return finite[-1] if finite else None


# -- flight-recorder context ---------------------------------------------


def watch_context(store: TimeSeriesStore,
                  series: Sequence[str] = DEFAULT_FLIGHT_SERIES,
                  n: int = 32) -> dict:
    """The last-``n`` points of every series matching the allowlist
    (prefix match, so ``serving_slo_burn_rate`` covers its labeled
    children) — what the flight recorder's ``watchtower`` context
    provider attaches to every dump."""
    out: dict = {}
    for prefix in series:
        for name in store.names():
            if not name.startswith(prefix):
                continue
            for labels, points in store.select(name):
                out[render_series_key(name, labels)] = [
                    [round(t, 3), v] for t, v in points[-n:]
                ]
    return out


def install_flight_context(store: Optional[TimeSeriesStore] = None,
                           series: Sequence[str] = DEFAULT_FLIGHT_SERIES,
                           n: int = 32, recorder=None) -> None:
    """Register the ``watchtower`` flight-recorder context provider:
    every future flight dump carries the trend into the failure."""
    from ml_trainer_tpu_torch.telemetry.flight import get_recorder

    rec = recorder if recorder is not None else get_recorder()
    rec.register_context_provider(
        "watchtower",
        lambda: watch_context(
            store if store is not None else default_store(), series, n
        ),
    )


# -- dashboard ------------------------------------------------------------

_DASH_CSS = """
body{background:#101418;color:#d8dee4;font:13px/1.45 system-ui,sans-serif;
     margin:0;padding:18px}
h1{font-size:16px;margin:0 0 2px}
.meta{color:#7d8590;margin:0 0 14px}
.tiles{display:flex;flex-wrap:wrap;gap:10px}
.tile{background:#161b22;border:1px solid #2d333b;border-radius:6px;
      padding:8px 10px;min-width:180px}
.tile .name{color:#7d8590;font-size:11px;overflow-wrap:anywhere}
.tile .value{font-size:18px;font-weight:600;margin:2px 0}
.spark{display:block}
.spark polyline{fill:none;stroke:#58a6ff;stroke-width:1.5}
.alerts{margin-top:18px}
table{border-collapse:collapse;margin-top:6px}
td,th{border:1px solid #2d333b;padding:3px 8px;text-align:left}
.sev-page{color:#ff7b72}.sev-warn{color:#d29922}
.state-firing{color:#ff7b72;font-weight:600}
.state-resolved{color:#3fb950}
""".strip()


def _fmt_stat(v: float) -> str:
    if v != v:
        return "NaN"
    if abs(v) >= 1e6 or (0 < abs(v) < 1e-3):
        return f"{v:.3g}"
    if v == int(v):
        return str(int(v))
    return f"{v:.4g}"


def _sparkline(points: list, width: int = 160, height: int = 36) -> str:
    """One series as an inline SVG polyline (self-contained HTML)."""
    if len(points) < 2:
        return (
            f'<svg class="spark" width="{width}" height="{height}"></svg>'
        )
    ts = [t for t, _ in points]
    vs = [v for _, v in points]
    t0, t1 = ts[0], ts[-1]
    lo, hi = min(vs), max(vs)
    tspan = (t1 - t0) or 1.0
    vspan = (hi - lo) or 1.0
    coords = " ".join(
        f"{(t - t0) / tspan * (width - 4) + 2:.1f},"
        f"{height - 2 - (v - lo) / vspan * (height - 4):.1f}"
        for t, v in points
    )
    return (
        f'<svg class="spark" width="{width}" height="{height}" '
        f'viewBox="0 0 {width} {height}">'
        f'<polyline points="{coords}"/></svg>'
    )


def render_dashboard(store: TimeSeriesStore, title: str = "watchtower",
                     alerts: Optional[Sequence[dict]] = None,
                     max_points: int = 120,
                     max_series: int = 400) -> str:
    """The whole store as ONE self-contained HTML page: a stat tile
    (latest value + sparkline) per series, bucket series folded away,
    plus the alert history table when ``alerts`` is given.  Stdlib
    only — no external assets, safe to drop into an incident bundle."""
    import html as _html

    tiles = []
    n_series = 0
    for name in store.names():
        if name.endswith("_bucket"):
            continue
        for labels, points in store.select(name):
            if n_series >= max_series:
                break
            n_series += 1
            key = render_series_key(name, labels)
            points = points[-max_points:]
            value = points[-1][1] if points else float("nan")
            tiles.append(
                f'<div class="tile" data-series="{_html.escape(key)}">'
                f'<div class="name">{_html.escape(key)}</div>'
                f'<div class="value">{_fmt_stat(value)}</div>'
                f"{_sparkline(points)}</div>"
            )
    alert_html = ""
    if alerts:
        rows = []
        for a in alerts:
            value = a.get("value")
            value_cell = _fmt_stat(float(value)) if value is not None else ""
            label_cell = _html.escape(",".join(
                f"{k}={v}" for k, v in sorted((a.get("labels")
                                               or {}).items())
            ))
            rows.append(
                "<tr>"
                f'<td>{_html.escape(str(a.get("rule", "")))}</td>'
                f'<td class="sev-{_html.escape(str(a.get("severity")))}">'
                f'{_html.escape(str(a.get("severity", "")))}</td>'
                f'<td class="state-{_html.escape(str(a.get("state")))}">'
                f'{_html.escape(str(a.get("state", "")))}</td>'
                f"<td>{value_cell}</td>"
                f"<td>{label_cell}</td>"
                f'<td>{round(float(a.get("t", 0.0)), 3)}</td>'
                "</tr>"
            )
        alert_html = (
            '<section class="alerts"><h1>alerts</h1><table>'
            "<tr><th>rule</th><th>severity</th><th>state</th>"
            "<th>value</th><th>labels</th><th>t</th></tr>"
            + "".join(rows) + "</table></section>"
        )
    rendered_at = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    return (
        "<!doctype html><html><head><meta charset=\"utf-8\">"
        f"<title>{_html.escape(title)}</title>"
        f"<style>{_DASH_CSS}</style></head><body>"
        f"<h1>watchtower &middot; {_html.escape(title)}</h1>"
        f'<p class="meta">{n_series} series &middot; '
        f"{store.total_points()} points &middot; {rendered_at}</p>"
        f'<section class="tiles">{"".join(tiles)}</section>'
        f"{alert_html}</body></html>"
    )


def save_dashboard(store: TimeSeriesStore, path: str,
                   title: str = "watchtower",
                   alerts: Optional[Sequence[dict]] = None) -> str:
    """Atomic HTML snapshot — what incident bundles and run_report
    embed."""
    html = render_dashboard(store, title=title, alerts=alerts)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fp:
        fp.write(html)
    os.replace(tmp, path)
    return path


# -- process-wide default store -------------------------------------------
_default: Optional[TimeSeriesStore] = None
_default_lock = threading.Lock()


def default_store() -> TimeSeriesStore:
    """The process-wide store the trainer's log-sync and the flight
    context provider share (servers and routers hold their own)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = TimeSeriesStore()
        return _default


def reset_default_store() -> None:
    """Tests only: drop the process-wide store."""
    global _default
    with _default_lock:
        _default = None

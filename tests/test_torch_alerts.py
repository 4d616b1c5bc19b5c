"""The port's Watchtower store, alert engine, exposition parser and
flight recorder (``ml_trainer_tpu_torch/telemetry/``) against the JAX
package's.

The same registry observations and the same points on a fake clock give
both packages' ``TimeSeriesStore`` the same dump and the same
``rate``/``delta``/``avg``/``min``/``max``/``quantile_over_time``
answers; one rule set (threshold, label-filtered, rate, windowed avg,
histogram quantile, absent, per-label groups, ``for_s``,
``for_count``, event mode, ``on_no_data``) evaluated over them gives
the same alert history, instruments and flight records.  A dump of one
package loads in the other; ``parse_exposition``, ``relabel_exposition``
and ``federate_exposition`` return what the JAX package's do; a flight
dump has the JAX keys; the dashboard is the JAX page.  Host arithmetic:
compared exactly.
"""

import importlib
import json
import re
import types

import pytest

PKGS = ("ml_trainer_tpu_torch", "ml_trainer_tpu")


def _mods(pkg):
    return types.SimpleNamespace(**{
        name: importlib.import_module(f"{pkg}.telemetry.{name}")
        for name in ("alerts", "export", "federation", "flight", "registry",
                     "watchtower")})


def _registry(m):
    """One registry with a counter, a labelled gauge and a histogram,
    observed the same way in both packages."""
    reg = m.registry.MetricsRegistry()
    c = reg.counter("serving_requests_completed", "done requests")
    g = reg.gauge("serving_kv_pages_free", "free pages",
                  labelnames=("replica",))
    h = reg.histogram("serving_ttft_seconds", "ttft",
                      buckets=(0.05, 0.1, 0.25, 0.5, 1.0))
    return reg, c, g, h


def _fill(m):
    """A store sampled from the registry at t = 0..19 plus hand points."""
    store = m.watchtower.TimeSeriesStore(capacity=16)
    reg, c, g, h = _registry(m)
    for i in range(20):
        c.inc(3 if i != 12 else 0)
        g.labels(replica="d0").set(100 - 7 * i)
        g.labels(replica="d1").set(40 + (i % 5))
        for v in (0.02 * (i % 7), 0.3 + 0.01 * i, 0.9 if i % 4 == 0
                  else 0.07):
            h.observe(v)
        store.sample_registry(reg, t=float(i), force=True)
        store.append("train_step_ms_p99", 400.0 + 11.0 * (i % 9),
                     t=float(i))
        store.append("resets_total", (i % 6) * 2.0, t=float(i))
    return store, reg


def _queries(store):
    out = {}
    for w in (None, 4.0, 9.5):
        for fn in ("rate", "delta", "avg"):
            out[f"{fn}/res/{w}"] = getattr(store, fn)(
                "resets_total", window_s=w)
            out[f"{fn}/done/{w}"] = getattr(store, fn)(
                "serving_requests_completed", window_s=w)
            out[f"{fn}/d0/{w}"] = getattr(store, fn)(
                "serving_kv_pages_free", {"replica": "d0"}, window_s=w)
        for fn in (min, max):
            out[f"{fn.__name__}/{w}"] = store.minmax(
                "train_step_ms_p99", fn, window_s=w)
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            out[f"q{q}/{w}"] = store.quantile_over_time(
                "serving_ttft_seconds", q, window_s=w, now=19.0)
    out["last"] = store.last("train_step_ms_p99", n=3)
    out["absent"] = [store.absent("nope"), store.absent(
        "resets_total", within_s=2.0, now=30.0), store.absent(
        "resets_total", within_s=2.0, now=20.0)]
    out["names"] = store.names()
    out["kind"] = store.kind("serving_ttft_seconds")
    out["len"] = (len(store), store.total_points())
    return out


def test_store_sampling_and_window_arithmetic_equal_jax():
    got, want = (_fill(_mods(p))[0] for p in PKGS)
    assert got.dump() == want.dump()
    assert _queries(got) == _queries(want)
    q = _queries(got)
    assert q["rate/res/None"] is not None and q["q0.5/4.0"] is not None
    with pytest.raises(ValueError, match="disambiguate"):
        got.last_value("serving_kv_pages_free")
    with pytest.raises(ValueError, match="capacity"):
        type(got)(capacity=1)


def test_dump_load_across_the_packages(tmp_path):
    port, jax_side = (_mods(p) for p in PKGS)
    store, _ = _fill(port)
    j_store, _ = _fill(jax_side)
    path = store.save(str(tmp_path / "tsdb.json"))
    loaded = jax_side.watchtower.TimeSeriesStore.load(
        json.loads(open(path).read()))
    assert loaded.dump() == store.dump()
    back = port.watchtower.TimeSeriesStore.load(j_store.dump())
    assert back.dump() == j_store.dump()
    assert _queries(back) == _queries(loaded)


RULES = [
    dict(name="pages_low", expr="serving_kv_pages_free < 20", for_count=2),
    dict(name="d1_high", expr="serving_kv_pages_free{replica=d1} >= 43"),
    dict(name="done_rate", expr="rate(serving_requests_completed[5s]) < 3",
         severity="page"),
    dict(name="burn_avg", expr="avg(train_step_ms_p99[6s]) > 432",
         for_s=2.0),
    dict(name="p99_max", expr="max(train_step_ms_p99[3s]) >= 470",
         mode="event"),
    dict(name="ttft_p50", expr="quantile(0.5, serving_ttft_seconds[4s]) "
                               "> 0.1", severity="info"),
    dict(name="gone", expr="absent(heartbeat[3s])"),
    dict(name="res_delta", expr="delta(resets_total[3s]) < 0",
         on_no_data="skip"),
    dict(name="min_pages", expr="min(serving_kv_pages_free[2s]) != 41"),
]


def _alerts(pkg, with_flight):
    m = _mods(pkg)
    store = m.watchtower.TimeSeriesStore(capacity=64)
    reg, c, g, h = _registry(m)
    events_seen = []
    rec = m.flight.FlightRecorder(capacity=512)
    rules = [m.alerts.AlertRule(**spec, actions=[events_seen.append])
             for spec in RULES]
    inst = m.registry.MetricsRegistry()
    eng = m.alerts.AlertEngine(rules, store=store, registry=inst,
                               flight=rec if with_flight else None,
                               clock=lambda: 0.0)
    out = []
    for i in range(24):
        c.inc(4 if i < 10 else 1)
        g.labels(replica="d0").set(max(100 - 9 * i, 0))
        g.labels(replica="d1").set(40 + (i % 5))
        h.observe(0.04 if i < 8 else 0.4)
        store.sample_registry(reg, t=float(i), force=True)
        store.append("train_step_ms_p99", 400.0 + 13.0 * (i % 7),
                     t=float(i))
        if i < 6 or i > 15:
            store.append("heartbeat", 1.0, t=float(i))
        store.append("resets_total", float(i % 5), t=float(i))
        out.append(eng.evaluate(now=float(i)))
    eng.observe("pages_low", True, now=30.0, value=1.0, extra={"x": 1})
    summaries = [r.summary() for r in eng.rules.values()]
    return dict(ticks=out, history=eng.history(), active=eng.active(),
                payload=eng.payload(), summaries=summaries,
                actions=events_seen, instruments=inst.snapshot(),
                flight=[{k: v for k, v in r.items() if k != "t"}
                        for r in rec.records()],
                counts=[r.count() for r in eng.rules.values()])


def test_alert_histories_equal_jax():
    got = _alerts(PKGS[0], True)
    want = _alerts(PKGS[1], True)
    for key in want:
        assert got[key] == want[key], key
    states = {(e["rule"], e["state"]) for e in got["history"]}
    assert {("pages_low", "firing"), ("p99_max", "event"),
            ("gone", "firing"), ("gone", "resolved")} <= states
    assert {e["rule"] for e in got["history"]} >= {
        "pages_low", "done_rate", "burn_avg", "p99_max", "ttft_p50",
        "gone"}
    assert any(k.startswith("alerts_fired_total") for k in
               got["instruments"])
    assert [r["kind"] for r in got["flight"]] == ["alert"] * len(
        got["history"])


def test_default_fleet_rules_and_guards_equal_jax():
    port, jax_side = (_mods(p) for p in PKGS)
    got = [r.summary() for r in port.alerts.default_fleet_rules()]
    assert got == [r.summary() for r in jax_side.alerts.default_fleet_rules()]
    for kw, match in ((dict(severity="loud"), "severity"),
                      (dict(mode="edge"), "mode"),
                      (dict(on_no_data="hold"), "on_no_data"),
                      (dict(for_count=0), "for_count")):
        with pytest.raises(ValueError, match=match):
            port.alerts.AlertRule("r", **kw)
    with pytest.raises(ValueError, match="unparseable"):
        port.alerts.AlertRule("r", "rate(x) maybe 3")


def test_exposition_parser_equals_jax():
    port, jax_side = (_mods(p) for p in PKGS)
    _, reg = _fill(port)
    text = port.export.prometheus_text(reg)
    text += 'bare_metric{a="x\\"y"} 2\nbare_metric_count 3\n# junk\n\n'
    assert (port.federation.parse_exposition(text)
            == jax_side.federation.parse_exposition(text))
    labels = {"replica": "d\"0", "role": "decode", "generation": "1"}
    assert (port.federation.relabel_exposition(text, labels)
            == jax_side.federation.relabel_exposition(text, labels))
    sections = [(text, labels), (text, {"replica": "p0"})]
    assert (port.federation.federate_exposition(text, sections)
            == jax_side.federation.federate_exposition(text, sections))
    stores = [m.watchtower.TimeSeriesStore() for m in (port, jax_side)]
    for s in stores:
        assert s.ingest_exposition(text, t=1.0, extra_labels=labels) > 0
    assert stores[0].dump() == stores[1].dump()


def test_flight_dump_keys_equal_jax(tmp_path, monkeypatch):
    dumps = []
    for i, pkg in enumerate(PKGS):
        m = _mods(pkg)
        monkeypatch.setenv(m.flight.FLIGHT_DIR_ENV, str(tmp_path / str(i)))
        rec = m.flight.FlightRecorder(capacity=3)
        store, _ = _fill(m)
        m.watchtower.install_flight_context(store, recorder=rec, n=2)
        rec.register_context_provider("broken", lambda: 1 / 0)
        for k in range(5):
            rec.record("deploy", action="stage", k=k)
        path = rec.dump("drill", extra_key=1)
        assert path and path.startswith(str(tmp_path / str(i)))
        with open(path) as fp:
            dumps.append(json.load(fp))
    got, want = dumps
    assert sorted(got) == sorted(want)
    strip = [[{k: v for k, v in r.items() if k != "t"} for r in d["records"]]
             for d in dumps]
    assert strip[0] == strip[1] and len(strip[0]) == 3
    assert got["context"] == want["context"]
    assert "watchtower" in got["context"]
    assert got["context"]["broken"].startswith("context provider failed")
    assert (got["reason"], got["extra_key"]) == ("drill", 1)


def test_dashboard_equals_jax():
    port, jax_side = (_mods(p) for p in PKGS)
    history = _alerts(PKGS[0], False)["history"]
    pages = []
    for m in (port, jax_side):
        store, _ = _fill(m)
        html = m.watchtower.render_dashboard(store, title="<fleet>",
                                             alerts=history)
        pages.append(re.sub(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ", "T", html))
    assert pages[0] == pages[1]
    assert "&lt;fleet&gt;" in pages[0] and "<polyline" in pages[0]

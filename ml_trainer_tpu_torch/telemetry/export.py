"""Prometheus text exposition of a metrics registry (the JAX package's
``telemetry/export.py`` ``prometheus_text``).

The format is the text format version 0.0.4, the shape ``promtool check
metrics`` accepts: ``# HELP`` / ``# TYPE`` headers, ``name{label="value"}
number`` samples, histograms as cumulative ``_bucket{le=...}`` series
plus ``_sum`` / ``_count``.
"""

from __future__ import annotations

import math


def _fmt_value(v: float) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _labels_text(labelnames, key, extra=()) -> str:
    pairs = [
        f'{ln}="{_escape_label(str(lv))}"'
        for ln, lv in zip(labelnames, key)
    ]
    pairs.extend(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def prometheus_text(registry) -> str:
    """The whole registry in Prometheus text exposition format 0.0.4."""
    lines = []
    for m in registry.collect():
        if m.help:
            lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for key, _ in sorted(m.series().items()):
            if m.kind == "histogram":
                h = m._get(key)
                cum = 0
                for ub, c in zip(m.buckets, h["buckets"]):
                    cum += c
                    le = _labels_text(
                        m.labelnames, key, (f'le="{_fmt_value(ub)}"',)
                    )
                    lines.append(f"{m.name}_bucket{le} {cum}")
                le = _labels_text(m.labelnames, key, ('le="+Inf"',))
                lines.append(f"{m.name}_bucket{le} {h['count']}")
                lt = _labels_text(m.labelnames, key)
                lines.append(f"{m.name}_sum{lt} {_fmt_value(h['sum'])}")
                lines.append(f"{m.name}_count{lt} {h['count']}")
            else:
                lt = _labels_text(m.labelnames, key)
                lines.append(f"{m.name}{lt} {_fmt_value(m._get(key))}")
    return "\n".join(lines) + "\n"

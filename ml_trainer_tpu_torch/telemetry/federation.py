"""Metrics federation, the exposition half (the JAX package's
``telemetry/federation.py``): the Prometheus text parser and the
relabeling a fleet's scrape applies.

* :func:`inject_labels` / :func:`relabel_exposition`: a worker's
  exposition with ``replica=``/``role=``/``generation=`` labels added to
  every sample line;
* :func:`parse_exposition`: exposition text as metric-family groups
  (what ``watchtower.TimeSeriesStore.ingest_exposition`` reads);
* :func:`federate_exposition`: the router's own text plus N relabeled
  worker sections as one valid document.

The trace-merging half (clock shifts, the fleet trace) is not ported
(ROADMAP.md Queue A 7).  Host-only module: no sockets; callers feed it
text they already fetched.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Labels the federation layer owns.  A worker series that already
# carries one of these (it should never) keeps its own value — injecting
# a duplicate label name would make the exposition invalid.
FEDERATION_LABELS = ("replica", "role", "generation")

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{.*\})?"
    r"(?P<rest>\s.+)$"
)

# Histogram/summary child-sample suffixes: `x_bucket`/`x_sum`/`x_count`
# belong to family `x` — grouping must keep them with their TYPE header.
_FAMILY_SUFFIXES = ("_bucket", "_sum", "_count")


def _escape(v) -> str:
    s = str(v)
    return s.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def inject_labels(line: str, extra: Dict[str, object]) -> str:
    """One exposition sample line with ``extra`` labels appended.

    Comment/blank lines pass through untouched.  Existing labels win on
    a name collision (the injected pair is dropped, not duplicated)."""
    if not line or line.startswith("#"):
        return line
    m = _SAMPLE_RE.match(line)
    if m is None:
        return line
    existing = m.group("labels") or ""
    pairs = [
        f'{k}="{_escape(v)}"'
        for k, v in extra.items()
        if f'{k}="' not in existing
    ]
    if not pairs:
        return line
    if existing:
        inner = existing[1:-1]
        merged = "{" + (inner + "," if inner else "") + ",".join(pairs) + "}"
    else:
        merged = "{" + ",".join(pairs) + "}"
    return f"{m.group('name')}{merged}{m.group('rest')}"


def relabel_exposition(text: str, extra: Dict[str, object]) -> str:
    """A whole Prometheus text exposition with ``extra`` labels injected
    into every sample line (``# HELP``/``# TYPE`` untouched)."""
    return "\n".join(
        inject_labels(line, extra) for line in text.splitlines()
    ) + ("\n" if text.endswith("\n") else "")


def parse_exposition(text: str) -> List[dict]:
    """Exposition text as metric-family groups, document order:
    ``[{"name", "help", "type", "samples": [line, ...]}, ...]``.

    Grouping follows the comment headers: sample lines after a
    ``# TYPE x ...`` belong to family ``x`` until the next header; a
    bare sample with no header becomes its own untyped family (help and
    type ``None``), with histogram child suffixes folded into the base
    name so ``x_bucket``/``x_sum``/``x_count`` stay together."""
    families: List[dict] = []
    by_name: Dict[str, dict] = {}
    current: Optional[dict] = None

    def _family(name: str, help_text=None, kind=None) -> dict:
        fam = by_name.get(name)
        if fam is None:
            fam = {"name": name, "help": help_text, "type": kind,
                   "samples": []}
            by_name[name] = fam
            families.append(fam)
        else:
            if help_text is not None and fam["help"] is None:
                fam["help"] = help_text
            if kind is not None and fam["type"] is None:
                fam["type"] = kind
        return fam

    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            current = _family(
                parts[0], help_text=parts[1] if len(parts) > 1 else ""
            )
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split(" ", 1)
            current = _family(
                parts[0], kind=parts[1].strip() if len(parts) > 1 else None
            )
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name = m.group("name")
        base = name
        for suf in _FAMILY_SUFFIXES:
            if name.endswith(suf):
                base = name[: -len(suf)]
                break
        if current is not None and (
            name == current["name"] or base == current["name"]
        ):
            current["samples"].append(line)
        else:
            _family(base if base in by_name else name)["samples"].append(
                line
            )
            current = by_name.get(base, by_name.get(name))
    return families


def federate_exposition(
    base_text: str,
    sections: Sequence[Tuple[str, Dict[str, object]]],
) -> str:
    """ONE valid exposition document from the router's own text plus N
    scraped worker snapshots.

    ``sections`` is ``[(worker_exposition_text, extra_labels), ...]`` —
    each worker's text is relabeled (:func:`relabel_exposition`) and
    merged family-by-family with ``base_text``: one ``# HELP``/``# TYPE``
    header per metric name (first writer wins), every family's samples
    grouped regardless of which process reported them.  Rendering always
    starts from the LATEST snapshots, so calling this twice with the
    same inputs returns the same bytes — the idempotent-re-scrape
    property the federation tests pin."""
    merged: List[dict] = []
    by_name: Dict[str, dict] = {}
    for text in [base_text] + [
        relabel_exposition(text, extra) for text, extra in sections
    ]:
        for fam in parse_exposition(text):
            have = by_name.get(fam["name"])
            if have is None:
                fam = dict(fam, samples=list(fam["samples"]))
                by_name[fam["name"]] = fam
                merged.append(fam)
            else:
                if have["help"] is None:
                    have["help"] = fam["help"]
                if have["type"] is None:
                    have["type"] = fam["type"]
                have["samples"].extend(fam["samples"])
    lines: List[str] = []
    for fam in merged:
        if fam["help"]:
            lines.append(f"# HELP {fam['name']} {fam['help']}")
        if fam["type"]:
            lines.append(f"# TYPE {fam['name']} {fam['type']}")
        lines.extend(fam["samples"])
    return "\n".join(lines) + "\n"

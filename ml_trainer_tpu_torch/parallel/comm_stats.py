"""Collective accounting (the JAX package's ``parallel/comm_stats.py``):
the analytic bytes each collective call moves per participant, by op and
by bucket.

The JAX wrappers account once per traced program; the port runs
eagerly, so every call accounts when it runs, and a total covers the
calls made since the last ``reset_comm_stats()``.  The formulas, with
``n`` the axis size and ``size`` the bytes of one participant's input:

=================  ==========================  =========================
op                 bytes per participant       rationale
=================  ==========================  =========================
psum / pmean       ``2 * size * (n-1)/n``      ring all-reduce
all_gather         ``size * (n-1)``            receives every other shard
reduce_scatter     ``size * (n-1)/n``          ring reduce-scatter
=================  ==========================  =========================

These are the bytes a ring over ``n`` devices would move.  A process of
a multi-process run (one replica each) accounts them for its replica;
replicas that share one device move none over a link, but each call's
accounting is the same, so the two can be read against each other.  The registry gauges of the
JAX package wait for the telemetry port (ROADMAP.md Queue A 7).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

_lock = threading.Lock()
_bytes: Dict[str, float] = {}
_calls: Dict[str, int] = {}
_bucket_bytes: Dict[Tuple[str, str], float] = {}

_FACTORS = {
    "psum": lambda size, n: 2.0 * size * (n - 1) / n,
    "pmean": lambda size, n: 2.0 * size * (n - 1) / n,
    "all_gather": lambda size, n: float(size) * (n - 1),
    "reduce_scatter": lambda size, n: float(size) * (n - 1) / n,
}


def _nbytes(x: Union[torch.Tensor, Sequence[torch.Tensor]]) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return sum(_nbytes(t) for t in x)


def account(op: str, x, n: int, bucket: Optional[str] = None) -> None:
    """Record one ``op`` call over ``n`` participants whose input (one
    participant's) is ``x``, a tensor or a list of tensors; ``bucket``
    labels it in the per-bucket breakdown too."""
    if op not in _FACTORS:
        raise ValueError(f"unknown collective op {op!r}")
    n_bytes = _FACTORS[op](float(_nbytes(x)), int(n)) if n > 1 else 0.0
    with _lock:
        _bytes[op] = _bytes.get(op, 0.0) + n_bytes
        _calls[op] = _calls.get(op, 0) + 1
        if bucket is not None:
            key = (op, str(bucket))
            _bucket_bytes[key] = _bucket_bytes.get(key, 0.0) + n_bytes


def comm_bytes() -> Dict[str, float]:
    """Per-op analytic bytes since the last reset (a copy)."""
    with _lock:
        return dict(_bytes)


def comm_calls() -> Dict[str, int]:
    with _lock:
        return dict(_calls)


def comm_bucket_bytes() -> Dict[str, Dict[str, float]]:
    """Per-bucket analytic bytes grouped by op: ``{op: {bucket: bytes}}``."""
    with _lock:
        out: Dict[str, Dict[str, float]] = {}
        for (op, bucket), b in _bucket_bytes.items():
            out.setdefault(op, {})[bucket] = b
        return out


def tallies() -> tuple:
    """The live per-op bytes, per-op calls and per-bucket bytes, for a
    CUDA graph's capture to take back and its replays to add again
    (``device.CountedGraph``)."""
    return _bytes, _calls, _bucket_bytes


def reset_comm_stats() -> None:
    with _lock:
        _bytes.clear()
        _calls.clear()
        _bucket_bytes.clear()

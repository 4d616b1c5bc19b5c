"""Replica-desync detection (the JAX package's ``parallel/desync.py``).

A data-parallel run keeps one copy of the parameters per process, and
every process must step them identically.  ``param_fingerprint``
reduces a tree of arrays to one scalar with the JAX package's formula;
``check_desync`` broadcasts process 0's scalar and raises
``RuntimeError`` on every process whose own differs, naming it and the
step.  The Trainer calls it at each epoch's end of a multi-process run
and every ``desync_every_steps`` steps.

The JAX package also publishes each host's fingerprint in its metrics
registry and records a flight-recorder event before raising; those
forensics wait for the telemetry port (ROADMAP.md Queue A 7).
"""

from __future__ import annotations

from typing import Collection, Optional

import numpy as np
import torch

from ml_trainer_tpu_torch.parallel import distributed


def _leaves(tree, path=()):
    """(path, leaf) pairs in ``jax.tree.leaves`` order: dict keys sorted,
    sequences in order; None and empty containers hold no leaf."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype not in (torch.float32, torch.float64):
            leaf = leaf.float()
        leaf = leaf.cpu().numpy()
    return np.asarray(leaf, dtype=np.float32)


def param_fingerprint(tree, sharded: Collection[str] = ()) -> float:
    """Order-stable scalar digest of a tree of arrays (tensors or numpy;
    nested dicts, lists, tuples): ``sum_i (i + 1) * sum(x_i**2) +
    sum(x_i)`` over the leaves in ``jax.tree.leaves`` order, each in
    float32 on the host, as the JAX function computes it.  The leaves
    whose '/'-joined path is in ``sharded`` (split across processes by
    design) are skipped, their index kept, as the JAX function skips a
    partitioned leaf."""
    acc = 0.0
    for i, (path, leaf) in enumerate(_leaves(tree)):
        if "/".join(path) in sharded:
            continue
        x = _host(leaf)
        acc += (i + 1) * float(np.sum(x * x)) + float(np.sum(x))
    return acc


def check_desync(tree, atol: float = 1e-4, *, step: Optional[int] = None,
                 sharded: Collection[str] = ()) -> None:
    """Raise ``RuntimeError`` on a process whose fingerprint of ``tree``
    differs from process 0's by more than ``atol * max(1, |host 0|)``.
    Collective: every process calls it at the same point.  A no-op with
    one process."""
    if distributed.process_count() == 1:
        return
    mine = param_fingerprint(tree, sharded)
    box = torch.tensor(mine, dtype=torch.float64,
                       device=distributed.comm_device())
    torch.distributed.broadcast(box, src=0)
    host0 = float(box)
    if abs(mine - host0) > atol * max(1.0, abs(host0)):
        pid = distributed.process_index()
        raise RuntimeError(
            f"replica desync detected: host {pid} fingerprint {mine!r} != "
            f"host 0 fingerprint {host0!r}"
            + (f" (step {step})" if step is not None else ""))

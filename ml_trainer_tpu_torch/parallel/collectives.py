"""Collectives over a data mesh's replicas (the JAX package's
``parallel/collectives.py``).

Inside a JAX ``shard_map`` each replica holds its own value and a
collective names the axis.  Here the replicas' values are given
together: ``xs[j]`` is replica ``j``'s tensor, and a collective returns
the list of what each replica receives.  Every call accounts its
analytic bytes in ``comm_stats``, as the JAX wrappers do.

The replicas must share one device (``mesh.create_mesh`` allows nothing
else yet).  A sum is then taken on that device in replica order,
``((x0 + x1) + x2) + ...``, with no atomics, so runs repeat bit for bit;
the replicas receive the same result tensor, which they only read.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ml_trainer_tpu_torch.parallel.comm_stats import account
from ml_trainer_tpu_torch.parallel.mesh import Mesh


def _checked(xs: Sequence[torch.Tensor], op: str) -> List[torch.Tensor]:
    xs = list(xs)
    if not xs:
        raise ValueError(f"{op} needs one tensor per replica, got none")
    x0 = xs[0]
    for x in xs[1:]:
        if x.device != x0.device:
            raise NotImplementedError(
                f"{op} across devices {x0.device} and {x.device} needs NCCL, "
                "which is not ported yet; see ROADMAP.md Queue A")
        if x.shape != x0.shape or x.dtype != x0.dtype:
            raise ValueError(
                f"{op}: replica tensors differ: {tuple(x0.shape)} {x0.dtype} "
                f"vs {tuple(x.shape)} {x.dtype}")
    return xs


def _sum(xs: List[torch.Tensor]) -> torch.Tensor:
    if len(xs) == 1:
        return xs[0].clone()
    total = xs[0] + xs[1]
    for x in xs[2:]:
        total.add_(x)
    return total


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum across the replicas: every replica receives the sum."""
    xs = _checked(xs, "psum")
    account("psum", xs[0], len(xs))
    total = _sum(xs)
    return [total] * len(xs)


def pmean(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Mean across the replicas: the sum, divided by the replica count
    (an IEEE division by a device scalar)."""
    xs = _checked(xs, "pmean")
    account("pmean", xs[0], len(xs))
    total = _sum(xs)
    mean = torch.div(total, torch.full((), len(xs), dtype=total.dtype,
                                       device=total.device))
    return [mean] * len(xs)


def reduce_scatter(xs: Sequence[torch.Tensor], *, scatter_axis: int = 0,
                   bucket: Optional[str] = None) -> List[torch.Tensor]:
    """Sum across the replicas, then replica ``j`` keeps block ``j`` of
    ``scatter_axis`` (tiled, as ``lax.psum_scatter(..., tiled=True)``).
    ``bucket`` labels the call in ``comm_stats``' per-bucket bytes."""
    xs = _checked(xs, "reduce_scatter")
    n, size = len(xs), xs[0].shape[scatter_axis]
    if size % n:
        raise ValueError(f"reduce_scatter: dim {scatter_axis} of size {size} "
                         f"does not split over {n} replicas")
    account("reduce_scatter", xs[0], n, bucket=bucket)
    return list(_sum(xs).split(size // n, dim=scatter_axis))


def all_gather(xs: Sequence[torch.Tensor], *, axis_index: int = 0,
               tiled: bool = True,
               bucket: Optional[str] = None) -> List[torch.Tensor]:
    """Every replica receives all replicas' tensors in replica order:
    concatenated along ``axis_index`` (``tiled``) or stacked along a new
    axis there."""
    xs = _checked(xs, "all_gather")
    account("all_gather", xs[0], len(xs), bucket=bucket)
    out = torch.cat(xs, dim=axis_index) if tiled else torch.stack(
        xs, dim=axis_index)
    return [out] * len(xs)


def axis_size(mesh: Mesh, axis: str = "data") -> int:
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    return mesh.shape[axis]


def axis_index(mesh: Mesh, axis: str = "data") -> List[int]:
    """Each replica's index on ``axis``, in replica order."""
    return list(range(axis_size(mesh, axis)))

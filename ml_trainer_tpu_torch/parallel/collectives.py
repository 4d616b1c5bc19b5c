"""Collectives over a data mesh's replicas (the JAX package's
``parallel/collectives.py``).

Inside a JAX ``shard_map`` each replica holds its own value and a
collective names the axis.  Here a process gives the values of its
local replicas together: ``xs[i]`` is local replica ``i``'s tensor, and a
collective returns the list of what each local replica receives.  Every
call accounts its analytic bytes in ``comm_stats``, as the JAX wrappers
do (per participant, so a process of a multi-process run accounts what
one replica of a one-process run does).

Two layouts (``mesh.Mesh``):

* one process (``mesh`` None or not ``distributed``): the replicas share
  one device, and a sum is taken there in replica order,
  ``((x0 + x1) + x2) + ...``, with no atomics, so runs repeat bit for
  bit; the replicas receive the same result tensor, which they only
  read.
* one replica per process (``mesh.distributed``): ``xs`` is this
  process's one tensor, and the collective is ``torch.distributed``'s
  over the default group: ``all_reduce``, ``reduce_scatter_tensor``,
  ``all_gather_into_tensor``.  Two processes' sums are the one-process
  sums bit for bit (a two-term sum commutes); more terms are summed in
  the backend's order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ml_trainer_tpu_torch.parallel import distributed
from ml_trainer_tpu_torch.parallel.comm_stats import account
from ml_trainer_tpu_torch.parallel.mesh import Mesh

# gloo (torch 2.11) takes CUDA tensors for each collective used here,
# all_reduce, broadcast, reduce_scatter_tensor and all_gather_into_tensor
# (probed with two processes on one H100), so no path stages a tensor
# through host memory itself.


def _checked(xs: Sequence[torch.Tensor], op: str,
             mesh: Optional[Mesh]) -> List[torch.Tensor]:
    xs = list(xs)
    if not xs:
        raise ValueError(f"{op} needs one tensor per replica, got none")
    if mesh is not None and mesh.distributed and len(xs) != 1:
        raise ValueError(f"{op}: a process of a multi-process run holds "
                         f"one replica, got {len(xs)} tensors")
    x0 = xs[0]
    for x in xs[1:]:
        if x.device != x0.device:
            raise NotImplementedError(
                f"{op} across devices {x0.device} and {x.device} in one "
                "process: launch one process per card (see ROADMAP.md "
                "Queue A)")
        if x.shape != x0.shape or x.dtype != x0.dtype:
            raise ValueError(
                f"{op}: replica tensors differ: {tuple(x0.shape)} {x0.dtype} "
                f"vs {tuple(x.shape)} {x.dtype}")
    return xs


def _group(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.distributed


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    total = x.clone()
    dist.all_reduce(total)
    return total


class _GroupSum(torch.autograd.Function):
    """The sum of each process's tensor over the process group; its
    backward sums the incoming gradients the same way (each process's
    input reaches every process's output)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous())


def group_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the process group, differentiably (the synced
    BatchNorm's statistics).  Not accounted in ``comm_stats``: the JAX
    package's global-batch statistics are no collective of its own."""
    return _GroupSum.apply(x)


def _sum(xs: List[torch.Tensor]) -> torch.Tensor:
    if len(xs) == 1:
        return xs[0].clone()
    total = xs[0] + xs[1]
    for x in xs[2:]:
        total.add_(x)
    return total


def psum(xs: Sequence[torch.Tensor],
         mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """Sum across the replicas: every replica receives the sum."""
    xs = _checked(xs, "psum", mesh)
    n = mesh.size if _group(mesh) else len(xs)
    account("psum", xs[0], n)
    total = _all_reduce(xs[0]) if _group(mesh) else _sum(xs)
    return [total] * len(xs)


def pmean(xs: Sequence[torch.Tensor],
          mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """Mean across the replicas: the sum, divided by the replica count
    (an IEEE division by a device scalar)."""
    xs = _checked(xs, "pmean", mesh)
    n = mesh.size if _group(mesh) else len(xs)
    account("pmean", xs[0], n)
    total = _all_reduce(xs[0]) if _group(mesh) else _sum(xs)
    mean = torch.div(total, torch.full((), n, dtype=total.dtype,
                                       device=total.device))
    return [mean] * len(xs)


def reduce_scatter(xs: Sequence[torch.Tensor], *, scatter_axis: int = 0,
                   bucket: Optional[str] = None,
                   mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """Sum across the replicas, then replica ``j`` keeps block ``j`` of
    ``scatter_axis`` (tiled, as ``lax.psum_scatter(..., tiled=True)``).
    ``bucket`` labels the call in ``comm_stats``' per-bucket bytes."""
    xs = _checked(xs, "reduce_scatter", mesh)
    n = mesh.size if _group(mesh) else len(xs)
    size = xs[0].shape[scatter_axis]
    if size % n:
        raise ValueError(f"reduce_scatter: dim {scatter_axis} of size {size} "
                         f"does not split over {n} replicas")
    account("reduce_scatter", xs[0], n, bucket=bucket)
    if not _group(mesh):
        return list(_sum(xs).split(size // n, dim=scatter_axis))
    x = xs[0].movedim(scatter_axis, 0).contiguous()
    block = torch.empty((size // n,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
    dist.reduce_scatter_tensor(block, x)
    return [block.movedim(0, scatter_axis)]


def all_gather(xs: Sequence[torch.Tensor], *, axis_index: int = 0,
               tiled: bool = True, bucket: Optional[str] = None,
               mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """Every replica receives all replicas' tensors in replica order:
    concatenated along ``axis_index`` (``tiled``) or stacked along a new
    axis there."""
    xs = _checked(xs, "all_gather", mesh)
    n = mesh.size if _group(mesh) else len(xs)
    account("all_gather", xs[0], n, bucket=bucket)
    if not _group(mesh):
        out = torch.cat(xs, dim=axis_index) if tiled else torch.stack(
            xs, dim=axis_index)
        return [out] * len(xs)
    x = (xs[0].movedim(axis_index, 0) if tiled else xs[0].unsqueeze(0))
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x)
    return [out.movedim(0, axis_index)]


def broadcast(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Process ``src``'s ``x`` written into ``x`` on every process (in
    place); a no-op without a process group."""
    if distributed.process_count() > 1:
        dist.broadcast(x, src)
    return x


def axis_size(mesh: Mesh, axis: str = "data") -> int:
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    return mesh.shape[axis]


def axis_index(mesh: Mesh, axis: str = "data") -> List[int]:
    """The indices on ``axis`` of this process's replicas, in order."""
    axis_size(mesh, axis)
    return list(mesh.local)

"""The sharded data-parallel update's layout (the JAX package's
``parallel/sharding.py:198-349``): which leaves are split over the data
axis, the gradient buckets, the bucketed reduce-scatter and all-gather,
and the ZeRO-1 rule for the optimizer state.

One shape rule decides all of it: a leaf whose dim 0 is > 0 and divides
by the replica count ``n`` is split into ``n`` dim-0 blocks, replica
``j`` owning block ``j``; any other leaf is replicated.  Gradient
shards, parameter shards and ZeRO-1 moment shards therefore line up
leaf for leaf.

Leaves come in the order the caller gives (``named_parameters()`` for a
model, whose order is not the JAX package's sorted-key order, so the
buckets of one model differ between the packages; the plan of one list
of shapes is the same).  Per-replica values are lists indexed by
local replica, as in ``collectives``: every replica of a one-process
run, or a process's one replica of a multi-process run (``mesh``), whose
collectives then run over the process group.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ml_trainer_tpu_torch.ops.optimizers import tree_map
from ml_trainer_tpu_torch.parallel import collectives


def zero1_sharded(shape: Sequence[int], n: int) -> bool:
    """The shard rule: dim 0 exists, is > 0 and divides by ``n``."""
    return len(shape) > 0 and shape[0] > 0 and shape[0] % n == 0


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


class GradBucketPlan(NamedTuple):
    """Static plan of the bucketed reduce-scatter backward and sharded
    update.  ``sharded[i]``: leaf ``i`` takes the reduce-scatter path (its
    dim 0 divides ``n``) or stays replicated (one psum).  ``buckets``:
    leaf indices grouped into buckets of at most ``bucket_bytes`` each, in
    REVERSE leaf order (the backward produces the last layers' gradients
    first).  ``overlap_fraction``: the share of reduce-scatter bytes whose
    collective could hide under the rest of the backward, everything but
    the last bucket."""

    n: int
    sharded: Tuple[bool, ...]
    buckets: Tuple[Tuple[int, ...], ...]
    bucket_bytes: Tuple[int, ...]
    overlap_fraction: float


def plan_grad_buckets(leaves, n: int,
                      bucket_bytes: int = 4 * 2 ** 20) -> GradBucketPlan:
    """Plan the buckets of ``leaves`` (anything with ``shape`` and
    ``dtype``, torch or numpy; a dict is taken in its values' order)."""
    if n < 1:
        raise ValueError(f"axis size must be >= 1, got {n}")
    leaves = list(leaves.values()) if isinstance(leaves, dict) else list(
        leaves)
    sharded = tuple(zero1_sharded(tuple(leaf.shape), n) for leaf in leaves)
    nbytes = [int(np.prod(tuple(leaf.shape), dtype=np.int64))
              * _itemsize(leaf.dtype) for leaf in leaves]
    buckets: List[Tuple[int, ...]] = []
    sizes: List[int] = []
    cur: List[int] = []
    cur_bytes = 0
    for i in reversed(range(len(leaves))):
        if not sharded[i]:
            continue
        if cur and cur_bytes + nbytes[i] > bucket_bytes:
            buckets.append(tuple(cur))
            sizes.append(cur_bytes)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes[i]
    if cur:
        buckets.append(tuple(cur))
        sizes.append(cur_bytes)
    total = float(sum(sizes))
    overlap = 1.0 - sizes[-1] / total if len(sizes) > 1 and total else 0.0
    return GradBucketPlan(n=int(n), sharded=sharded, buckets=tuple(buckets),
                          bucket_bytes=tuple(sizes), overlap_fraction=overlap)


def bucketed_reduce_scatter(replica_leaves: Sequence[Sequence[torch.Tensor]],
                            plan: GradBucketPlan,
                            mesh=None) -> List[List[torch.Tensor]]:
    """``replica_leaves[j][i]``: replica ``j``'s local gradient of leaf
    ``i``.  Each bucket leaves in ONE reduce-scatter: every leaf reshapes
    to ``(n, d0/n * rest)``, the bucket concatenates along dim 1 and
    scatters along dim 0, so replica ``j`` receives exactly its dim-0
    block of each leaf, summed over the replicas.  Returns the per-replica
    lists with every sharded leaf replaced by that block; replicated
    leaves pass through (the caller psums them)."""
    n = plan.n
    out = [list(leaves) for leaves in replica_leaves]
    first = replica_leaves[0]
    for bi, idxs in enumerate(plan.buckets):
        parts = [torch.cat([leaves[i].reshape(n, -1) for i in idxs], dim=1)
                 for leaves in replica_leaves]
        blocks = collectives.reduce_scatter(parts, scatter_axis=0,
                                            bucket=f"b{bi}", mesh=mesh)
        for j, block in enumerate(blocks):
            flat = block.reshape(-1)
            off = 0
            for i in idxs:
                w = first[i].numel() // n
                shape = (first[i].shape[0] // n,) + tuple(first[i].shape[1:])
                out[j][i] = flat[off:off + w].reshape(shape)
                off += w
    return out


def bucketed_all_gather(replica_leaves: Sequence[Sequence[torch.Tensor]],
                        plan: GradBucketPlan,
                        full_shapes, mesh=None) -> List[List[torch.Tensor]]:
    """Inverse of :func:`bucketed_reduce_scatter` for the fresh weights:
    each bucket of per-replica shards in ONE all-gather, every sharded
    leaf restored to its full shape (replica ``j``'s block at dim-0 block
    ``j``).  Replicated leaves pass through."""
    out = [list(leaves) for leaves in replica_leaves]
    for bi, idxs in enumerate(plan.buckets):
        parts = [torch.cat([leaves[i].reshape(-1) for i in idxs])
                 for leaves in replica_leaves]
        gathered = collectives.all_gather(parts, tiled=False,
                                          bucket=f"b{bi}",
                                          mesh=mesh)  # [n, width]
        unpacked = {}  # replicas sharing one gathered tensor share leaves
        for j, g in enumerate(gathered):
            if id(g) not in unpacked:
                leaves, off = {}, 0
                for i in idxs:
                    w = int(np.prod(full_shapes[i], dtype=np.int64)) // plan.n
                    leaves[i] = g[:, off:off + w].reshape(full_shapes[i])
                    off += w
                unpacked[id(g)] = leaves
            for i, leaf in unpacked[id(g)].items():
                out[j][i] = leaf
    return out


def zero1_opt_shardings(opt_state, n: int):
    """The ZeRO-1 placement of an optimizer state (or any tree of
    tensors) over ``n`` data replicas, decided from shapes: a tree of the
    same structure whose leaves are True where the leaf splits over the
    data axis (dim 0 divides ``n``) and False where it stays replicated
    (scalars such as Adam's count, indivisible leaves, any ``n`` of 1)."""
    return tree_map(lambda t: n > 1 and zero1_sharded(tuple(t.shape), n),
                    opt_state)


def replica_view(tree, flags, n: int, j: int):
    """Replica ``j``'s view of a global tree: its dim-0 block (a view) of
    every leaf whose flag is True, the leaf itself elsewhere."""
    def view(t, split):
        if not split:
            return t
        return t.reshape((n, t.shape[0] // n) + tuple(t.shape[1:]))[j]

    return tree_map(view, tree, flags)


def join_replica_views(trees: Sequence[Any], flags):
    """Inverse of :func:`replica_view`: the replicas' blocks concatenated
    along dim 0 where the flag is True; replica 0's leaf elsewhere (the
    replicas hold the same value there by construction)."""
    def join(split, *leaves):
        return torch.cat(leaves, dim=0) if split else leaves[0]

    return tree_map(join, flags, *trees)

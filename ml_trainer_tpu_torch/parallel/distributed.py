"""Process rendezvous (the JAX package's ``parallel/distributed.py``):
one process per data replica, over ``torch.distributed``.

``initialize_distributed`` joins the process group, from explicit
arguments (``coordinator_address`` is ``host:port`` or a ``tcp://`` URL)
or from the environment ``torchrun`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), as the JAX
one auto-detects its cluster.  It is idempotent, and a no-op for one
process with nothing explicit: the data replicas then share that
process's device (``mesh.create_mesh``).

``nccl`` is the default backend and ``gloo`` is taken only when the
caller names it; nothing falls back: a failed NCCL rendezvous raises.
Each process's device is ``cuda:<LOCAL_RANK>`` unless the caller passes
one (two ``gloo`` processes may share ``cuda:0``; NCCL refuses two
ranks on one card).  ``process_count``, ``process_index`` and
``is_primary`` read the group (1, 0 and True without one).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

# The reference's process-group names and the JAX package's: each maps
# to the torch.distributed backend it means.
PG_BACKENDS = {"nccl": "nccl", "smddp": "nccl", "cuda": "nccl",
               "tpu": "nccl", "gloo": "gloo", "cpu": "gloo"}

# The device this process's replica lives on, fixed at the rendezvous.
_DEVICE: Optional[torch.device] = None
# A gloo group beside the main one, for flags held on the host (made at
# its first use by ``any_process``).
_HOST_GROUP = None


def _env_rendezvous() -> bool:
    return all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                         "RANK", "WORLD_SIZE"))


def local_rank() -> int:
    """``LOCAL_RANK`` as ``torchrun`` sets it (0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_distributed(backend: str = "nccl",
                           coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> None:
    """Join the process group.  ``backend``: 'nccl' (the default; also
    its aliases 'smddp', 'cuda', 'tpu') or 'gloo' (also 'cpu').
    ``device``: this process's device (default ``cuda:<LOCAL_RANK>``
    for NCCL, the CPU for gloo).  A second call, or one process with no
    explicit address and no ``torchrun`` environment, does nothing."""
    global _DEVICE
    if dist.is_initialized():
        return
    try:
        pg = PG_BACKENDS[backend]
    except KeyError:
        raise ValueError(f"unknown process-group backend {backend!r}; "
                         f"expected one of {sorted(PG_BACKENDS)}") from None
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        kwargs = dict(init_method=url, world_size=int(num_processes),
                      rank=int(process_id))
    elif _env_rendezvous():
        kwargs = dict(init_method="env://")
    elif num_processes is not None and num_processes > 1:
        raise ValueError(
            f"num_processes={num_processes} needs a coordinator_address "
            "(or the environment torchrun sets)")
    else:
        return
    if device is None:
        device = (torch.device("cuda", local_rank()) if pg == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
    elif pg == "nccl":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got {device}")
    dist.init_process_group(pg, **kwargs)
    _DEVICE = device


def is_initialized() -> bool:
    return dist.is_initialized()


def group_device() -> Optional[torch.device]:
    """The device fixed at the rendezvous (None without a group)."""
    return _DEVICE if dist.is_initialized() else None


def backend() -> Optional[str]:
    """'nccl' or 'gloo', or None without a group."""
    return dist.get_backend() if dist.is_initialized() else None


def comm_device() -> torch.device:
    """Where a small host-made tensor goes for a collective: the card
    under NCCL, the CPU under gloo."""
    if backend() == "nccl":
        # A group joined outside ``initialize_distributed``: the card
        # its caller made current.
        return group_device() or torch.device(
            "cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_count() -> int:
    """World size, counted in processes (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """The process that writes history, ``model.pth`` and checkpoints."""
    return process_index() == 0


def barrier() -> None:
    """Every process reaches this point before any leaves it: one
    all-reduce of a zero, read on the host (nothing with one process)."""
    if process_count() < 2:
        return
    t = torch.zeros((), dtype=torch.int32, device=comm_device())
    dist.all_reduce(t)
    int(t)


def any_process(flag: bool) -> bool:
    """Whether ``flag`` is set on any process (``flag`` itself with one):
    one blocking all-reduce (MAX) of a host integer over the gloo group
    beside the main one, so it waits on no device work.  COLLECTIVE:
    every process calls it at the same point of its run."""
    global _HOST_GROUP
    if process_count() < 2:
        return bool(flag)
    if _HOST_GROUP is None:
        _HOST_GROUP = dist.new_group(backend="gloo")
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(t.item())


def broadcast_object(obj):
    """Rank 0's ``obj`` (any picklable value) on every process."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=comm_device())
    return box[0]


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _DEVICE, _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = _HOST_GROUP = None

"""Process rendezvous (the JAX package's ``parallel/distributed.py``).

The port runs one process: its data replicas share that process's
device (``mesh.create_mesh``), so there is nothing to join and
``initialize_distributed`` is a no-op, as the JAX one is for a single
host.  One process per card with ``torch.distributed`` and NCCL is not
ported yet (ROADMAP.md Queue A); asking for more than one process
raises.
"""

from __future__ import annotations

from typing import Optional


def initialize_distributed(backend: str = "nccl",
                           coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Single process: nothing to do.  ``backend`` is kept for the
    reference's config surface."""
    del backend, coordinator_address, process_id
    if num_processes is not None and num_processes > 1:
        raise NotImplementedError(
            f"num_processes={num_processes}: one process per card is not "
            "ported yet; see ROADMAP.md Queue A")


def process_count() -> int:
    """World size, counted in processes: always 1 here."""
    return 1


def process_index() -> int:
    return 0


def is_primary() -> bool:
    """The process that writes checkpoints and history."""
    return process_index() == 0

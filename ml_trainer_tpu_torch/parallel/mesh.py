"""Device mesh (the JAX package's ``parallel/mesh.py``): the replicas of
a data-parallel run and the devices they live on.

Only the ``data`` axis is ported.  Two layouts:

* one process (``distributed=False``): the device list is explicit and
  its length must equal the product of the shape, as in JAX; a device
  may repeat.  Repeating one device is how replicas share it: the CPU in
  the tests (the JAX tests force 8 host devices) or one card.  Distinct
  devices need one process each (``torchrun``): such a list raises.
* one replica per process (``distributed=True``, a ``torch.distributed``
  group joined by ``distributed.initialize_distributed``): replica ``j``
  is process ``j``'s device, and the data axis is the world size.  More
  than one local replica in such a run raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ml_trainer_tpu_torch.parallel import distributed

# Canonical axis order of the JAX package, outermost to innermost.
AXIS_ORDER = ("data", "fsdp", "stage", "expert", "sequence", "tensor")

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D ``data`` mesh.  ``devices[i]`` holds this process's local
    replica ``i``, which is replica ``local[i]`` of the data axis;
    ``processes`` processes hold ``size`` replicas in all."""

    devices: Tuple[torch.device, ...]
    processes: int = 1
    process_index: int = 0
    distributed: bool = False

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data",)

    @property
    def size(self) -> int:
        """Replicas on the data axis, over every process."""
        return len(self.devices) * self.processes

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size}

    @property
    def local(self) -> Tuple[int, ...]:
        """The data-axis indices of this process's replicas."""
        n = len(self.devices)
        return tuple(range(self.process_index * n,
                           (self.process_index + 1) * n))

    @property
    def device(self) -> torch.device:
        """The one device every local replica lives on."""
        return self.devices[0]


def create_mesh(shape: Optional[Dict[str, int]] = None,
                devices: Optional[Sequence[Device]] = None,
                distributed_run: bool = False) -> Mesh:
    """Build a data mesh over ``devices`` (default: the one CUDA card).
    ``shape`` defaults to ``{"data": len(devices)}``, or to the world
    size with ``distributed_run`` (one replica per process of the joined
    process group)."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else ["cuda"])]
    procs = distributed.process_count() if distributed_run else 1
    if shape is None:
        shape = {"data": len(devices) * procs}
    for axis, size in shape.items():
        if axis != "data" and size > 1:
            raise NotImplementedError(
                f"mesh axis {axis!r} (size {size}) is not ported yet; only "
                "the data axis is: see ROADMAP.md Queue A")
    n = int(shape.get("data", 1))
    if distributed_run:
        if len(devices) != 1:
            raise NotImplementedError(
                f"{len(devices)} local replicas in a run of {procs} "
                "processes: a multi-process run keeps one replica per "
                "process (several local replicas per process are not "
                "ported; see ROADMAP.md Queue A)")
        if n != procs:
            raise ValueError(
                f"mesh shape {shape} does not cover {procs} processes of "
                "one replica each")
        return Mesh(devices=tuple(devices), processes=procs,
                    process_index=distributed.process_index(),
                    distributed=True)
    if n != len(devices):
        raise ValueError(
            f"mesh shape {shape} does not cover {len(devices)} devices")
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"replicas on distinct devices {sorted(map(str, set(devices)))} "
            "in one process: launch one process per card (torchrun, "
            "is_parallel=True), or repeat one device to co-locate the "
            "replicas (see ROADMAP.md Queue A)")
    return Mesh(devices=tuple(devices))

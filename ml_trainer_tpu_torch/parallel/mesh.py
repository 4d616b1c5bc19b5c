"""Device mesh (the JAX package's ``parallel/mesh.py``): the replicas of
a data-parallel run and the devices they live on.

Only the ``data`` axis is ported.  The device list is explicit and its
length must equal the product of the shape, as in JAX; a device may
repeat.  Repeating one device is how replicas share it: the CPU in the
tests (the JAX tests force 8 host devices) or one card.  Replicas on
distinct devices need one process per card and NCCL, which is not
ported yet: such a list raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

# Canonical axis order of the JAX package, outermost to innermost.
AXIS_ORDER = ("data", "fsdp", "stage", "expert", "sequence", "tensor")

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D ``data`` mesh: ``devices[j]`` holds replica ``j``."""

    devices: Tuple[torch.device, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every replica lives on."""
        return self.devices[0]


def create_mesh(shape: Optional[Dict[str, int]] = None,
                devices: Optional[Sequence[Device]] = None) -> Mesh:
    """Build a data mesh over ``devices`` (default: the one CUDA card).
    ``shape`` defaults to ``{"data": len(devices)}``."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else ["cuda"])]
    if shape is None:
        shape = {"data": len(devices)}
    for axis, size in shape.items():
        if axis != "data" and size > 1:
            raise NotImplementedError(
                f"mesh axis {axis!r} (size {size}) is not ported yet; only "
                "the data axis is: see ROADMAP.md Queue A")
    n = int(shape.get("data", 1))
    if n != len(devices):
        raise ValueError(
            f"mesh shape {shape} does not cover {len(devices)} devices")
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"replicas on distinct devices {sorted(map(str, set(devices)))} "
            "need one process per card and NCCL, which is not ported yet; "
            "repeat one device to co-locate the replicas (see ROADMAP.md "
            "Queue A)")
    return Mesh(devices=tuple(devices))

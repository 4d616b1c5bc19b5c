"""TrainState: what a training run carries besides the model's
parameters (the JAX package's ``train_state.py``).

The parameters live in the ``nn.Module``; this holds the rest.  ``step``
is a host int that always advances (a skipped step still consumed its
batch); ``opt_state`` is the optimizer's functional state, counts
included; ``skipped_steps`` and ``bad_streak`` are int32 tensors on the
device, maintained by the non-finite guard without a host sync and read
once per epoch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    opt_state: Any
    skipped_steps: torch.Tensor
    bad_streak: torch.Tensor

    @classmethod
    def create(cls, opt_state, device) -> "TrainState":
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return cls(step=0, opt_state=opt_state, skipped_steps=zero,
                   bad_streak=zero.clone())

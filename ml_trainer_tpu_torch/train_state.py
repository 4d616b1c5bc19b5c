"""TrainState: what a training run carries besides the model's
parameters (the JAX package's ``train_state.py``).

The parameters live in the ``nn.Module``; this holds the rest.  ``step``
is a host int that always advances (a skipped step still consumed its
batch); ``opt_state`` is the optimizer's functional state, counts
included; ``skipped_steps`` and ``bad_streak`` are int32 tensors on the
device, maintained by the non-finite guard without a host sync and read
once per epoch.  With loss scaling (``precision.py``), ``loss_scale``
(float32) and ``good_steps`` (int32, the finite steps since the scale
last moved) are device scalars too; None whenever scaling is off, so an
fp32 run's state is the pre-policy one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    opt_state: Any
    skipped_steps: torch.Tensor
    bad_streak: torch.Tensor
    loss_scale: Optional[torch.Tensor] = None
    good_steps: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, opt_state, device,
               init_scale: Optional[float] = None) -> "TrainState":
        """``init_scale``: the loss scale to start from, or None for no
        scaling."""
        zero = torch.zeros((), dtype=torch.int32, device=device)
        state = cls(step=0, opt_state=opt_state, skipped_steps=zero,
                    bad_streak=zero.clone())
        if init_scale is not None:
            state.loss_scale = torch.full((), float(init_scale),
                                          dtype=torch.float32, device=device)
            state.good_steps = zero.clone()
        return state

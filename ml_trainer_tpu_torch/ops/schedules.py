"""Learning-rate schedules (the JAX package's ``ops/schedules.py``): name
-> ``lr(count)``.

Each schedule is a function of the optimizer's update count, given as an
int or an integer tensor (the count lives on the device, so the LR
follows it with no host sync), and returns a float32 tensor on the
count's device, in float32 arithmetic like the reference.
``WarmupCosine`` and ``WarmupLinear`` reproduce optax's
``warmup_cosine_decay_schedule``, ``linear_schedule`` and
``join_schedules``; ``ReduceLROnPlateau`` is a constant base whose
reduction comes from the host-side ``PlateauController`` at epoch ends.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

SCHEDULERS = (
    "CosineAnnealingWarmRestarts", "ReduceLROnPlateau", "StepLR",
    "WarmupCosine", "WarmupLinear",
)


def _f32(count) -> torch.Tensor:
    return torch.as_tensor(count).to(torch.float32)


def _const(value: float) -> Callable:
    return lambda count: torch.full((), value, dtype=torch.float32,
                                    device=torch.as_tensor(count).device)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable:
    """optax ``linear_schedule`` (polynomial of power 1)."""
    if transition_steps <= 0:
        return _const(init_value)

    def schedule(count):
        c = torch.clamp(_f32(count), 0.0, float(transition_steps))
        frac = 1.0 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable:
    """optax ``cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(
            f"cosine_decay_schedule requires positive decay_steps, got "
            f"{decay_steps}")

    def schedule(count):
        c = torch.clamp(_f32(count), max=float(decay_steps))
        cosine = 0.5 * (1.0 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def join_schedules(schedules, boundaries) -> Callable:
    """optax ``join_schedules``: schedule i+1 from boundary i on, fed the
    count relative to its boundary."""
    def schedule(count):
        count = torch.as_tensor(count)
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, sched(count - boundary))
        return out

    return schedule


def make_lr_schedule(scheduler_type: Optional[str], base_lr: float,
                     steps_per_epoch: int,
                     total_steps: Optional[int] = None) -> Callable:
    """Build lr(count); ``scheduler_type=None`` is a constant.

    ``CosineAnnealingWarmRestarts``: T_0 = 5 epochs, eta_min = 1e-7, over
    the fractional epoch count / steps_per_epoch.  ``StepLR``: x0.1 every
    2 epochs.  ``WarmupCosine`` / ``WarmupLinear`` warm up over 5% of
    ``total_steps`` (at least 1) and decay over the rest; without
    ``total_steps`` they assume 100 epochs with a 1-epoch warmup.
    """
    steps_per_epoch = max(int(steps_per_epoch), 1)
    if scheduler_type is None or scheduler_type == "ReduceLROnPlateau":
        return _const(base_lr)

    if scheduler_type in ("WarmupCosine", "WarmupLinear"):
        if total_steps is None:
            warmup = steps_per_epoch
            horizon = 100 * steps_per_epoch
        else:
            horizon = max(int(total_steps), 2)
            warmup = max(horizon // 20, 1)
        if scheduler_type == "WarmupCosine":
            return join_schedules(
                [linear_schedule(0.0, base_lr, warmup),
                 cosine_decay_schedule(base_lr, horizon - warmup)],
                [warmup])
        return join_schedules(
            [linear_schedule(0.0, base_lr, warmup),
             linear_schedule(base_lr, 0.0, max(horizon - warmup, 1))],
            [warmup])

    if scheduler_type == "CosineAnnealingWarmRestarts":
        t0_epochs, eta_min = 5.0, 1e-7

        def cosine_restarts(count):
            epoch_frac = _f32(count) / steps_per_epoch
            t_cur = torch.remainder(epoch_frac, t0_epochs) / t0_epochs
            return eta_min + (base_lr - eta_min) * 0.5 * (
                1.0 + torch.cos(math.pi * t_cur))

        return cosine_restarts

    if scheduler_type == "StepLR":
        step_size_epochs, gamma = 2, 0.1

        def step_lr(count):
            epoch = torch.div(torch.as_tensor(count), steps_per_epoch,
                              rounding_mode="floor")
            k = torch.div(epoch, step_size_epochs, rounding_mode="floor")
            return base_lr * torch.pow(
                torch.tensor(gamma, dtype=torch.float32, device=k.device),
                k.to(torch.float32))

        return step_lr

    raise ValueError(
        f"Unknown scheduler {scheduler_type!r}; expected one of {SCHEDULERS}"
    )


class PlateauController:
    """Host-side ReduceLROnPlateau (factor 0.1, patience 10, relative
    threshold 1e-4, 'min' mode, min_lr 1e-7).  ``update(val_loss)`` runs
    once per epoch and returns the ``lr_scale`` of the next epoch."""

    def __init__(self, base_lr: float, factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 min_lr: float = 1e-7):
        self.base_lr = base_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = math.inf
        self.num_bad_epochs = 0
        self.scale = 1.0

    def update(self, value: float) -> float:
        if value < self.best * (1.0 - self.threshold):
            self.best = value
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.base_lr * self.scale * self.factor, self.min_lr)
            self.scale = new_lr / self.base_lr
            self.num_bad_epochs = 0
        return self.scale

"""Resilience: deterministic fault injection (``faults.py``).  The
defenses live where the failures do: the trainer's non-finite guard,
step-granular checkpoints, rollback and preemption handling
(``trainer.py``), and the checkpoints' CRC32 check and quarantine
(``checkpoint/checkpoint.py``)."""

from ml_trainer_tpu_torch.resilience.faults import (
    ENV_VAR,
    Fault,
    FaultPlan,
    active_plan,
    injected,
    install,
    uninstall,
)

__all__ = ["ENV_VAR", "Fault", "FaultPlan", "active_plan", "injected",
           "install", "uninstall"]

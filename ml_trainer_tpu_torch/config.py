"""Trainer config (the JAX package's ``config.py``): the reference's
eleven whitelisted keys, their defaults, and the reference-parity
``TypeError`` on an unknown key.

``backend`` names where the trainer runs.  The reference's process-group
names are aliases: ``smddp``/``nccl`` (and the JAX package's ``tpu``)
mean the CUDA card, ``gloo`` and ``cpu`` the host.  A CPU backend is the
same explicit request as ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

ALLOWED_KWARGS = {
    "seed",
    "scheduler",
    "optimizer",
    "momentum",
    "weight_decay",
    "lr",
    "criterion",
    "metric",
    "pred_function",
    "model_dir",
    "backend",
}

BACKEND_ALIASES = {
    "smddp": "cuda",
    "nccl": "cuda",
    "tpu": "cuda",
    "cuda": "cuda",
    "gloo": "cpu",
    "cpu": "cpu",
}


def validate_kwargs(kwargs: Dict[str, Any], allowed_kwargs,
                    error_message: str = "Keyword argument not understood:"
                    ) -> None:
    """Raise ``TypeError(error_message, key)`` on an unknown config key."""
    for kwarg in kwargs:
        if kwarg not in allowed_kwargs:
            raise TypeError(error_message, kwarg)


@dataclasses.dataclass
class TrainerConfig:
    """Validated trainer config, the reference's keys and defaults."""

    seed: int = 32
    scheduler: Optional[str] = None
    optimizer: str = "sgd"
    momentum: float = 0.9
    weight_decay: float = 0.0
    lr: float = 0.001
    criterion: str = "cross_entropy"
    metric: Optional[str] = "accuracy"
    pred_function: Optional[str] = "softmax"
    model_dir: str = "model_output"
    backend: str = "cuda"

    @classmethod
    def from_kwargs(cls, **config: Any) -> "TrainerConfig":
        """Build from a reference-style config dict, rejecting unknown keys."""
        validate_kwargs(config, ALLOWED_KWARGS)
        out = cls(**config)
        try:
            out.backend = BACKEND_ALIASES[out.backend]
        except KeyError:
            raise ValueError(
                f"Unknown backend {out.backend!r}; expected one of "
                f"{sorted(BACKEND_ALIASES)}"
            ) from None
        return out

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

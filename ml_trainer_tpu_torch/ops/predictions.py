"""Prediction functions (the JAX package's ``ops/predictions.py``):
``softmax`` / ``logsoftmax`` / None before an argmax over the last axis."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def get_prediction_function(name: Optional[str]) -> Optional[Callable]:
    """'softmax' | 'logsoftmax' | None."""
    if name == "logsoftmax":
        return lambda x: torch.log_softmax(x, dim=-1)
    if name == "softmax":
        return lambda x: torch.softmax(x, dim=-1)
    return None


def get_predictions(outputs: torch.Tensor,
                    pred_function: Optional[Callable]) -> torch.Tensor:
    """Argmax of the (optionally transformed) outputs."""
    if pred_function is not None:
        outputs = pred_function(outputs)
    return torch.argmax(outputs, dim=-1)

"""Criteria (the JAX package's ``ops/losses.py``): name -> loss function
``(outputs, targets) -> scalar``.

Same names: ``cross_entropy`` (integer labels over any leading dims,
mean over all of them, optax's ``softmax_cross_entropy_with_integer_labels``),
``neg-loss`` (NLL over log-probabilities), ``l1``, ``l2`` and
``custom``; ``label_smoothing`` composes with ``cross_entropy`` only.
``chunked_lm_cross_entropy`` (the LM head that never materialises the
logits) is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.nn import functional as F

from ml_trainer_tpu_torch.utils.functions import custom_loss_function


def cross_entropy(outputs: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """Softmax cross entropy with integer labels, mean over every leading
    dim (``[..., C]`` logits, ``[...]`` labels)."""
    return F.cross_entropy(outputs.reshape(-1, outputs.shape[-1]),
                           targets.reshape(-1).long())


def cross_entropy_smoothed(label_smoothing: float) -> Callable:
    """Cross entropy against targets mixed with the uniform distribution
    at weight ``label_smoothing`` (optax ``smooth_labels``:
    ``(1 - a) * onehot + a / C``, which is also PyTorch's rule)."""
    if not 0.0 <= label_smoothing <= 1.0:
        raise ValueError(
            f"label_smoothing must be in [0, 1], got {label_smoothing}"
        )
    if label_smoothing == 0.0:
        return cross_entropy

    def smoothed(outputs, targets):
        return F.cross_entropy(outputs.reshape(-1, outputs.shape[-1]),
                               targets.reshape(-1).long(),
                               label_smoothing=label_smoothing)

    return smoothed


def nll_loss(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Negative log-likelihood over log-probability inputs."""
    picked = torch.gather(outputs, -1, targets.long()[..., None])
    return -torch.mean(picked)


def l1_loss(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean absolute error."""
    return torch.mean(torch.abs(outputs - targets))


def l2_loss(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean squared error."""
    return torch.mean(torch.square(outputs - targets))


def chunked_lm_cross_entropy(hidden, embedding, targets, chunk_size=128):
    """Not ported yet: the LM head that never holds the [B, S, V]
    logits (and GPT-2's ``loss_chunk``)."""
    raise NotImplementedError(
        "chunked_lm_cross_entropy (GPT-2 loss_chunk) is not ported yet; "
        "see ROADMAP.md Queue A"
    )


CRITERIA = {
    "cross_entropy": cross_entropy,
    "neg-loss": nll_loss,
    "l1": l1_loss,
    "l2": l2_loss,
    "custom": custom_loss_function,
}


def get_criterion(name: str, label_smoothing: float = 0.0) -> Callable:
    """Map a criterion name to its loss function."""
    try:
        criterion = CRITERIA[name]
    except KeyError:
        raise ValueError(
            f"Unknown criterion {name!r}; expected one of {sorted(CRITERIA)}"
        ) from None
    if label_smoothing:
        if name != "cross_entropy":
            raise ValueError(
                "label_smoothing only applies to criterion='cross_entropy', "
                f"got {name!r}"
            )
        return cross_entropy_smoothed(label_smoothing)
    return criterion

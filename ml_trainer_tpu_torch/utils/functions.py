"""User-extension hooks (the JAX package's ``utils/functions.py``).

Only the custom loss is ported; the custom CIFAR-10 preprocess needs the
batch transforms, which are not ported yet (ROADMAP.md Queue A).
"""

from __future__ import annotations

import torch


def custom_loss_function(output: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    """Mean squared error, the reference's custom loss."""
    return torch.mean((output - target) ** 2)

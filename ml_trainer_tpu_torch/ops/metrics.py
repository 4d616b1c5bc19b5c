"""Metrics (the JAX package's ``ops/metrics.py``), computed on the
device: ``accuracy``, ``mcrmse``, ``top5_accuracy``, ``f1`` and
``perplexity``.  Each is ``(outputs, targets) -> scalar tensor`` with
the prediction function bound at lookup.  A metric whose epoch value is
nonlinear carries ``finalize``: ``perplexity`` accumulates the mean
token NLL and the trainer exponentiates the epoch mean once.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ml_trainer_tpu_torch.ops.predictions import get_predictions


def accuracy(outputs, targets, pred_function: Optional[Callable] = None):
    predictions = get_predictions(outputs, pred_function)
    return torch.mean((predictions == targets).to(torch.float32))


def mcrmse(outputs, targets, pred_function: Optional[Callable] = None):
    colwise_mse = torch.mean(torch.square(targets - outputs), dim=0)
    return torch.mean(torch.sqrt(colwise_mse), dim=0)


def top5_accuracy(outputs, targets, pred_function: Optional[Callable] = None):
    """Target among the 5 highest-scoring classes (fewer classes: all of
    them).  Monotone prediction functions do not change the ranking."""
    top5 = torch.topk(outputs, min(5, outputs.shape[-1]), dim=-1).indices
    hit = (top5 == targets[..., None].to(top5.dtype)).any(dim=-1)
    return torch.mean(hit.to(torch.float32))


def f1(outputs, targets, pred_function: Optional[Callable] = None):
    """Per-batch binary F1 on class 1; 0 when the batch has no positives
    (the trainer averages it over batches, as the reference does)."""
    predictions = get_predictions(outputs, pred_function)
    pred_pos = (predictions == 1).to(torch.float32)
    true_pos = (targets == 1).to(torch.float32)
    tp = torch.sum(pred_pos * true_pos)
    denom = torch.sum(pred_pos) + torch.sum(true_pos)
    return torch.where(denom > 0, 2.0 * tp / torch.clamp(denom, min=1.0),
                       torch.zeros_like(tp))


def _mean_token_nll(outputs, targets,
                    pred_function: Optional[Callable] = None):
    """Mean token NLL of [B, S, V] logits against [B, S] next tokens."""
    logprobs = torch.log_softmax(outputs.to(torch.float32), dim=-1)
    nll = -torch.gather(logprobs, -1, targets.long()[..., None])
    return torch.mean(nll)


_mean_token_nll.finalize = torch.exp

METRICS = {
    "accuracy": accuracy,
    "mcrmse": mcrmse,
    "top5_accuracy": top5_accuracy,
    "f1": f1,
    "perplexity": _mean_token_nll,
}


def get_metric(name: Optional[str],
               pred_function: Optional[Callable] = None
               ) -> Optional[Callable]:
    """Bind a metric by name (None disables metrics); a nonlinear metric's
    ``finalize`` rides on the returned callable."""
    if name is None:
        return None
    try:
        fn = METRICS[name]
    except KeyError:
        raise ValueError(
            f"Unknown metric {name!r}; expected one of {sorted(METRICS)}"
        ) from None

    def bound(outputs, targets):
        return fn(outputs, targets, pred_function)

    finalize = getattr(fn, "finalize", None)
    if finalize is not None:
        bound.finalize = finalize
    return bound

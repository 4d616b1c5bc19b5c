"""Criteria (the JAX package's ``ops/losses.py``): name -> loss function
``(outputs, targets) -> scalar``.

Same names: ``cross_entropy`` (integer labels over any leading dims,
mean over all of them, optax's ``softmax_cross_entropy_with_integer_labels``),
``neg-loss`` (NLL over log-probabilities), ``l1``, ``l2`` and
``custom``; ``label_smoothing`` composes with ``cross_entropy`` only.
``chunked_lm_cross_entropy`` is the tied LM head's loss that never holds
the [B, S, V] logits (GPT-2's ``loss_chunk``).
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


class _ChunkedLMCrossEntropy(torch.autograd.Function):
    """``mean(xent(hidden @ embedding^T, targets))`` over sequence chunks.

    The forward keeps only its inputs and each position's log-sum-exp
    ([B, S] float32); the backward recomputes each chunk's float32 logits
    (the JAX package's ``jax.checkpoint`` around its scan body), so that
    one [B, chunk, V] block is alive at a time in either pass.  dE is
    summed over the chunks in their order.  No host
    read and a chunk count fixed by the shapes: it captures into a CUDA
    graph."""

    @staticmethod
    def forward(ctx, hidden, embedding, targets, chunk_size):
        b, s, _ = hidden.shape
        emb = embedding.float()
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        lse = torch.empty((b, s), dtype=torch.float32, device=hidden.device)
        for i in range(s // chunk_size):
            sl = slice(i * chunk_size, (i + 1) * chunk_size)
            logits = hidden[:, sl].float() @ emb.T
            lse[:, sl] = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, -1, targets[:, sl, None])[..., 0]
            total = total + (lse[:, sl] - picked).sum()
        ctx.chunk_size = chunk_size
        ctx.save_for_backward(hidden, embedding, targets, lse)
        return total / (b * s)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        hidden, embedding, targets, lse = ctx.saved_tensors
        c = ctx.chunk_size
        b, s, d = hidden.shape
        emb = embedding.float()
        scale = grad.float() / (b * s)
        want_h, want_e = ctx.needs_input_grad[:2]
        d_hidden = torch.empty_like(hidden) if want_h else None
        d_emb = (torch.zeros(emb.shape, dtype=torch.float32,
                             device=emb.device) if want_e else None)
        for i in range(s // c):
            sl = slice(i * c, (i + 1) * c)
            h = hidden[:, sl].float()
            logits = h @ emb.T
            # softmax - onehot, times the upstream gradient over B * S.
            probs = logits.sub_(lse[:, sl, None]).exp_()
            idx = targets[:, sl, None]
            probs.scatter_(-1, idx, torch.gather(probs, -1, idx) - 1.0)
            probs.mul_(scale)
            if want_h:
                d_hidden[:, sl] = probs @ emb
            if want_e:
                d_emb.addmm_(probs.reshape(-1, probs.shape[-1]).T,
                             h.reshape(-1, d))
        if want_e:
            d_emb = d_emb.to(embedding.dtype)
        return d_hidden, d_emb, None, None


def chunked_lm_cross_entropy(hidden, embedding, targets, chunk_size=128):
    """LM cross entropy without materialising the [B, S, V] logits.

    ``mean(xent(hidden @ embedding^T, targets))`` over B * S, the logits
    computed in float32 whatever ``hidden``'s dtype, one sequence chunk
    of ``chunk_size`` positions at a time, forward and backward (the
    backward recomputes each chunk's logits once: the flash-attention
    trade applied to the LM head).  The gradients come back in the
    inputs' dtypes.

    hidden: [B, S, D] (any float dtype), embedding: [V, D] (the tied
    token-embedding matrix), targets: [B, S] integer labels.  S must
    divide by ``chunk_size``.
    """
    s = hidden.shape[1]
    if s % chunk_size:
        raise ValueError(
            f"sequence length {s} not divisible by chunk_size {chunk_size}"
        )
    return _ChunkedLMCrossEntropy.apply(hidden, embedding, targets.long(),
                                        int(chunk_size))


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

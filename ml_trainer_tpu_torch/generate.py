"""Autoregressive generation with a KV cache (the JAX package's
``generate.py``).

The prompt prefills a ``ContiguousKVCache`` in one causal forward (the
flash kernel's route for tile-aligned prompts), then the loop decodes one
token per step.  A train-mode LoRA model (``Trainer(lora=...)``'s, its
adapters as parameters) decodes the same way: its deltas act with the
cache as without, and its greedy tokens are what the serving engine's
adapter pool is held to.  PyTorch runs eagerly, so there is no compiled-program
cache; capturing the step as a CUDA graph is later work.

Sampling.  ``temperature == 0`` is greedy argmax.  Otherwise every row
draws from its OWN ``torch.Generator``, seeded afresh for each token
from ``(seed, t)`` (``_token_seed``), the port's analogue of the
reference's ``fold_in(rng, t)``: a row's stream never depends on which
other rows share its batch.  ``jax.random`` draws cannot be reproduced
in PyTorch, so sampled output is pinned within the port only (the
serving engine draws the same numbers for the same request); greedy
output matches the JAX package.  ``top_k``, ``top_p``, beam search and
speculative decoding are not ported yet (ROADMAP.md Queue A).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ml_trainer_tpu_torch.device import check_model_device


def _token_seed(seed: int, t: int) -> int:
    """A 63-bit generator seed from a request seed and token counter."""
    s = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(t)])
    hi, lo = (int(x) for x in s.generate_state(2, np.uint32))
    return ((hi << 32) | lo) & ((1 << 63) - 1)


def sample_rows(last: torch.Tensor, temps: Sequence[float],
                seeds: Sequence[int], steps: Sequence[int]) -> torch.Tensor:
    """Per-row sampling of ``last`` [B, V]: argmax where ``temps[b] == 0``,
    else one categorical draw at ``temps[b]`` from a generator seeded
    with ``_token_seed(seeds[b], steps[b])``.  Returns [B] int64."""
    tok = torch.argmax(last, dim=-1)
    for b, temp in enumerate(temps):
        if temp <= 0:
            continue
        gen = torch.Generator(device=last.device)
        gen.manual_seed(_token_seed(seeds[b], steps[b]))
        probs = torch.softmax(last[b].float() / float(temp), dim=-1)
        tok[b] = torch.multinomial(probs, 1, generator=gen)[0]
    return tok


def generate(model, prompt_ids, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
             rng: Optional[Union[int, Sequence[int]]] = None,
             spec_k: int = 0, device=None) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt_ids`` [B, P];
    returns [B, P + max_new_tokens] int64 on the model's device.

    ``rng``: an int seed (row b draws with seed ``rng + b``), a sequence
    of per-row seeds, or None (seed 0).  With ``eos_token_id``, a row
    that emitted EOS pads every later position with ``pad_token_id``.
    ``device`` defaults to the CUDA card; the model must live there.
    """
    if top_k is not None or top_p is not None or spec_k:
        raise NotImplementedError(
            "top_k / top_p / speculative decoding are not ported yet; see "
            "ROADMAP.md Queue A"
        )
    dev = check_model_device(model, device)
    prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long,
                             device=dev)
    if prompt.ndim != 2:
        raise ValueError(f"prompt_ids must be [B, P], got {tuple(prompt.shape)}")
    b, prompt_len = prompt.shape
    vocab = model.vocab_size
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if eos_token_id is not None and not 0 <= eos_token_id < vocab:
        raise ValueError(f"eos_token_id must be in [0, vocab_size={vocab}), "
                         f"got {eos_token_id}")
    if eos_token_id is not None and not 0 <= pad_token_id < vocab:
        raise ValueError(f"pad_token_id must be in [0, vocab_size={vocab}), "
                         f"got {pad_token_id}")
    if max_new_tokens == 0:
        return prompt
    total = prompt_len + max_new_tokens
    if total > model.max_len:
        raise ValueError(
            f"prompt ({prompt_len}) + new tokens ({max_new_tokens}) exceeds "
            f"the model's max_len ({model.max_len})"
        )
    if rng is None:
        rng = 0
    seeds = ([int(rng) + i for i in range(b)] if np.ndim(rng) == 0
             else [int(s) for s in rng])
    if len(seeds) != b:
        raise ValueError(f"{len(seeds)} seeds for a batch of {b}")
    temps = [float(temperature)] * b

    out = [prompt]
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    with torch.no_grad():
        cache = model.new_cache(b, max_len=total)
        last = model(prompt, cache,
                     select=torch.full((b,), prompt_len - 1, device=dev))
        for t in range(max_new_tokens):
            tok = sample_rows(last, temps, seeds, [t] * b)
            if eos_token_id is not None:
                tok = torch.where(done, torch.full_like(tok, pad_token_id),
                                  tok)
                done = done | (tok == eos_token_id)
            out.append(tok[:, None])
            if t + 1 < max_new_tokens:
                last = model(tok[:, None], cache,
                             select=torch.zeros(b, dtype=torch.long,
                                                device=dev))
    return torch.cat(out, dim=1)

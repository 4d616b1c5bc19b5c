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
output matches the JAX package.  ``top_k`` / ``top_p`` filter the
logits before the draw (``filter_logits``, the JAX sampler's rule).

The other modes: ``spec_k > 0`` routes through speculative decoding
(``speculative.py``); ``generate_ragged`` buckets prompts of unequal
lengths; ``beam_search`` keeps the ``num_beams`` best continuations.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ml_trainer_tpu_torch.device import check_model_device


def _token_seed(seed: int, t: int, *tags: int) -> int:
    """A 63-bit generator seed from a request seed and token counter
    (``tags`` tell apart several draws at one counter)."""
    s = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(t), *tags])
    hi, lo = (int(x) for x in s.generate_state(2, np.uint32))
    return ((hi << 32) | lo) & ((1 << 63) - 1)


def filter_logits(last: torch.Tensor, temperature: float,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """The JAX sampler's filters on logits ``last`` [B, V]; what cannot
    be drawn becomes ``-inf``.  ``top_k`` keeps every logit ``>=`` the
    k-th largest (ties at the k-th included).  ``top_p`` then sorts
    descending, takes the softmax at ``temperature``, keeps the tokens
    whose EXCLUSIVE cumulative mass is ``< top_p`` (the first always
    survives) and masks every logit below the smallest kept one."""
    if top_k is not None:
        kth = torch.topk(last, top_k, dim=-1).values[:, -1:]
        last = torch.where(last < kth, -torch.inf, last)
    if top_p is not None:
        ranked = torch.sort(last, dim=-1, descending=True).values
        probs = torch.softmax(ranked / temperature, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(keep, ranked, torch.inf).min(
            dim=-1, keepdim=True).values
        last = torch.where(last < cutoff, -torch.inf, last)
    return last


def sample_rows(last: torch.Tensor, temps: Sequence[float],
                seeds: Sequence[int], steps: Sequence[int],
                top_k: Optional[int] = None,
                top_p: Optional[float] = None) -> torch.Tensor:
    """Per-row sampling of ``last`` [B, V]: argmax where ``temps[b] == 0``,
    else one categorical draw at ``temps[b]`` (after ``filter_logits``)
    from a generator seeded with ``_token_seed(seeds[b], steps[b])``.
    Returns [B] int64."""
    tok = torch.argmax(last, dim=-1)
    for b, temp in enumerate(temps):
        if temp <= 0:
            continue
        gen = torch.Generator(device=last.device)
        gen.manual_seed(_token_seed(seeds[b], steps[b]))
        row = filter_logits(last[b:b + 1].float(), float(temp), top_k,
                            top_p)[0]
        probs = torch.softmax(row / float(temp), dim=-1)
        tok[b] = torch.multinomial(probs, 1, generator=gen)[0]
    return tok


def _row_seeds(rng, b: int) -> list:
    """Per-row seeds: ``rng + row`` for an int (0 for None), else the
    sequence as given."""
    if rng is None:
        rng = 0
    seeds = ([int(rng) + i for i in range(b)] if np.ndim(rng) == 0
             else [int(s) for s in rng])
    if len(seeds) != b:
        raise ValueError(f"{len(seeds)} seeds for a batch of {b}")
    return seeds


def generate(model, prompt_ids, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
             rng: Optional[Union[int, Sequence[int]]] = None,
             spec_k: int = 0, drafter="ngram", device=None) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt_ids`` [B, P];
    returns [B, P + max_new_tokens] int64 on the model's device.

    ``rng``: an int seed (row b draws with seed ``rng + b``), a sequence
    of per-row seeds, or None (seed 0).  ``top_k`` / ``top_p`` restrict
    a sampled draw (both compose, top_k first; greedy ignores them).
    With ``eos_token_id``, a row that emitted EOS pads every later
    position with ``pad_token_id``.  ``spec_k > 0`` decodes
    speculatively (``speculative.speculative_generate``) with
    ``drafter`` ("ngram", an ``NgramDrafter``, a ``DraftModelDrafter``
    or a model); greedy output is the same, and the filters are refused
    there.  ``device`` defaults to the CUDA card; the model must live
    there.
    """
    if spec_k:
        if top_k is not None or top_p is not None:
            raise ValueError(
                "speculative decoding (spec_k > 0) does not support "
                "top_k/top_p filtering — use spec_k=0"
            )
        from ml_trainer_tpu_torch.speculative import speculative_generate

        return speculative_generate(
            model, prompt_ids, max_new_tokens, draft_k=spec_k,
            drafter=drafter, temperature=temperature, rng=rng,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id,
            device=device)
    dev = check_model_device(model, device)
    prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long,
                             device=dev)
    if prompt.ndim != 2:
        raise ValueError(f"prompt_ids must be [B, P], got {tuple(prompt.shape)}")
    b, prompt_len = prompt.shape
    vocab = model.vocab_size
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if top_k is not None and not 0 < top_k <= vocab:
        raise ValueError(
            f"top_k must be in [1, vocab_size={vocab}], got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
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
    seeds = _row_seeds(rng, b)
    temps = [float(temperature)] * b

    out = [prompt]
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    with torch.no_grad():
        cache = model.new_cache(b, max_len=total)
        last = model(prompt, cache,
                     select=torch.full((b,), prompt_len - 1, device=dev))
        for t in range(max_new_tokens):
            tok = sample_rows(last, temps, seeds, [t] * b, top_k, top_p)
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


def _fold_seed(seed: int, length: int) -> int:
    """A bucket's seed from the call's seed and the bucket's prompt
    length (the JAX package's ``fold_in(rng, length)``)."""
    s = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(length),
                                0x52414744])
    return int(s.generate_state(1, np.uint32)[0])


def generate_ragged(model, prompts, max_new_tokens: int, **kwargs) -> list:
    """``generate`` for prompts of UNEQUAL lengths: the rows are grouped
    by length and each group runs as one batch.  ``prompts``: non-empty
    1-D token arrays; returns a list of 1-D int64 tensors in the same
    order, each ``len(prompt) + max_new_tokens`` long.  ``kwargs`` pass
    through to ``generate``; an int ``rng`` (0 when sampling without
    one) is folded with each bucket's length, so that samples stay
    independent across buckets.  The JAX package pads each group's batch
    to a power of two to bound its compile cache; the port runs eagerly
    and does not pad."""
    prompts = list(prompts)
    by_len: dict = {}
    for i, p in enumerate(prompts):
        p = np.asarray(p)
        if p.ndim != 1 or p.shape[0] == 0:
            raise ValueError(
                f"prompts must be non-empty 1-D token arrays; prompt {i} "
                f"has shape {p.shape}"
            )
        by_len.setdefault(p.shape[0], []).append((i, p))
    out: list = [None] * len(prompts)
    rng = kwargs.pop("rng", None)
    if rng is None and kwargs.get("temperature", 0.0) != 0.0:
        rng = 0
    for length, group in sorted(by_len.items()):
        idx, rows = zip(*group)
        group_kwargs = dict(kwargs)
        if rng is not None:
            group_kwargs["rng"] = _fold_seed(rng, length)
        done = generate(model, np.stack(rows), max_new_tokens,
                        **group_kwargs)
        for j, row in zip(idx, done):
            out[j] = row
    return out


def _top(scores: torch.Tensor, k: int):
    """The ``k`` largest of each row, ties to the lower index first (as
    ``lax.top_k``): (values, indices)."""
    values, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[:, :k], order[:, :k]


def beam_search(model, prompt_ids, max_new_tokens: int, num_beams: int = 4,
                device=None) -> torch.Tensor:
    """Fixed-horizon beam search: the ``num_beams`` highest-scoring
    continuations are kept at every step and the best final sequence is
    returned ([B, P + max_new_tokens] int64).

    One prefill at batch B, the cache tiled beam-major to B·num_beams
    (row b's beams at b·k .. b·k+k-1), the beams seeded from the
    vocabulary's top k, then at every step the top k of ``scores +
    logprobs`` over k·V, the sequences reordered and the cache's batch
    axis gathered.  No EOS: every beam runs the full horizon, so scores
    compare equal-length sequences.
    """
    dev = check_model_device(model, device)
    prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long,
                             device=dev)
    if prompt.ndim != 2:
        raise ValueError(f"prompt_ids must be [B, P], got {tuple(prompt.shape)}")
    b, prompt_len = prompt.shape
    k = num_beams
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if not 0 < k <= model.vocab_size:
        raise ValueError(
            f"num_beams must be in [1, vocab_size={model.vocab_size}], "
            f"got {num_beams}"
        )
    total = prompt_len + max_new_tokens
    if total > model.max_len:
        raise ValueError(
            f"prompt ({prompt_len}) + new tokens ({max_new_tokens}) exceeds "
            f"the model's max_len ({model.max_len})"
        )
    with torch.no_grad():
        cache = model.new_cache(b, max_len=total)
        last = model(prompt, cache,
                     select=torch.full((b,), prompt_len - 1, device=dev))
        scores, tok = _top(torch.log_softmax(last.float(), -1), k)
        for layer in range(len(cache.k)):
            cache.k[layer] = cache.k[layer].repeat_interleave(k, dim=0)
            cache.v[layer] = cache.v[layer].repeat_interleave(k, dim=0)
        cache.index = cache.index.repeat_interleave(k, dim=0)
        seqs = tok[:, :, None]                              # [B, K, t]
        base = torch.arange(b, device=dev)[:, None] * k
        zeros = torch.zeros(b * k, dtype=torch.long, device=dev)
        for _ in range(1, max_new_tokens):
            logits = model(seqs[:, :, -1].reshape(b * k, 1), cache,
                           select=zeros)
            logprobs = torch.log_softmax(logits.float(), -1)
            vocab = logprobs.shape[-1]
            total_scores = scores[:, :, None] + logprobs.reshape(b, k, vocab)
            scores, flat = _top(total_scores.reshape(b, k * vocab), k)
            beam = flat // vocab
            seqs = torch.cat([
                torch.gather(seqs, 1,
                             beam[:, :, None].expand(-1, -1, seqs.shape[2])),
                (flat % vocab)[:, :, None]], dim=2)
            gather = (base + beam).reshape(-1)
            for layer in range(len(cache.k)):
                cache.k[layer] = cache.k[layer][gather]
                cache.v[layer] = cache.v[layer][gather]
            cache.index = cache.index[gather]
    # Sorted descending: beam 0 is the winner.
    return torch.cat([prompt, seqs[:, 0]], dim=1)

"""Speculative decoding (the JAX package's ``speculative.py``): draft K
tokens cheaply, verify them in ONE forward of the target model.

The target scores a length-``K+1`` window (the last committed token and
the K drafts) at each row's own offset: the contiguous cache's
``windowed`` mode (``models/layers.py``) or the paged cache's window
write, and plain masked attention over the cached prefix in both.

Two draft sources:

* ``NgramDrafter``: model-free prompt/history lookup; the last n-gram of
  the sequence so far is matched against everything before it and the
  continuation of the most recent match is proposed.
* ``DraftModelDrafter``: a small causal LM of the SAME vocabulary (e.g.
  ``gpt2_nano`` for ``gpt2_mini``, ``models.registry.DRAFT_PAIRS``)
  decoding greedily with its own cache.  The port's module carries its
  own weights, so there is no ``draft_variables``.

Acceptance (``verify``):

* greedy rows: longest accepted prefix; draft ``d_j`` is accepted iff it
  equals the target's argmax after ``d_1..d_{j-1}``, and the first
  mismatch takes the target's argmax.  The committed stream is the
  vanilla greedy stream for ANY drafts.
* sampled rows: rejection sampling against the drafter's point
  distribution; ``d_j`` is accepted with probability ``p(d_j)`` (target
  softmax at the row's temperature), else the next token is drawn from
  the residual ``p`` with ``d_j`` masked and renormalised.  Each row
  draws from its own generators, seeded from (request seed, step) with
  one tag for the uniforms and another for the residual draw (the JAX
  package's ``fold_in(k, 1)`` and ``fold_in(k, 2)``), so sampled output
  is pinned within the port.

Rollback: the host owns every row's consumed-token count ``pos``.  The
cache's index is set from it before each verify and draft pass and
again after the verify (``min(pos + accepted + 1, caps)``), so rejected
positions are never attended and the next window writes over them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ml_trainer_tpu_torch.device import check_model_device
from ml_trainer_tpu_torch.generate import _row_seeds, _token_seed, sample_rows

# Generator tags of a verify step's two draws.
_UNIFORM_TAG, _RESIDUAL_TAG = 1, 2


class NgramDrafter:
    """Model-free prompt/history n-gram lookup drafter.

    ``draft_one(history)`` matches the last ``n``-gram (falling back to
    shorter grams down to ``min_n``) of ``history`` against every
    earlier position and proposes the continuation after the MOST RECENT
    match.  No match: the last token repeated."""

    def __init__(self, k: int = 4, n: int = 3, min_n: int = 1):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if not 1 <= min_n <= n:
            raise ValueError(f"need 1 <= min_n <= n, got n={n} min_n={min_n}")
        self.k = k
        self.n = n
        self.min_n = min_n

    def draft_one(self, history: np.ndarray) -> np.ndarray:
        hist = np.asarray(history).reshape(-1)
        m = hist.shape[0]
        for n in range(min(self.n, m - 1), self.min_n - 1, -1):
            pat = hist[m - n:]
            # Windows over hist[:-1]: every start has a continuation.
            wins = np.lib.stride_tricks.sliding_window_view(hist[:-1], n)
            hits = np.flatnonzero((wins == pat).all(axis=1))
            if hits.size:
                i = int(hits[-1])  # most recent match
                cont = hist[i + n: i + n + self.k]
                if cont.size < self.k:
                    cont = np.concatenate([
                        cont,
                        np.full(self.k - cont.size, cont[-1], hist.dtype),
                    ])
                return cont.astype(np.int32)
        return np.full(self.k, hist[-1], np.int32)

    def draft(self, histories) -> np.ndarray:
        """[B, k] drafts for a batch of 1-D histories."""
        return np.stack([self.draft_one(h) for h in histories])


class DraftModelDrafter:
    """A small causal LM as the draft source.  It decodes greedily with
    its own contiguous cache, K+1 steps a verify (``draft_scan``)."""

    def __init__(self, model):
        self.model = model

    def check_compatible(self, target_model) -> None:
        if self.model.vocab_size != target_model.vocab_size:
            raise ValueError(
                "draft model vocab_size "
                f"({self.model.vocab_size}) must equal the target's "
                f"({target_model.vocab_size}) — speculative acceptance "
                "compares token ids across the two models"
            )


def _generator(device, seed: int, step: int, tag: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(_token_seed(seed, step, tag))
    return gen


def verify(logits: torch.Tensor, window: torch.Tensor, temps, seeds,
           steps):
    """The verify arithmetic of the JAX package's ``build_verify`` on
    the target's window logits [B, s, V] (s = K+1) and the window
    [B, s] (last committed token, then the K drafts).  Rows with
    ``temps[b] == 0`` accept greedily; the others by rejection sampling.
    Returns host arrays (accepted drafts [B] in [0, K], next token [B]),
    read with one device-to-host copy."""
    logits = logits.float()
    b, s, vocab = logits.shape
    dev = logits.device
    greedy_next = torch.argmax(logits, dim=-1)            # [B, s]
    match = greedy_next[:, :-1] == window[:, 1:]          # [B, K]
    sampled = [i for i in range(b) if temps[i] > 0]
    if sampled:
        rows = torch.tensor(sampled, device=dev)
        t = torch.tensor([float(temps[i]) for i in sampled], device=dev)
        probs = torch.softmax(logits[rows] / t[:, None, None], dim=-1)
        p_draft = torch.gather(probs[:, :-1], 2,
                               window[rows, 1:, None])[..., 0]   # [n, K]
        u = torch.stack([
            torch.rand(s - 1, device=dev,
                       generator=_generator(dev, seeds[i], steps[i],
                                            _UNIFORM_TAG))
            for i in sampled])
        match[rows] = u < p_draft
    accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)      # [B]
    nxt = torch.gather(greedy_next, 1, accepted[:, None])[:, 0]
    if sampled:
        acc = accepted[rows]
        # The distribution at position `accepted`: the bonus position's
        # when every draft was accepted, else the rejected draft's, with
        # that draft masked and the rest renormalised.
        p_next = probs[torch.arange(len(sampled), device=dev), acc]
        rejected = torch.gather(window[rows], 1,
                                torch.clamp(acc + 1, max=s - 1)[:, None])
        drop = torch.zeros_like(p_next, dtype=torch.bool).scatter_(
            1, rejected, True) & (acc < s - 1)[:, None]
        resid = torch.where(drop, 0.0, p_next)
        mass = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(mass > 0, resid / mass, torch.ones_like(resid))
        for j, i in enumerate(sampled):
            nxt[i] = torch.multinomial(
                resid[j], 1, generator=_generator(dev, seeds[i], steps[i],
                                                  _RESIDUAL_TAG))[0]
    host = torch.stack([accepted, nxt]).cpu().numpy()
    return host[0], host[1]


def draft_scan(model, cache, tok: torch.Tensor, pos: np.ndarray,
               k: int) -> np.ndarray:
    """K+1 greedy S == 1 steps of the draft ``model`` from each row's
    ``pos`` (the cache's index set from it first), consuming ``tok``
    [B, 1] first; step j emits draft j.  The (K+1)-th step consumes the
    last draft only to land its K/V, so the draft cache covers the whole
    verify window at any acceptance count.  Returns the [B, k] drafts on
    the host."""
    cache.index.copy_(torch.from_numpy(np.asarray(pos, np.int64)))
    zeros = torch.zeros(tok.shape[0], dtype=torch.long, device=tok.device)
    drafts = []
    for _ in range(k + 1):
        tok = torch.argmax(model(tok, cache, select=zeros), dim=-1)[:, None]
        drafts.append(tok)
    return torch.cat(drafts[:k], dim=1).cpu().numpy().astype(np.int32)


def _check_target(model) -> None:
    if not hasattr(model, "new_paged_cache"):
        # Only MultiHeadAttention writes a window at per-row offsets; the
        # JAX GQAttention has no such mode either.
        raise ValueError(
            f"speculative decoding needs a slot-indexed windowed cache, "
            f"which {type(model).__name__} does not have (the GPT-2 "
            "family has it)")


def speculative_generate(model, prompt_ids, max_new_tokens: int,
                         draft_k: int = 4, drafter="ngram",
                         temperature: float = 0.0, rng=None,
                         eos_token_id: Optional[int] = None,
                         pad_token_id: int = 0, ngram: int = 3,
                         return_stats: bool = False, device=None):
    """``generate()`` with speculative decoding; same output contract.

    ``drafter``: ``"ngram"``, an ``NgramDrafter``, a ``DraftModelDrafter``
    or a model (wrapped in one).  Greedy output (``temperature == 0``)
    equals ``generate()``'s; sampled output follows the same distribution
    by rejection sampling but draws another stream (``rng``: an int seed,
    row b seeded ``rng + b``, or per-row seeds).  Returns
    [B, P + max_new_tokens] int64, and with ``return_stats`` a dict
    (``accept_hist``, ``acceptance_rate``, ``tokens_per_step``, ...).
    """
    dev = check_model_device(model, device)
    _check_target(model)
    prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long,
                             device=dev)
    if prompt.ndim != 2:
        raise ValueError(f"prompt_ids must be [B, P], got {tuple(prompt.shape)}")
    b, p = prompt.shape
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if draft_k < 1:
        raise ValueError(f"draft_k must be >= 1, got {draft_k}")
    if p + max_new_tokens + draft_k > model.max_len:
        raise ValueError(
            f"prompt ({p}) + new tokens ({max_new_tokens}) + draft_k "
            f"({draft_k}) exceeds max_len ({model.max_len}); the verify "
            "window needs draft_k tokens of cache slack — reduce draft_k "
            "or max_new_tokens"
        )
    if eos_token_id is not None and not 0 <= eos_token_id < model.vocab_size:
        raise ValueError(
            f"eos_token_id must be in [0, vocab_size={model.vocab_size}), "
            f"got {eos_token_id}"
        )
    if max_new_tokens == 0:
        return (prompt, _empty_stats(draft_k)) if return_stats else prompt

    draft_model = None
    if isinstance(drafter, str) and drafter == "ngram":
        drafter = NgramDrafter(k=draft_k, n=ngram)
    elif isinstance(drafter, NgramDrafter):
        if drafter.k != draft_k:
            raise ValueError(f"drafter.k ({drafter.k}) != draft_k ({draft_k})")
    elif isinstance(drafter, DraftModelDrafter):
        draft_model = drafter.model
    elif isinstance(drafter, torch.nn.Module) and hasattr(drafter, "max_len"):
        draft_model = drafter
    else:
        raise ValueError(
            f"drafter must be 'ngram', an NgramDrafter, a "
            f"DraftModelDrafter or a model, got {drafter!r}"
        )
    if draft_model is not None:
        DraftModelDrafter(draft_model).check_compatible(model)
        check_model_device(draft_model, dev)
        if p + max_new_tokens + draft_k > draft_model.max_len:
            raise ValueError(
                "the draft model's max_len "
                f"({draft_model.max_len}) is too short for this "
                f"request (needs {p + max_new_tokens + draft_k})"
            )

    s = draft_k + 1
    seeds = _row_seeds(rng, b)
    temps = [float(temperature)] * b
    last_pos = torch.full((b,), p - 1, device=dev)
    with torch.no_grad():
        cache = model.new_cache(b)
        last = model(prompt, cache, select=last_pos)
        cache.windowed = True
        tok = sample_rows(last, temps, seeds, [0] * b)
        if draft_model is not None:
            d_cache = draft_model.new_cache(b)
            draft_model(prompt, d_cache, select=last_pos)

    out = np.zeros((b, max_new_tokens), np.int64)
    counts = np.zeros(b, np.int64)          # committed tokens per row
    done = np.zeros(b, bool)                # rows that emitted EOS
    pos = np.full(b, p, np.int64)           # consumed tokens per row
    caps = np.full(b, p + max_new_tokens - 1, np.int64)
    steps = np.zeros(b, np.int64)
    hist = np.zeros((b, p + max_new_tokens), np.int64)
    hist[:, :p] = prompt.cpu().numpy()
    accept_hist = np.zeros(s, np.int64)
    verify_steps = 0

    _commit_token(tok.cpu().numpy(), out, counts, done, hist, p,
                  eos_token_id, pad_token_id, max_new_tokens)
    with torch.no_grad():
        while counts.min() < max_new_tokens:
            if draft_model is not None:
                drafts = draft_scan(draft_model, d_cache, tok[:, None], pos,
                                    draft_k)
            else:
                drafts = drafter.draft(
                    [hist[i, : p + int(counts[i])] for i in range(b)])
            window = torch.cat(
                [tok[:, None],
                 torch.from_numpy(drafts.astype(np.int64)).to(dev)], dim=1)
            cache.index.copy_(torch.from_numpy(pos))
            acc, nxt = verify(model(window, cache), window, temps, seeds,
                              steps)
            verify_steps += 1
            live = counts < max_new_tokens
            np.add.at(accept_hist, acc[live], 1)
            for j in range(draft_k + 1):
                # Commit the accepted drafts, then the verify token.
                sel = acc >= j + 1
                row_tok = np.where(sel, drafts[:, j] if j < draft_k else 0,
                                   nxt)
                _commit_token(row_tok, out, counts, done, hist, p,
                              eos_token_id, pad_token_id, max_new_tokens,
                              rows=(acc >= j) & live)
            pos = np.minimum(pos + acc + 1, caps)
            cache.index.copy_(torch.from_numpy(pos))
            steps = steps + acc + 1
            tok = torch.from_numpy(nxt).to(dev)

    result = torch.cat([prompt, torch.from_numpy(out).to(dev)], dim=1)
    if not return_stats:
        return result
    # One histogram entry per (step, live row): the batch drafts too.
    drafted = int(accept_hist.sum()) * draft_k
    accepted_total = int((accept_hist * np.arange(s)).sum())
    return result, {
        "draft_k": draft_k,
        "verify_steps": verify_steps,
        "accept_hist": accept_hist.tolist(),
        "drafted_tokens": drafted,
        "accepted_tokens": accepted_total,
        "acceptance_rate": accepted_total / drafted if drafted else 0.0,
        "tokens_per_step": (
            float((accept_hist * (np.arange(s) + 1)).sum()
                  / accept_hist.sum())
            if accept_hist.sum() else 0.0
        ),
    }


def _empty_stats(draft_k: int) -> dict:
    return {
        "draft_k": draft_k, "verify_steps": 0,
        "accept_hist": [0] * (draft_k + 1), "drafted_tokens": 0,
        "accepted_tokens": 0, "acceptance_rate": 0.0,
        "tokens_per_step": 0.0,
    }


def _commit_token(row_tok, out, counts, done, hist, p,
                  eos_token_id, pad_token_id, max_new_tokens, rows=None):
    """Append one token per selected row to the output and history,
    with ``generate()``'s EOS -> pad tail and the per-row budget."""
    for i in range(out.shape[0]):
        if rows is not None and not rows[i]:
            continue
        c = int(counts[i])
        if c >= max_new_tokens:
            continue
        t = int(row_tok[i])
        if done[i] and eos_token_id is not None:
            t = pad_token_id
        out[i, c] = t
        hist[i, p + c] = t
        counts[i] = c + 1
        if eos_token_id is not None and not done[i] and t == eos_token_id:
            done[i] = True

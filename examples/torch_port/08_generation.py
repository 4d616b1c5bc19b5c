"""Text generation with the KV-cached decode stack, on the port
(``examples/08_generation.py`` is the JAX package's).

Every decoding mode on one model: greedy, temperature with top-k/top-p,
EOS early stop, ragged prompts (length-bucketed), beam search and
speculative decoding (n-gram drafts, greedy: the same tokens as greedy).
Works with any causal LM of the zoo; the llama family decodes through a
grouped-query cache that holds only num_kv_heads-wide K/V (speculative
decoding needs the GPT-2 family's slot cache and is skipped for it).

    python examples/torch_port/08_generation.py                # card
    BACKEND=cpu python examples/torch_port/08_generation.py    # gpt2_tiny
    MODEL=llama_tiny BACKEND=cpu python examples/torch_port/08_generation.py
"""

import _bootstrap  # noqa: F401  (repo root onto sys.path)
import os

import numpy as np

from ml_trainer_tpu_torch import (
    beam_search,
    generate,
    generate_ragged,
    init_model,
)

MODEL = os.environ.get("MODEL", "gpt2_tiny")
DEVICE = _bootstrap.device()


def main():
    # Random seeded weights: the point is the decode machinery, not prose.
    model = init_model(MODEL, seed=0, device=DEVICE).eval()
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, model.vocab_size, size=(2, 6)).astype(np.int32)
    out = {"model": model, "prompt": prompt}

    out["greedy"] = generate(model, prompt, max_new_tokens=8, device=DEVICE)
    print(f"greedy          {tuple(out['greedy'].shape)}: "
          f"{out['greedy'][0].tolist()}")

    out["sampled"] = generate(model, prompt, max_new_tokens=8,
                              temperature=0.8, top_k=50, top_p=0.95, rng=7,
                              device=DEVICE)
    print(f"top-k/top-p     {tuple(out['sampled'].shape)}: "
          f"{out['sampled'][0].tolist()}")

    out["stopped"] = generate(model, prompt, max_new_tokens=8,
                              eos_token_id=3, pad_token_id=0, device=DEVICE)
    print(f"eos-stopped     {tuple(out['stopped'].shape)}: "
          f"{out['stopped'][0].tolist()}")

    out["ragged"] = generate_ragged(
        model, [np.array([5, 6]), np.array([7, 8, 9, 10, 11])],
        max_new_tokens=4, temperature=0.7, device=DEVICE)
    print(f"ragged lens     {[len(r) for r in out['ragged']]}")

    out["beams"] = beam_search(model, prompt, max_new_tokens=6, num_beams=4,
                               device=DEVICE)
    print(f"beam search     {tuple(out['beams'].shape)}: "
          f"{out['beams'][0].tolist()}")

    if hasattr(model, "new_paged_cache"):
        out["speculative"] = generate(model, prompt, max_new_tokens=8,
                                      spec_k=4, device=DEVICE)
        print(f"speculative     {tuple(out['speculative'].shape)}: "
              f"{out['speculative'][0].tolist()}")
    return out


if __name__ == "__main__":
    main()

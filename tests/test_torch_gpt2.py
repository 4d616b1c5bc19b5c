"""Port parity: the port's GPT-2 against the JAX package's, on the CPU.

gpt2_tiny weights made by the JAX package cross through
``params_from_jax`` as numpy; then the full-forward logits agree at
float32 atol/rtol 1e-5, and greedy ``generate()`` token ids agree
exactly.
"""

import jax
import numpy as np
import pytest
import torch

from ml_trainer_tpu.generate import generate as j_generate
from ml_trainer_tpu.models import get_model as j_get_model
from ml_trainer_tpu_torch import generate, get_model, init_gpt2, params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
MAX_LEN = 64


@pytest.fixture(scope="module")
def models():
    j_model = j_get_model("gpt2_tiny", max_len=MAX_LEN)
    variables = j_model.init({"params": jax.random.PRNGKey(0)},
                             np.zeros((1, 8), np.int32), train=False)
    params_np = jax.tree.map(np.asarray, variables["params"])
    t_model = get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu")
    t_model.load_state_dict(params_from_jax(params_np))
    return j_model, variables, t_model


def _ids(seed, b, n, vocab=1024):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(
        np.int32)


def test_params_from_jax_covers_every_parameter(models):
    _, variables, t_model = models
    sd = params_from_jax(jax.tree.map(np.asarray, variables))
    want = {k: tuple(v.shape) for k, v in t_model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    kernel = np.asarray(variables["params"]["block0"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(sd["blocks.0.attn.qkv.weight"].numpy(),
                                  kernel.T)


@pytest.mark.parametrize("b,n", [(2, 24), (1, 64)])
def test_full_forward_logits_match_jax(models, b, n):
    j_model, variables, t_model = models
    ids = _ids(n, b, n)
    want = np.asarray(j_model.apply(variables, ids, train=False))
    with torch.no_grad():
        got = t_model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cached_decode_logits_match_full_forward(models):
    """Prefill + per-token steps through the contiguous cache reproduce
    the full forward's logits at every position."""
    _, _, t_model = models
    ids = torch.from_numpy(_ids(7, 2, 20)).long()
    with torch.no_grad():
        full = t_model(ids)
        cache = t_model.new_cache(2, max_len=32)
        steps = [t_model(ids[:, :12], cache)]
        for t in range(12, 20):
            steps.append(t_model(ids[:, t:t + 1], cache))
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               **TOL)


@pytest.mark.parametrize("b,p,n", [(2, 9, 16), (1, 33, 12)])
def test_greedy_generate_matches_jax(models, b, p, n):
    j_model, variables, t_model = models
    ids = _ids(100 + p, b, p)
    want = np.asarray(j_generate(j_model, variables, ids, n))
    got = generate(t_model, ids, n, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_greedy_generate_eos_padding_matches_jax(models):
    j_model, variables, t_model = models
    ids = _ids(5, 2, 6)
    free = np.asarray(j_generate(j_model, variables, ids, 10))
    eos = int(free[0, 8])  # row 0's third new token
    want = np.asarray(j_generate(j_model, variables, ids, 10,
                                 eos_token_id=eos, pad_token_id=3))
    got = generate(t_model, ids, 10, eos_token_id=eos, pad_token_id=3,
                   device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 9:] == 3).all()


def test_sampled_generate_is_per_row_and_seeded(models):
    """A row's sampled stream depends on its own seed only."""
    _, _, t_model = models
    ids = _ids(9, 3, 5)
    a = generate(t_model, ids, 8, temperature=0.9, rng=[11, 12, 13],
                 device="cpu")
    b = generate(t_model, ids[1:2], 8, temperature=0.9, rng=12, device="cpu")
    np.testing.assert_array_equal(a[1:2].numpy(), b.numpy())
    c = generate(t_model, ids, 8, temperature=0.9, rng=[11, 12, 14],
                 device="cpu")
    np.testing.assert_array_equal(a[:2].numpy(), c[:2].numpy())


def test_init_gpt2_is_seeded_and_refusals():
    a = init_gpt2("gpt2_tiny", seed=3, device="cpu", max_len=32)
    b = init_gpt2({"name": "gpt2_tiny", "max_len": 32}, seed=3, device="cpu")
    c = init_gpt2("gpt2_tiny", seed=4, device="cpu", max_len=32)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.tok_embed.weight, c.tok_embed.weight)
    assert torch.equal(a.blocks[0].ln1.weight, torch.ones(128))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model("gpt2_tiny", device="cpu", moe_experts=1)
    # LoRA is ported: train-mode adapters on the targets asked for.
    lora = get_model("gpt2_tiny", device="cpu", lora_rank=1,
                     lora_targets=("qkv",))
    assert lora.blocks[0].attn.qkv_lora_A.shape == (128, 1)
    assert not hasattr(lora.blocks[0].attn, "proj_lora_A")
    assert get_model("gpt2_tiny", device="cpu",
                     dropout_rate=0.1).embed_drop.rate == 0.1
    # top_k is ported: every sampled token is among its step's top 5.
    out = generate(a, _ids(0, 1, 4), 2, temperature=1.0, top_k=5, rng=1,
                   device="cpu")
    with torch.no_grad():
        logits = a(out[:, :-1])[:, 3:]
    assert (logits.topk(5, dim=-1).indices == out[:, 4:, None]).any(-1).all()

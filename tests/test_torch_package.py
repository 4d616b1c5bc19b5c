"""Guards of the PyTorch/CUDA port (``ml_trainer_tpu_torch``).

* No file of the port, nor ``chip_smoke.py``, imports JAX, flax, optax,
  tqdm, msgpack or the JAX package (an AST scan): the card's machine has
  none of them.
* With no card visible, every entry point raises unless it is given
  ``device="cpu"``: the port never falls back to the CPU on its own.
* On the CPU the kernels' plain versions run, and the launch counters
  stay at 0.
* ``test_kernels_match_plain_on_card`` needs an NVIDIA card and ``nvcc``
  (marker ``cuda``); it skips elsewhere, deciding inside the test.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import ml_trainer_tpu_torch as mt
from ml_trainer_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_backward_reference,
    flash_attention_reference,
)
from ml_trainer_tpu_torch.ops.kernels import (
    paged_attention,
    paged_attention_reference,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_trainer_tpu", "tqdm",
             "msgpack")


def _port_files():
    files = sorted((ROOT / "ml_trainer_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_never_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = [
        f"{p.relative_to(ROOT)}: {name}"
        for p in files for name in _imports(p)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_entry_points_raise_without_a_card(monkeypatch):
    model = mt.get_model("gpt2_tiny", max_len=32, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: mt.get_model("gpt2_tiny", max_len=32),
        lambda: mt.init_gpt2("gpt2_tiny", max_len=32),
        lambda: mt.generate(model, np.zeros((1, 3), np.int32), 2),
        lambda: mt.SlotDecodeEngine(model),
        lambda: mt.Server(model),
        lambda: mt.resolve_device(),
        lambda: mt.Trainer("gpt2_tiny"),
        lambda: mt.Trainer(model),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # The same calls run when the CPU is asked for explicitly.
    assert mt.generate(model, np.zeros((1, 3), np.int32), 2,
                       device="cpu").shape == (1, 5)
    with mt.Server(model, device="cpu") as server:
        assert server.health()["device"] == "cpu"
    assert mt.Trainer(model, device="cpu").device.type == "cpu"
    assert mt.Trainer(model, backend="gloo").device.type == "cpu"
    # A card that the weights are not on is refused too.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="model weights live on"):
        mt.SlotDecodeEngine(model, device="cuda")


def test_launch_counters_stay_zero_on_cpu(tmp_path):
    mt.reset_launch_counts()
    model = mt.init_gpt2("gpt2_tiny", seed=0, device="cpu", max_len=256)
    with mt.Server(model, kv_page_size=16, paged_kernel=True,
                   device="cpu") as server:
        out = server.complete(np.arange(130) % 1000, 4, timeout=120)
    assert out.shape == (134,)
    q = torch.randn(1, 2, 128, 64, requires_grad=True)
    flash_attention(q, q, q, None, True)[0].sum().backward()
    assert q.grad is not None
    sets = (mt.SyntheticTokens(size=4, seq_len=128, vocab_size=64),
            mt.SyntheticTokens(size=4, seq_len=128, vocab_size=64, seed=1))
    model = mt.get_model("gpt2_tiny", vocab_size=64, embed_dim=128,
                         num_heads=2, max_len=128, device="cpu")
    trainer = mt.Trainer(model, datasets=sets, epochs=1, batch_size=4,
                         grad_accum_steps=2, device="cpu",
                         model_dir=str(tmp_path))
    trainer.fit()
    assert mt.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                  "flash_bwd_dkv": 0, "paged_attention": 0}


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the card (float32,
    atol 1e-4 forward: the kernel sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA) and nvcc")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    mt.reset_launch_counts()
    for s, d, lens in ((256, 64, None), (192, 128, [100, 1]),
                       (100, 64, [60, 100])):
        q, k, v = (torch.randn(2, 3, s, d, generator=gen).to(dev)
                   for _ in range(3))
        kv = None if lens is None else torch.tensor(lens, device=dev)
        for causal in (True, False):
            out, lse = flash_attention(q, k, v, kv, causal)
            ref_out, ref_lse = flash_attention_reference(q, k, v, kv, causal)
            torch.testing.assert_close(out, ref_out, atol=1e-4, rtol=0)
            torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    b, h, d, ps, P = 4, 3, 64, 16, 8
    n = b * P + 1
    q = torch.randn(b, h, d, generator=gen).to(dev)
    kp, vp = (torch.randn(n, h, ps, d, generator=gen).to(dev)
              for _ in range(2))
    table = (1 + torch.randperm(n - 1, generator=gen)).reshape(b, P)
    table[3] = 0
    table = table.to(torch.int32).to(dev)
    lengths = torch.tensor([128, 1, 17, 1], dtype=torch.int32, device=dev)
    out = paged_attention(q, kp, vp, table, lengths)
    ref = paged_attention_reference(q, kp, vp, table, lengths)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    # K2/K3 through the autograd Function against the plain backward
    # (atol 2e-4, rtol 1e-4: float32 sums over up to S keys or queries).
    for s, d, lens, causal in ((256, 64, None, True), (192, 128, [100, 1],
                                                     False),
                               (100, 64, [60, 100], True)):
        q, k, v, g = (torch.randn(2, 3, s, d, generator=gen).to(dev)
                      for _ in range(4))
        kv = None if lens is None else torch.tensor(lens, device=dev)
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        out, lse = flash_attention(*leaves, kv, causal)
        got = torch.autograd.grad(out, leaves, g)
        want = flash_attention_backward_reference(
            q, k, v, kv, out.detach(), lse, g, causal, d ** -0.5)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-4)
        if lens is not None:
            assert bool((got[1][1, :, lens[1]:] == 0).all())
    assert mt.launch_counts() == {"flash_fwd": 9, "flash_bwd_dq": 3,
                                  "flash_bwd_dkv": 3, "paged_attention": 1}

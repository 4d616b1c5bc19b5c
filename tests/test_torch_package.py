"""Guards of the PyTorch/CUDA port (``ml_trainer_tpu_torch``).

* No file of the port, nor ``chip_smoke.py``,
  ``scripts/torch_call_check_mutations.py``, ``scripts/flash_bwd_ab.py``,
  ``scripts/flash_fwd_ab.py`` or ``scripts/cudnn_deterministic_cost.py``,
  imports JAX, flax, optax, tqdm,
  msgpack or the JAX package (an AST scan): the card's machine has none
  of them.
* With no card visible, every entry point raises unless it is given
  ``device="cpu"``: the port never falls back to the CPU on its own.
* On the CPU the kernels' plain versions run, and the launch counters
  stay at 0; a checkpoint is written and resumed with the card hidden.
* ``test_kernels_match_plain_on_card`` and the bf16 kernel tests need an
  NVIDIA card and ``nvcc`` (marker ``cuda``); they skip elsewhere,
  deciding inside the test.
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
    int8_matmul,
    paged_attention,
    paged_attention_reference,
    quantize_per_channel,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_trainer_tpu", "tqdm",
             "msgpack")


def _port_files():
    files = sorted((ROOT / "ml_trainer_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "scripts" / "torch_call_check_mutations.py",
                    ROOT / "scripts" / "flash_bwd_ab.py",
                    ROOT / "scripts" / "flash_fwd_ab.py",
                    ROOT / "scripts" / "cudnn_deterministic_cost.py"]


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


# The modules of the image and encoder families and the CIFAR-10 input
# path: each exists and imports nothing of JAX or the JAX package.
NEW_MODULES = ["models/mlmodel.py", "models/resnet.py", "models/bert.py",
               "models/vit.py", "models/layers.py", "data/transforms.py",
               "data/datasets.py", "utils/functions.py", "convert.py",
               "trainer.py", "train_state.py", "checkpoint/__init__.py",
               "checkpoint/checkpoint.py", "resilience/__init__.py",
               "resilience/faults.py", "data/native.py", "data/sharded.py",
               "data/text.py", "data/tokenizers.py", "ops/losses.py",
               "models/llama.py", "cli.py", "__main__.py",
               "utils/profiler.py", "lora.py", "serving/adapter_pool.py",
               "checkpoint/torch_export.py", "serving/engine.py",
               "serving/api.py", "ops/optimizers.py", "models/gpt2.py"]


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_family_modules_never_import_jax(rel):
    path = ROOT / "ml_trainer_tpu_torch" / rel
    assert path in _port_files()
    bad = [name for name in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert bad == []


@pytest.mark.parametrize("name,kw", [
    ("mlmodel", {}), ("resnet18", {}), ("resnet50", {}), ("bert_tiny", {}),
    ("vit_tiny", {}), ("vit_b16", {"dtype": torch.float32, "depth": 1}),
    ("llama_tiny", {}),
])
def test_family_constructors_raise_without_a_card(monkeypatch, name, kw):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.get_model(name, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.init_model(name, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.Trainer(name)
    assert mt.init_model(name, device="cpu", **kw).training


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


def test_launch_counters_stay_zero_on_cpu(monkeypatch, tmp_path):
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
    # A resume, with the card hidden: checkpoints touch no CUDA call.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    resumed = mt.Trainer(model, datasets=sets, epochs=2, batch_size=4,
                         grad_accum_steps=2, device="cpu",
                         model_dir=str(tmp_path))
    resumed.fit(resume=True)
    assert resumed.history["epochs"] == [1, 2]
    with mt.Server(model, kv_page_size=16, paged_kernel=True,
                   quant_int8=True, device="cpu") as server:
        assert server.complete([1, 2, 3], 4, timeout=120).shape == (7,)
    assert mt.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                  "flash_bwd_dkv": 0, "paged_attention": 0,
                                  "int8_matmul": 0, "unscale_sqsum": 0,
                                  "fused_adam": 0}


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the card (float32,
    atol 1e-4 forward: the kernel sums in another order; K7 within
    1e-5 of max|y|).  K1 also past B*H = 65535 (the grid puts B*H on
    its x axis) and bitwise across two calls (no atomics); K6 also on
    one full 1024-position row (split over 32 blocks per head), and K6
    and K7 bitwise across two calls (their split merge adds in a fixed
    order)."""
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
    q, k, v = (torch.randn(2731, 24, 16, 64, generator=gen).to(dev)
               for _ in range(3))  # B*H = 65,544
    out, lse = flash_attention(q, k, v, None, True)
    ref_out, ref_lse = flash_attention_reference(q, k, v, None, True)
    torch.testing.assert_close(out, ref_out, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    again = flash_attention(q, k, v, None, True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    del q, k, v, out, lse, ref_out, ref_lse, again
    for b, h, d, ps, P, lens in ((4, 3, 64, 16, 8, [128, 1, 17, 1]),
                                 (1, 12, 64, 16, 64, [1024])):
        n = b * P + 1
        q = torch.randn(b, h, d, generator=gen).to(dev)
        kp, vp = (torch.randn(n, h, ps, d, generator=gen).to(dev)
                  for _ in range(2))
        table = (1 + torch.randperm(n - 1, generator=gen)).reshape(b, P)
        if b > 1:
            table[3] = 0
        table = table.to(torch.int32).to(dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = paged_attention(q, kp, vp, table, lengths)
        ref = paged_attention_reference(q, kp, vp, table, lengths)
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
        assert torch.equal(out, paged_attention(q, kp, vp, table, lengths))
    # K2/K3 through the autograd Function against the plain backward
    # (atol 2e-4, rtol 1e-4: 3xTF32 products, float32 sums over up to S
    # keys or queries); no atomics, so a second backward is bitwise equal.
    for s, d, lens, causal in ((256, 64, None, True), (192, 128, [100, 1],
                                                     False),
                               (100, 64, [60, 100], True)):
        q, k, v, g = (torch.randn(2, 3, s, d, generator=gen).to(dev)
                      for _ in range(4))
        kv = None if lens is None else torch.tensor(lens, device=dev)
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        out, lse = flash_attention(*leaves, kv, causal)
        got = torch.autograd.grad(out, leaves, g, retain_graph=True)
        again = torch.autograd.grad(out, leaves, g)
        want = flash_attention_backward_reference(
            q, k, v, kv, out.detach(), lse, g, causal, d ** -0.5)
        for a, b, c in zip(got, want, again):
            torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-4)
            assert torch.equal(a, c)
        if lens is not None:
            assert bool((got[1][1, :, lens[1]:] == 0).all())
    # K7 (int8 matmul) within 1e-5 of max|y| of its plain version (f32
    # sums over K in another order): a decode shape, and ragged M, N
    # (not a multiple of 4: byte loads) and K.
    for m, k, n in ((8, 768, 2304), (13, 130, 99)):
        x = torch.randn(m, k, generator=gen).to(dev)
        w_q, scale = quantize_per_channel(
            (torch.randn(k, n, generator=gen) * 0.02).to(dev))
        bias = torch.randn(n, generator=gen).to(dev)
        got = int8_matmul(x, w_q, scale, bias=bias)
        want = int8_matmul(x, w_q, scale, bias=bias,
                           implementation="reference")
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())
        assert torch.equal(got, int8_matmul(x, w_q, scale, bias=bias))
    assert mt.launch_counts() == {"flash_fwd": 11, "flash_bwd_dq": 6,
                                  "flash_bwd_dkv": 6, "paged_attention": 4,
                                  "int8_matmul": 4, "unscale_sqsum": 0,
                                  "fused_adam": 0}


def bf16_steps(got, want):
    """Element by element, the bf16 steps between two bf16 tensors (+0
    and -0 equal)."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(got) - ordered(want)).abs()


@pytest.mark.cuda
def test_bf16_kernels_match_plain_on_card():
    """K1-K3's bf16 entry points against their plain versions on the same
    bf16 inputs (within 2 bf16 ulps: |diff| <= 2^-7 |plain| + 1e-3
    max|plain|; lse, float32, within 1e-4), bf16 outputs and gradients,
    exact zeros past kv_lens, bitwise across two calls, and K1's output
    within one bf16 step of what the float32 kernel gives on the widened
    values (or within 1e-3 of its largest entry: the bf16 kernel splits
    P in two bf16 terms where the float32 kernel takes 3xTF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA) and nvcc")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    mt.reset_launch_counts()

    def gate(got, want):
        got, want = got.float(), want.float()
        bar = 2 ** -7 * want.abs() + 1e-3 * want.abs().max()
        assert bool(((got - want).abs() <= bar).all())

    for s, d, lens, causal in ((256, 64, None, True), (192, 128, [100, 1],
                                                     False),
                               (100, 64, [60, 100], True)):
        q, k, v, g = (torch.randn(2, 3, s, d, generator=gen).to(dev)
                      .to(torch.bfloat16) for _ in range(4))
        kv = None if lens is None else torch.tensor(lens, device=dev)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out, lse = flash_attention(*leaves, kv, causal)
        got = torch.autograd.grad(out, leaves, g, retain_graph=True)
        again = torch.autograd.grad(out, leaves, g)
        ref_out, ref_lse = flash_attention_reference(q, k, v, kv, causal)
        want = flash_attention_backward_reference(
            q, k, v, kv, out.detach(), lse, g, causal, d ** -0.5)
        assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
        gate(out, ref_out)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
        wide, _ = flash_attention(q.float(), k.float(), v.float(), kv, causal)
        wide = wide.to(torch.bfloat16)
        far = ((out.detach().float() - wide.float()).abs()
               > 1e-3 * wide.float().abs().max())
        steps = bf16_steps(out.detach(), wide)[far]
        assert steps.numel() == 0 or int(steps.max()) <= 1
        for a, b, c in zip(got, want, again):
            assert a.dtype == torch.bfloat16
            gate(a, b)
            assert torch.equal(a, c)
        if lens is not None:
            assert bool((got[1][1, :, lens[1]:] == 0).all())
            assert bool((got[2][1, :, lens[1]:] == 0).all())
    counts = mt.launch_counts()
    assert (counts["flash_fwd"], counts["flash_bwd_dq"],
            counts["flash_bwd_dkv"]) == (6, 6, 6)


@pytest.mark.cuda
def test_bf16_decode_kernels_match_plain_on_card():
    """K6 and K7's bf16 entry points against their plain versions on the
    same bf16 inputs (within 2 bf16 ulps), bf16 outputs, bitwise across
    two calls: K6 at rows of 1 to 8 and of 16 splits (a thread block
    cluster per row), with a length-1 row and an all-trash row; K7 at a
    decode shape and a ragged one, the bias added with two roundings."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA) and nvcc")
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(2)
    mt.reset_launch_counts()

    def gate(got, want):
        assert got.dtype == bf
        got, want = got.float(), want.float()
        bar = 2 ** -7 * want.abs() + 1e-3 * want.abs().max()
        assert bool(((got - want).abs() <= bar).all())

    for b, h, d, ps, P, lens in ((4, 3, 64, 16, 8, [128, 1, 17, 1]),
                                 (2, 12, 32, 16, 64, [1024, 300]),
                                 (1, 8, 128, 16, 128, [2048])):
        n = b * P + 1
        q = torch.randn(b, h, d, generator=gen).to(dev, bf)
        kp, vp = (torch.randn(n, h, ps, d, generator=gen).to(dev, bf)
                  for _ in range(2))
        table = (1 + torch.randperm(n - 1, generator=gen)).reshape(b, P)
        if b > 3:
            table[3] = 0
        table = table.to(torch.int32).to(dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = paged_attention(q, kp, vp, table, lengths)
        gate(out, paged_attention_reference(q, kp, vp, table, lengths))
        assert torch.equal(out, paged_attention(q, kp, vp, table, lengths))
    for m, k, n in ((8, 768, 2304), (13, 130, 99)):
        x = torch.randn(m, k, generator=gen).to(dev, bf)
        w_q, scale = quantize_per_channel(
            (torch.randn(k, n, generator=gen) * 0.02).to(dev))
        bias = torch.randn(n, generator=gen).to(dev)
        got = int8_matmul(x, w_q, scale, bias=bias)
        gate(got, int8_matmul(x, w_q, scale, bias=bias,
                              implementation="reference"))
        assert torch.equal(got, int8_matmul(x, w_q, scale, bias=bias))
    counts = mt.launch_counts()
    assert (counts["paged_attention"], counts["int8_matmul"]) == (6, 4)

"""Port parity for int8 serving: the port's quantization, int8 matmul,
quant collection, int8 forward and ``Server(quant_int8=True)`` against
the JAX package's, on the CPU, plus the reference's quality gate.

* ``quantize_per_channel`` and ``quantize_tree`` are bitwise the JAX
  package's (all-zero columns, exact .5 steps round half to even).
* ``int8_matmul`` on the CPU (its plain version) agrees with the JAX
  ``int8_matmul`` through its reference and its Pallas kernel in
  interpret mode within 1e-5 of max|y| (f32 sums in another order).
* Full-forward int8 logits agree with the JAX
  ``model.clone(quant_int8=True)`` within 1e-5; greedy int8 ``Server``
  tokens are identical to the JAX int8 ``Server``'s; two port runs give
  the same bytes; only the S == 1 decode step reads the collection.
* In bfloat16 (a bf16 model's decode step) the plain version is bitwise
  the JAX ``int8_matmul`` (Pallas, interpret mode) followed by the JAX
  layer's ``+ b.astype(bf16)``: the scaled f32 sum rounded to bf16, then
  the bf16 bias added in bf16.  Fusing the bias in f32 and rounding once
  differs (pinned, so that the order stays the JAX package's).
* The CUDA kernel's split of K over blocks, emulated in float32 on the
  CPU (``_split_sum``: per-slice f32 partial sums, their sum in slice
  order, then the scale, then the bias), agrees with the plain version
  and the JAX kernel within 1e-5 of max|y| at K = 130 and K = 3072.
* Quality gate (``tests/test_kernels.py::test_int8_quality_gate``):
  gpt2_tiny trained by the JAX ``Trainer`` on a successor map, then
  converted; the port's int8 forward keeps argmax agreement >= 0.995
  and relative logit error <= 0.02 against its fp32 forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_trainer_tpu.models import get_model as j_get_model
from ml_trainer_tpu.ops.kernels.int8_matmul import (
    int8_matmul as j_int8_matmul,
    quantize_per_channel as j_quantize_per_channel,
    quantize_tree as j_quantize_tree,
)
from ml_trainer_tpu.serving import Server as JServer
from ml_trainer_tpu_torch import (
    Server,
    get_model,
    int8_matmul,
    params_from_jax,
    quant_from_jax,
    quantize_per_channel,
    quantize_tree,
)
from ml_trainer_tpu_torch.ops.kernels import _build
from ml_trainer_tpu_torch.ops.kernels.int8_matmul import (
    _int8_kernel,
    check_kernel_inputs,
    int8_matmul_reference,
    k_slice,
)
from ml_trainer_tpu_torch.serving import SlotDecodeEngine

MAX_LEN = 64
REL = 1e-5  # int8 matmul / logits: of max|y|, f32 sums in another order


@pytest.fixture(scope="module")
def models():
    j_model = j_get_model("gpt2_tiny", max_len=MAX_LEN)
    variables = j_model.init({"params": jax.random.PRNGKey(2)},
                             np.zeros((1, 8), np.int32), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    t_model = get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu")
    t_model.load_state_dict(params_from_jax(params))
    return j_model, variables, t_model


def _flat(tree, prefix=""):
    """Nested dict -> {path: numpy leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _port_paths(quant):
    """The port's collection keyed by the JAX package's paths."""
    return {f"block{path.split('/', 2)[1]}/{path.split('/', 2)[2]}": v
            for path, v in _flat(quant).items()}


def _assert_bits(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _weights(seed, k, n):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    w[:, 0] = 0.0  # all-zero column: scale 1
    # amax 254 -> scale exactly 2: w / scale hits .5, 1.5, 2.5 exactly.
    w[:, 1] = 0.0
    w[:6, 1] = [1.0, 3.0, 5.0, -5.0, -1.0, 254.0]
    # amax 127 -> scale exactly 1: halves round half to even.
    w[:, 2] = 0.0
    w[:5, 2] = [0.5, 1.5, 2.5, -2.5, 127.0]
    return w


@pytest.mark.parametrize("seed,k,n", [(0, 32, 48), (1, 130, 100),
                                      (2, 7, 3)])
def test_quantize_per_channel_is_bitwise_the_jax_one(seed, k, n):
    w = _weights(seed, k, n)
    jw, js = j_quantize_per_channel(jnp.asarray(w))
    tw, ts = quantize_per_channel(torch.from_numpy(w))
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0] == 1.0 and ts[1] == 2.0 and ts[2] == 1.0
    assert tw[:5, 2].tolist() == [0, 2, 2, -2, 127]
    assert tw[:6, 1].tolist() == [0, 2, 2, -2, 0, 127]


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("m,k,n", [(4, 32, 48), (13, 130, 100),
                                   (1, 256, 1024)])
def test_int8_matmul_matches_jax(impl, m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w_q, scale = j_quantize_per_channel(jnp.asarray(_weights(m, k, n)))
    kw = dict(interpret=True) if impl == "pallas" else {}
    want = np.asarray(j_int8_matmul(jnp.asarray(x), w_q, scale,
                                    implementation=impl, **kw))
    tw = torch.from_numpy(np.array(w_q))
    ts = torch.from_numpy(np.array(scale))
    got = int8_matmul(torch.from_numpy(x), tw, ts)
    tol = REL * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # [B, S, K] inputs and the fused bias: the JAX layer's y + b.
    b = rng.normal(size=(n,)).astype(np.float32)
    got_b = int8_matmul(torch.from_numpy(x)[None], tw, ts,
                        bias=torch.from_numpy(b))
    assert got_b.shape == (1, m, n)
    np.testing.assert_allclose(got_b[0].numpy(), want + b, rtol=0,
                               atol=tol + REL * np.abs(b).max())


def test_int8_matmul_refusals():
    x = torch.zeros(2, 8)
    w = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="int8"):
        int8_matmul(x, w, torch.ones(4))
    w_q = w.to(torch.int8)
    with pytest.raises(ValueError, match="implementation"):
        int8_matmul(x, w_q, torch.ones(4), implementation="pallas")
    with pytest.raises(ValueError, match="contract"):
        int8_matmul(torch.zeros(2, 5), w_q, torch.ones(4))
    assert torch.equal(
        int8_matmul(x, w_q, torch.ones(4), implementation="reference"),
        torch.zeros(2, 4))


def _bf16_operands(m, k, n):
    """bf16 x (numpy f32 copy for JAX, torch bf16), the JAX-quantized
    weights and scales, and an f32 bias, from one seed."""
    rng = np.random.default_rng(m * k + n + 7)
    x = rng.normal(size=(m, k)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    w_q, scale = j_quantize_per_channel(jnp.asarray(_weights(m, k, n)))
    b = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    tx = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    tw, ts = torch.from_numpy(np.array(w_q)), torch.from_numpy(np.array(scale))
    return xb, w_q, scale, b, tx, tw, ts


@pytest.mark.parametrize("m,k,n", [(4, 32, 48), (13, 130, 100),
                                   (8, 768, 2304)])
def test_int8_bf16_plain_is_bitwise_jax_then_bias(m, k, n):
    """JAX's ``_quant_dense`` in bf16: ``int8_matmul(x, w, s)`` (its Pallas
    kernel, interpret mode) in x's dtype, then ``+ b.astype(y.dtype)``."""
    xb, w_q, scale, b, tx, tw, ts = _bf16_operands(m, k, n)
    y = j_int8_matmul(xb, w_q, scale, implementation="pallas", interpret=True)
    assert y.dtype == jnp.bfloat16
    want = np.asarray((y + jnp.asarray(b).astype(y.dtype)).astype(jnp.float32))
    got = int8_matmul(tx, tw, ts, bias=torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    no_bias = int8_matmul(tx, tw, ts)
    np.testing.assert_array_equal(no_bias.float().numpy(),
                                  np.asarray(y.astype(jnp.float32)))


def test_int8_bf16_fused_f32_bias_differs_from_jax():
    """The old order (bias fused in f32, one rounding to bf16) is another
    function at the qkv shape: thousands of entries one bf16 ulp off."""
    xb, w_q, scale, b, tx, tw, ts = _bf16_operands(8, 768, 2304)
    y = j_int8_matmul(xb, w_q, scale, implementation="pallas", interpret=True)
    want = np.asarray((y + jnp.asarray(b).astype(y.dtype)).astype(jnp.float32))
    fused = ((tx.float() @ tw.float()) * ts + torch.from_numpy(b)).to(
        torch.bfloat16)
    assert (fused.float().numpy() != want).sum() > 1000


def test_int8_kernel_checks_and_no_fallback(monkeypatch):
    """The CUDA path's checks run before any load: float32 or bf16 x, f32
    scale and bias; a bf16 x launches ``int8_matmul_bf16`` into a bf16
    output, and a refused launch raises (no plain fallback)."""
    _, _, _, b, tx, tw, ts = _bf16_operands(8, 768, 2304)
    tb = torch.from_numpy(b)
    assert check_kernel_inputs(tx, tw, ts, tb) == "bf16"
    assert check_kernel_inputs(tx.float(), tw, ts, tb) == "f32"
    with pytest.raises(TypeError, match="float32 or bfloat16 x"):
        check_kernel_inputs(tx.half(), tw, ts, tb)
    with pytest.raises(ValueError, match="bias must be float32"):
        check_kernel_inputs(tx, tw, ts, tb.to(torch.bfloat16))

    class _Stream:
        cuda_stream = 0

    calls, status = [], [0]

    class _Lib:
        def __getattr__(self, fn):
            return lambda *args: calls.append((fn, args)) or status[0]

    loads = []
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name)
                        or _Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream)
    out = _int8_kernel(tx[None], tw, ts, tb)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 8, 2304)
    (fn, args), = calls
    assert fn == "int8_matmul_bf16" and args[5:9] == (8, 768, 2304, 256)
    status[0] = 701
    with pytest.raises(RuntimeError, match="int8_matmul_bf16"):
        _int8_kernel(tx, tw, ts, tb)
    loads.clear()
    with pytest.raises(TypeError):
        _int8_kernel(tx.half(), tw, ts, tb)
    assert loads == []


def _split_sum(x, w_q, scale, bias, slice_k):
    """The CUDA kernel's split of K in float32 (test-only): one f32
    partial sum per slice of ``slice_k`` rows, the partials added in slice
    order, then the column scale, then the bias."""
    k = w_q.shape[0]
    total = torch.zeros(x.shape[0], w_q.shape[1])
    for k0 in range(0, k, slice_k):
        total = total + x[:, k0:k0 + slice_k] @ w_q[k0:k0 + slice_k].float()
    return total * scale + bias


@pytest.mark.parametrize("m,k,n", [(13, 130, 100), (8, 3072, 768)])
@pytest.mark.parametrize("slice_k", [64, 512, None])
def test_split_sum_matches_plain_and_jax(m, k, n, slice_k):
    """Ragged K = 130 (3 slices of 64, the last of 2 rows) and fc_out's
    K = 3072 (8 slices of 384 at the wrapper's choice)."""
    slice_k = slice_k or k_slice(k, n)
    rng = np.random.default_rng(k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(n,)) * 0.02).astype(np.float32)
    w_q, scale = j_quantize_per_channel(jnp.asarray(_weights(m, k, n)))
    tx, tw, ts, tb = (torch.from_numpy(np.array(a)) for a in (x, w_q, scale, b))
    got = _split_sum(tx, tw, ts, tb, slice_k).numpy()
    plain = int8_matmul_reference(tx, tw, ts, tb).numpy()
    jax_y = np.asarray(j_int8_matmul(jnp.asarray(x), w_q, scale,
                                     implementation="pallas",
                                     interpret=True)) + b
    tol = REL * np.abs(plain).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=tol)
    np.testing.assert_allclose(got, jax_y, rtol=0, atol=tol)
    assert (got[:, 0] == b[0]).all()  # the all-zero column: bias only


def test_k_slice_rule():
    """K over min(8, ceil(K / 256), 264 // column tiles) slices (the
    cluster of a column tile; two blocks per SM at most), each a multiple
    of 64 rows: 3 slices of 256 at qkv and proj, 2 of 384 at fc_in (96
    tiles), 8 of 384 at fc_out, one slice for a short K or a wide N, and
    slices past 512 rows (staged in chunks) once K passes 8 x 512."""
    for k, n, want in ((768, 2304, 256), (768, 768, 256), (768, 3072, 384),
                       (3072, 768, 384), (130, 100, 192), (256, 1024, 256),
                       (768, 32 * 264, 768), (1, 100, 64), (5000, 100, 640)):
        sl = k_slice(k, n)
        assert sl == want and sl % 64 == 0
        assert -(-k // sl) <= 8


def test_quantize_tree_is_bitwise_the_jax_one(models):
    _, variables, t_model = models
    want = j_quantize_tree(variables["params"])
    got = quantize_tree(t_model)
    _assert_bits(_port_paths(got), _flat(want))
    crossed = quant_from_jax(jax.tree.map(np.asarray, want))
    _assert_bits(_flat(crossed), _flat(got))
    assert quantize_tree(t_model, targets=("nope",)) == {}
    with pytest.raises(TypeError):
        quantize_tree({"qkv": 1})


@pytest.mark.parametrize("b,n", [(2, 24), (1, 64)])
def test_int8_full_forward_logits_match_jax(models, b, n):
    j_model, variables, t_model = models
    ids = np.random.default_rng(n).integers(0, 1024, (b, n)).astype(np.int32)
    jquant = j_quantize_tree(variables["params"])
    want = np.asarray(j_model.clone(quant_int8=True).apply(
        {"params": variables["params"], "quant": jquant}, ids, train=False))
    with torch.no_grad():
        got = t_model(torch.from_numpy(ids).long(),
                      quant=quantize_tree(t_model)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())


def _prompts():
    """The prompts of tests/test_torch_serving.py."""
    rng = np.random.default_rng(0)
    out = [rng.integers(0, 1024, n).astype(np.int32) for n in (5, 40, 12, 7)]
    out.append(np.concatenate([out[1][:32],
                               rng.integers(0, 1024, 9).astype(np.int32)]))
    return out


def _serve(server, prompts, n=10, sampled=()):
    streams = [server.submit(p, n, temperature=0.9 if i in sampled else 0.0,
                             rng=31 + i) for i, p in enumerate(prompts)]
    return [np.asarray(s.result(timeout=300)) for s in streams], streams


def test_int8_server_matches_jax_server(models):
    j_model, variables, t_model = models
    prompts = _prompts()
    with JServer(j_model, variables, max_batch=4, kv_page_size=16,
                 paged_kernel=True, quant_int8=True) as js:
        want, _ = _serve(js, prompts)
    with Server(t_model, max_batch=4, kv_page_size=16, paged_kernel=True,
                quant_int8=True, device="cpu") as ts:
        got, streams = _serve(ts, prompts)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert streams[-1].request.prefix_hit_tokens == 32


def test_int8_server_is_deterministic_and_decode_only(models):
    """Two identical runs (one request sampled) stream the same bytes,
    and the model sees the collection on every S == 1 decode step and on
    no prefill (both prefills stay fp32, as in the reference)."""
    _, _, t_model = models
    prompts = _prompts()
    calls = []
    forward = t_model.forward

    def spy(ids, cache=None, select=None, quant=None, **kw):
        calls.append((ids.shape[1], quant is not None))
        return forward(ids, cache, select, quant=quant, **kw)

    runs = []
    t_model.forward = spy
    try:
        for _ in range(2):
            with Server(t_model, max_batch=3, kv_page_size=16,
                        paged_kernel=True, quant_int8=True,
                        device="cpu") as s:
                runs.append(_serve(s, prompts, n=9, sampled=(2,))[0])
    finally:
        del t_model.forward
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert {(s > 1, q) for s, q in calls} == {(True, False), (False, True)}


def test_int8_refusals(models, monkeypatch):
    _, _, t_model = models
    with pytest.raises(ValueError, match="quant_int8 with spec_k"):
        SlotDecodeEngine(t_model, kv_page_size=16, quant_int8=True,
                         spec_k=2, device="cpu")
    with pytest.raises(ValueError, match="quant_int8 with adapters"):
        Server(t_model, kv_page_size=16, quant_int8=True,
               adapters={"rank": 4}, device="cpu")
    # Without quant_int8 the same knobs are refused as not ported.
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SlotDecodeEngine(t_model, spec_k=2, device="cpu")
    # A model with no quantizable projection is refused, never served
    # un-quantized.
    import ml_trainer_tpu_torch.serving.engine as engine

    monkeypatch.setattr(engine, "quantize_tree", lambda model: {})
    with pytest.raises(ValueError, match="no quantizable projections"):
        SlotDecodeEngine(t_model, quant_int8=True, device="cpu")


def test_int8_quality_gate(tmp_path):
    """The reference's gate on a model with real top-1 margins: random
    next-token targets leave logits near-tied, which measures
    tie-breaking, not the quantization."""
    from ml_trainer_tpu import Trainer
    from ml_trainer_tpu.data.datasets import ArrayDataset

    rng = np.random.default_rng(0)
    V, S, N = 64, 32, 64
    succ = rng.permutation(V)
    data = np.zeros((N, S), np.int32)
    data[:, 0] = rng.integers(0, V, N)
    for t in range(1, S):
        data[:, t] = succ[data[:, t - 1]]
    j_model = j_get_model("gpt2_tiny", vocab_size=V)
    trainer = Trainer(
        j_model,
        datasets=(ArrayDataset(data, np.roll(data, -1, axis=1), None),) * 2,
        model_dir=str(tmp_path / "q"), epochs=4, batch_size=16, seed=3,
        lr=0.01, optimizer="adamw", metric=None, backend="cpu",
    )
    trainer.fit()
    t_model = get_model("gpt2_tiny", vocab_size=V, device="cpu")
    t_model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, trainer.state.params)))
    toks = torch.from_numpy(data[:8]).long()
    with torch.no_grad():
        lf = t_model(toks)
        lq = t_model(toks, quant=quantize_tree(t_model))
    agreement = (lf.argmax(-1) == lq.argmax(-1)).float().mean().item()
    rel_err = ((lf - lq).abs().max() / lf.abs().max()).item()
    assert agreement >= 0.995, f"argmax agreement {agreement}"
    assert rel_err <= 0.02, f"relative logit error {rel_err}"

"""Chip smoke for the PyTorch/CUDA port (``ml_trainer_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --only kernels  # build + kernel checks only
    python3 chip_smoke.py --only train    # kernel checks + training only

Phases, one line of output each (or a few):

1. device: the card's name and ``nvidia-smi``'s name and power limit;
2. build: every CUDA kernel source in ``ml_trainer_tpu_torch/csrc/``
   with ``nvcc`` for sm_90a (one process per source, started together),
   with the build seconds and the ``-Xptxas -v`` lines;
3. kernels vs plain, each timed with CUDA events beside its plain
   version, one PyTorch library call where one exists, and its bound:
   the flash-attention forward (K1) on [1, 12, S, 64] float32 (causal,
   S in 128/512/1024, plus a kv_lens case) and the paged-attention decode
   (K6) on B=8, H=12, D=64, page 16, 64 pages per row, 513 pool pages,
   ragged lengths and an all-trash row, each within 1e-4 absolute of its
   plain version; the flash backward, K2 (dQ) and K3 (dK/dV), on
   [8, 12, 1024, 64] causal (the main row), the same non-causal with
   kv_lens, and [2, 8, 1024, 128] causal, within atol 2e-4 / rtol 1e-4
   of the plain backward, with exact-zero dK/dV past kv_lens, plus the
   padded path's gradients (S 1000, head_dim 48) through
   ``attention(implementation="flash")`` against the plain attention;
4. serving: GPT-2 124M at full width (12 layers, 768 wide, 12 heads,
   vocab 50257, max_len 1024) with seeded random weights behind
   ``Server(max_batch=8, kv_page_size=16, paged_kernel=True)``; 8 greedy
   requests of 32 new tokens, prompts of 5..900 tokens, two sharing a
   256-token prefix.  Checks that all complete, that both kernels'
   launch counters advanced as the path requires, and that every served
   token is within 1e-3 of the best logit when the sequence is run
   again through the plain attention path;
5. training: the same model, fp32, through ``Trainer(...).fit()`` with
   the real config of examples/04_gpt2_pretrain.py (seq 1024, batch 8 in
   4 microbatches, adamw, cosine restarts, clip 1.0), 6 optimizer steps
   and 2 validation batches.  First the kernel path's loss and every
   parameter gradient on one microbatch against the plain attention
   path; then the run, which must give finite losses, skip no step and
   launch K1 12 x (24 microbatches + 2 validation batches) times and K2
   and K3 12 x 24 times; then the optimizer-step time (CUDA events),
   tokens/s, peak memory and a profiler split of one step.

The counters are set to 0 just before the serving run and the training
run and read just after each; a kernel's ``launches`` in the JSON record
is the sum over the two runs.  The second-to-last line is the kernels'
JSON record; the last line is ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero and prints no ok line.  Exits non-zero at once
without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TOL = 1e-4
BWD_ATOL, BWD_RTOL = 2e-4, 1e-4  # K2/K3 vs the plain backward (float32)
LOGIT_SLACK = 1e-3
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------- phase 3
def check_flash(dev):
    import torch
    import torch.nn.functional as F

    from ml_trainer_tpu_torch.ops.attention import (
        flash_attention, flash_attention_reference)

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    rows = []
    cases = [(128, None), (512, None), (1024, None), (1024, 700)]
    for s, kv_len in cases:
        q, k, v = (torch.randn(1, 12, s, 64, generator=gen).to(dev)
                   for _ in range(3))
        lens = None if kv_len is None else torch.tensor(
            [kv_len], dtype=torch.int32, device=dev)
        out, lse = flash_attention(q, k, v, lens, True)
        ref_out, ref_lse = flash_attention_reference(q, k, v, lens, True)
        torch.cuda.synchronize()
        err = max((out - ref_out).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        if not err <= TOL:
            raise AssertionError(
                f"flash_fwd S={s} kv_len={kv_len}: max abs err {err} > {TOL}")
        ms = time_ms(lambda: flash_attention(q, k, v, lens, True))
        plain = time_ms(lambda: flash_attention_reference(q, k, v, lens, True))
        if lens is None:
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True))
        else:
            keep = (torch.arange(s, device=dev)[None, :]
                    <= torch.arange(s, device=dev)[:, None]) & (
                torch.arange(s, device=dev)[None, :] < kv_len)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=keep))
        live = min(s, kv_len or s)
        # Kept (query, key) pairs per head under the causal + kv_lens mask.
        pairs = sum(min(i + 1, live) for i in range(s))
        nbytes = 4 * 12 * s * 64 * 4 + 12 * s * 4
        flops = 4.0 * pairs * 64 * 12
        b_ms, b_by = bound_ms(nbytes, flops)
        row = dict(S=s, kv_len=kv_len, max_abs_err=err, ms=ms, plain_ms=plain,
                   library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        log("kernel flash_fwd " + json.dumps(row))
        rows.append(row)
    return rows


def bwd_case(dev, b, h, s, d, lens, seed):
    """q, k, v, kv_lens (or None) and the output cotangent, seeded."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, dout = (torch.randn(b, h, s, d, generator=gen).to(dev)
                     for _ in range(4))
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    return q, k, v, kv, dout


def kept_pairs(b: int, s: int, causal: bool, lens) -> int:
    """Kept (query, key) pairs summed over the batch, per head."""
    total = 0
    for n in (lens or [s] * b):
        live = min(s, n)
        total += (sum(min(i + 1, live) for i in range(s)) if causal
                  else s * live)
    return total


BWD_CASES = [  # (name, b, h, s, d, causal, kv_lens); the first is the main
    ("main", 8, 12, 1024, 64, True, None),
    ("kv_lens", 8, 12, 1024, 64, False,
     [1024, 700, 1, 513, 64, 1000, 257, 900]),
    ("d128", 2, 8, 1024, 128, True, None),
]
PADDED_CASE = (2, 4, 1000, 48)  # off-tile S and head_dim


def check_flash_bwd(dev):
    """K2 (dQ) and K3 (dK/dV) against the plain backward on the same
    inputs (out and lse from the plain forward), then the padded path's
    gradients through ``attention(implementation="flash")`` against
    autograd of the plain attention path."""
    import torch
    import torch.nn.functional as F

    from ml_trainer_tpu_torch.ops.attention import (
        attention, flash_attention_backward_reference,
        flash_attention_reference, flash_bwd_dkv, flash_bwd_dq)

    rows = []
    for i, (name, b, h, s, d, causal, lens) in enumerate(BWD_CASES):
        q, k, v, kv, dout = bwd_case(dev, b, h, s, d, lens, SEED + 10 + i)
        scale = d ** -0.5
        out, lse = flash_attention_reference(q, k, v, kv, causal, scale)
        delta = (dout * out).sum(-1).contiguous()
        dq = flash_bwd_dq(q, k, v, kv, lse, delta, dout, causal, scale)
        dk, dv = flash_bwd_dkv(q, k, v, kv, lse, delta, dout, causal, scale)
        want = flash_attention_backward_reference(q, k, v, kv, out, lse,
                                                  dout, causal, scale)
        torch.cuda.synchronize()
        errs = {}
        for nm, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            errs[nm] = (got - ref).abs().max().item()
            torch.testing.assert_close(got, ref, atol=BWD_ATOL, rtol=BWD_RTOL,
                                       msg=lambda m: f"{name} {nm}: {m}")
        if lens is not None:
            pad = (torch.arange(s, device=dev)[None, None, :, None]
                   >= kv.long()[:, None, None, None]).expand_as(dk)
            if not (bool((dk[pad] == 0).all()) and bool((dv[pad] == 0).all())):
                raise AssertionError(f"{name}: dK/dV past kv_lens not zero")
        ms_dq = time_ms(lambda: flash_bwd_dq(q, k, v, kv, lse, delta, dout,
                                             causal, scale))
        ms_dkv = time_ms(lambda: flash_bwd_dkv(q, k, v, kv, lse, delta, dout,
                                               causal, scale))
        plain = time_ms(lambda: flash_attention_backward_reference(
            q, k, v, kv, out, lse, dout, causal, scale), iters=10)
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        if kv is None:
            o_lib = F.scaled_dot_product_attention(qg, kg, vg,
                                                   is_causal=causal)
        else:
            keep = (torch.arange(s, device=dev)[None, :]
                    < kv.long()[:, None])[:, None, None, :]
            o_lib = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
        lib = time_ms(lambda: torch.autograd.grad(
            o_lib, (qg, kg, vg), dout, retain_graph=True), iters=10)
        pairs = kept_pairs(b, s, causal, lens) * h
        arr = b * h * s * d * 4
        rows_b = b * h * s * 4
        b_dq = bound_ms(4 * arr + 2 * rows_b + arr, 3.0 * 2 * d * pairs)
        b_dkv = bound_ms(4 * arr + 2 * rows_b + 2 * arr,
                         4.0 * 2 * d * pairs)
        for kname, ms, bnd, err in (
                ("flash_bwd_dq", ms_dq, b_dq, errs["dq"]),
                ("flash_bwd_dkv", ms_dkv, b_dkv, max(errs["dk"],
                                                     errs["dv"]))):
            row = dict(case=name, shape=[b, h, s, d], causal=causal,
                       kv_lens=lens, max_abs_err=err, ms=ms, plain_ms=plain,
                       library_ms=lib, bound_ms=bnd[0], bound_by=bnd[1])
            log(f"kernel {kname} " + json.dumps(row))
            rows.append((kname, row))
        del qg, kg, vg, o_lib, want, out, lse
        torch.cuda.empty_cache()

    # Off-tile S and head_dim through the padding wrapper, gradients
    # end to end (K1 forward, K2/K3 backward on the padded shapes).
    gen = torch.Generator(device="cpu").manual_seed(SEED + 20)
    q, k, v, dout = (torch.randn(*PADDED_CASE, generator=gen).to(dev)
                     for _ in range(4))
    grads = {}
    for impl in ("flash", "xla"):
        leaves = [t.requires_grad_(True) for t in (q.clone(), k.clone(),
                                                   v.clone())]
        o = attention(*leaves, causal=True, implementation=impl)
        grads[impl] = torch.autograd.grad(o, leaves, dout)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item()
              for a, b in zip(grads["flash"], grads["xla"]))
    for a, b in zip(grads["flash"], grads["xla"]):
        torch.testing.assert_close(a, b, atol=BWD_ATOL, rtol=BWD_RTOL)
    log("kernel flash_bwd padded " + json.dumps(
        dict(shape=list(PADDED_CASE), causal=True, max_abs_err=err)))
    return rows, err


def paged_case(dev):
    import torch

    B, H, D, PS, P, N = 8, 12, 64, 16, 64, 513
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    q = torch.randn(B, H, D, generator=gen).to(dev)
    kp = torch.randn(N, H, PS, D, generator=gen).to(dev)
    vp = torch.randn(N, H, PS, D, generator=gen).to(dev)
    table = (1 + torch.randperm(N - 1, generator=gen)).reshape(B, P)
    table[7] = 0  # an all-trash row (an inactive slot)
    lengths = torch.tensor([1, 16, 17, 1024, 300, 777, 64, 1],
                           dtype=torch.int32)
    return q, kp, vp, table.to(torch.int32).to(dev), lengths.to(dev)


def check_paged(dev):
    import torch

    from ml_trainer_tpu_torch.ops.kernels.paged_attention import (
        paged_attention, paged_attention_reference)

    q, kp, vp, table, lengths = paged_case(dev)
    out = paged_attention(q, kp, vp, table, lengths)
    ref = paged_attention_reference(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"paged_attention: max abs err {err} > {TOL}")
    ms = time_ms(lambda: paged_attention(q, kp, vp, table, lengths))
    plain = time_ms(lambda: paged_attention_reference(q, kp, vp, table,
                                                      lengths))
    B, H, D = q.shape
    live = int(lengths.clamp(1, table.shape[1] * kp.shape[2]).sum().item())
    nbytes = 2 * B * H * D * 4 + 2 * live * H * D * 4 + table.numel() * 4 + B * 4
    flops = 4.0 * live * H * D
    b_ms, b_by = bound_ms(nbytes, flops)
    row = dict(B=B, H=H, D=D, lengths=lengths.tolist(), max_abs_err=err,
               ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms,
               bound_by=b_by)
    log("kernel paged_attention " + json.dumps(row))
    return row


# ------------------------------------------------------------- phase 4
def serve(dev):
    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt

    t0 = time.perf_counter()
    model = mt.init_gpt2("gpt2", seed=SEED, device=dev)
    model.eval()
    log(f"model gpt2 124M: {sum(p.numel() for p in model.parameters())} "
        f"params, built in {time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(SEED)
    vocab = model.vocab_size
    shared = rng.integers(0, vocab, 256)
    lengths = [5, 40, 100, 200, 300, 400, 640, 900]
    prompts = []
    for n in lengths:
        prompts.append(rng.integers(0, vocab, n).astype(np.int32))
    # Requests 4 and 5 share a 256-token prefix: 5 is admitted after 4
    # has registered its blocks, so it takes the continuation prefill.
    prompts[4][:256] = shared
    prompts[5][:256] = shared
    new_tokens = 32

    with mt.Server(model, max_batch=8, kv_page_size=16, paged_kernel=True,
                   device=dev) as server:
        # Warm-up request (cuBLAS handles, allocator): not counted.
        server.complete(prompts[0][:3], 2, timeout=600)
        steps_before = server.metrics.snapshot()["decode_steps"]
        mt.reset_launch_counts()
        t0 = time.perf_counter()
        streams = [server.submit(p, new_tokens) for p in prompts]
        outs = [s.result(timeout=900) for s in streams]
        wall = time.perf_counter() - t0
        counts = mt.launch_counts()
        snap = server.metrics.snapshot()
        profile = profile_serving(server, prompts)
    reqs = [s.request for s in streams]
    if not all(r.state == "done" and len(r.tokens) == new_tokens
               for r in reqs):
        raise AssertionError(f"not every request completed: "
                             f"{[(r.state, len(r.tokens)) for r in reqs]}")
    hits = [r.prefix_hit_tokens for r in reqs]
    if hits[5] != 256:
        raise AssertionError(f"expected a 256-token prefix hit, got {hits}")
    steps = snap["decode_steps"] - steps_before
    full = [len(p) for p, h in zip(prompts, hits) if h == 0]
    want_flash = model.depth * sum(
        1 for n in full if min(1 << (n - 1).bit_length(), model.max_len) >= 128)
    if counts["flash_fwd"] < want_flash or want_flash < 5 * model.depth:
        raise AssertionError(f"flash_fwd launched {counts['flash_fwd']}x, "
                             f"expected >= {want_flash}")
    if counts["paged_attention"] != model.depth * steps or steps == 0:
        raise AssertionError(
            f"paged_attention launched {counts['paged_attention']}x over "
            f"{steps} decode steps of {model.depth} layers")

    # Teacher-forced check through the plain attention path.
    worst = 0.0
    model.attention_impl = "xla"
    try:
        with torch.no_grad():
            for p, seq in zip(prompts, outs):
                ids = torch.as_tensor(seq.astype(np.int64), device=dev)[None]
                logits = model(ids)[0]
                n = len(p)
                pos = torch.arange(n - 1, n - 1 + new_tokens, device=dev)
                got = logits[pos, ids[0, n:]]
                gap = (logits[pos].max(-1).values - got).max().item()
                worst = max(worst, gap)
                if not torch.isfinite(logits).all():
                    raise AssertionError("non-finite logits in the check")
    finally:
        model.attention_impl = "auto"
    if not worst <= LOGIT_SLACK:
        raise AssertionError(
            f"a served token is {worst} below the best logit (> {LOGIT_SLACK})")
    ttft = sorted(r.first_token_at - r.submitted_at for r in reqs)
    result = dict(
        requests=len(reqs), new_tokens=new_tokens, prompt_lens=lengths,
        prefix_hit_tokens=hits, wall_s=wall,
        tokens_per_s=len(reqs) * new_tokens / wall,
        ttft_p50_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
        decode_step_mean_ms=1e3 * (sum(server.metrics.step_secs[-steps:])
                                   / steps),
        decode_steps=steps, launches=counts, worst_logit_gap=worst,
        profile=profile,
    )
    return result


def device_split(prof, wall: float) -> dict:
    """Device-busy time of a profiled window (the sum of the device's own
    events: kernels, copies, sets; the host ops' device totals would count
    the same kernels again) against its wall time, with the kernels that
    took the most.  "not measured" when the profiler saw no device time."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    if busy <= 0:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    return {
        "wall_s": wall, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "top_kernels": [{"name": k[:80], "device_ms": us / 1e3, "calls": n}
                        for us, k, n in rows[:10]],
    }


def profile_serving(server, prompts, new_tokens: int = 16) -> dict:
    """Serve the same prompts again under ``torch.profiler`` and split
    the wall time into device-busy time (the serving path runs one
    stream) and idle time (``device_split``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        streams = [server.submit(p, new_tokens) for p in prompts]
        for st in streams:
            st.result(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_split(prof, wall)


# ------------------------------------------------------------- phase 5
TRAIN = dict(model="gpt2", seq_len=1024, vocab_size=50257, batch_size=8,
             accum=4, steps=6, val_batches=2)
# Kernel path vs plain path (model.attention_impl="xla") on the first
# microbatch, float32: the loss within LOSS_RTOL, and each parameter's
# gradient within GRAD_RTOL of that parameter's largest plain gradient
# (the two paths sum over keys in another order, through 12 layers).
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3
TRAIN_DIR = "build/chip_smoke_train"  # model.pth of the run; removed after


def grad_check(trainer, x, y) -> dict:
    """Loss and every parameter gradient of one microbatch through the
    kernels and through the plain attention path."""
    import torch

    model = trainer.model
    out = {}
    for impl in ("auto", "xla"):
        model.attention_impl = impl
        model.zero_grad(set_to_none=True)
        loss = trainer.criterion(model(x), y)
        loss.backward()
        out[impl] = (loss.item(), {n: p.grad.detach().clone()
                                   for n, p in model.named_parameters()})
    model.attention_impl = "auto"
    model.zero_grad(set_to_none=True)
    (l_k, g_k), (l_p, g_p) = out["auto"], out["xla"]
    if not abs(l_k - l_p) <= LOSS_RTOL * abs(l_p):
        raise AssertionError(f"kernel-path loss {l_k} vs plain {l_p}")
    worst, worst_name = 0.0, None
    for name, gp in g_p.items():
        ratio = ((g_k[name] - gp).abs().max() / gp.abs().max()).item()
        if not ratio <= GRAD_RTOL:
            raise AssertionError(
                f"gradient of {name}: max diff {ratio} of its largest "
                f"plain entry > {GRAD_RTOL}")
        if ratio > worst:
            worst, worst_name = ratio, name
    for i in range(model.depth):
        if not bool((g_k[f"blocks.{i}.attn.qkv.weight"] != 0).any()):
            raise AssertionError(f"layer {i}: zero qkv gradient")
    del g_k, g_p
    torch.cuda.empty_cache()
    return dict(loss_kernel=l_k, loss_plain=l_p, worst_grad_ratio=worst,
                worst_grad_param=worst_name)


def profile_step(trainer, x, y) -> dict:
    """One optimizer step under ``torch.profiler``, split into
    device-busy and idle time (``device_split``; the step's kernels run
    on one stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._train_step(x, y, 1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_split(prof, wall)


def train(dev):
    """GPT-2 124M, fp32, through ``Trainer(...).fit()``: the real config
    of examples/04_gpt2_pretrain.py (seq 1024, global batch 8 in 4
    microbatches, adamw 3e-4 / wd 0.01, cosine restarts, clip 1.0,
    accuracy), one epoch of 6 optimizer steps and 2 validation batches."""
    import math
    import shutil

    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import prefetch_to_device

    c = TRAIN
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    sets = (
        mt.SyntheticTokens(size=c["batch_size"] * c["steps"],
                           seq_len=c["seq_len"], vocab_size=c["vocab_size"],
                           seed=SEED),
        mt.SyntheticTokens(size=c["batch_size"] * c["val_batches"],
                           seq_len=c["seq_len"], vocab_size=c["vocab_size"],
                           seed=SEED + 1),
    )
    t0 = time.perf_counter()
    trainer = mt.Trainer(
        c["model"], datasets=sets, epochs=1, batch_size=c["batch_size"],
        grad_accum_steps=c["accum"], optimizer="adamw", lr=3e-4,
        weight_decay=0.01, scheduler="CosineAnnealingWarmRestarts",
        grad_clip_norm=1.0, metric="accuracy", model_dir=TRAIN_DIR,
        seed=SEED, device=dev)
    model = trainer.model
    log(f"train: Trainer({c['model']}) built in "
        f"{time.perf_counter() - t0:.2f}s")
    x, y = next(iter(prefetch_to_device(trainer.train_loader, 1, dev)))
    micro = c["batch_size"] // c["accum"]
    check = grad_check(trainer, x[:micro], y[:micro])
    log("train: first microbatch, kernels vs plain " + json.dumps(check))

    torch.cuda.reset_peak_memory_stats()
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = mt.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    if not all(math.isfinite(v) for v in hist["train_loss"] + hist["val_loss"]):
        raise AssertionError(f"non-finite losses: {hist}")
    if hist["skipped_steps"] != [0]:
        raise AssertionError(f"skipped steps: {hist['skipped_steps']}")
    n_micro = c["steps"] * c["accum"]
    want = {"flash_fwd": model.depth * (n_micro + c["val_batches"]),
            "flash_bwd_dq": model.depth * n_micro,
            "flash_bwd_dkv": model.depth * n_micro, "paged_attention": 0}
    if counts != want:
        raise AssertionError(f"training launches {counts}, expected {want}")

    # Optimizer-step time: CUDA events around steps on one batch (the
    # run above includes loading, validation and the weights' export).
    n_time = 3
    trainer._train_step(x, y, 1.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_time):
        trainer._train_step(x, y, 1.0)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n_time
    profile = profile_step(trainer, x, y)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return dict(
        history={k: hist[k] for k in ("train_loss", "val_loss",
                                      "train_metric", "val_metric",
                                      "skipped_steps")},
        fit_s=fit_s, launches=counts, step_ms=step_ms,
        tokens_per_s=c["batch_size"] * c["seq_len"] / (step_ms / 1e3),
        max_memory_allocated_bytes=peak, grad_check=check, profile=profile)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=["kernels", "train"],
                        default=None)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 2
    from ml_trainer_tpu_torch.device import resolve_device
    from ml_trainer_tpu_torch.ops.kernels import _build

    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f}s")
    for kname, rec in build.items():
        log(f"build {kname}: {rec['seconds']:.2f}s cached={rec['cached']}")
        for line in rec["ptxas"]:
            log(f"  {line}")

    flash_rows = check_flash(dev)
    paged_row = check_paged(dev)
    bwd_rows, padded_err = check_flash_bwd(dev)
    launches = {"flash_fwd": None, "paged_attention": None,
                "flash_bwd_dq": None, "flash_bwd_dkv": None}
    if args.only is None:
        serving = serve(dev)
        launches.update(serving["launches"])
        log(f"serving on {smi}: " + json.dumps(serving))
    if args.only in (None, "train"):
        training = train(dev)
        log(f"training on {smi}: " + json.dumps(training))
        for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            launches[kname] = ((launches[kname] or 0)
                               + training["launches"][kname])
    main_flash = flash_rows[2]  # S=1024 causal: the longest prefill bucket
    bwd = {}
    for kname, row in bwd_rows:  # the main row is each kernel's first
        bwd.setdefault(kname, dict(row, max_abs_err=max(
            [padded_err] + [r["max_abs_err"] for n, r in bwd_rows
                            if n == kname])))
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "ml_trainer_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "ml_trainer_tpu/ops/attention.py:177",
         "launches": launches["flash_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
         **{k: main_flash[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}},
        {"name": "paged_attention", "route": "cuda",
         "source": "ml_trainer_tpu_torch/csrc/paged_attention.cu",
         "replaces": "ml_trainer_tpu/ops/kernels/paged_attention.py:152",
         "launches": launches["paged_attention"],
         **{k: paged_row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}},
    ] + [
        {"name": kname, "route": "cuda",
         "source": "ml_trainer_tpu_torch/csrc/flash_bwd.cu",
         "replaces": f"ml_trainer_tpu/ops/attention.py:{line}",
         "launches": launches[kname],
         **{k: bwd[kname][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")}}
        for kname, line in (("flash_bwd_dq", 385), ("flash_bwd_dkv", 403))
    ]
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 - any failed phase fails the smoke
        traceback.print_exc()
        code = 1
    sys.exit(code)

"""Chip smoke for the PyTorch/CUDA port (``ml_trainer_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py               # every phase
    python3 chip_smoke.py --only kernels  # build + kernel checks only

Phases, one line of output each (or a few):

1. device: the card's name and ``nvidia-smi``'s name and power limit;
2. build: both CUDA kernels from ``ml_trainer_tpu_torch/csrc/`` with
   ``nvcc`` for sm_90a (one process per source, started together),
   with the build seconds and the ``-Xptxas -v`` lines;
3. kernels vs plain at the serving path's shapes: the flash-attention
   forward on [1, 12, S, 64] float32 (causal, S in 128/512/1024, plus a
   kv_lens case) and the paged-attention decode on B=8, H=12, D=64,
   page 16, 64 pages per row, 513 pool pages, ragged lengths and an
   all-trash row.  Each is held to its plain PyTorch version within
   1e-4 absolute (float32, different summation order) and timed with
   CUDA events beside its plain version, one PyTorch library call where
   one exists, and its bound;
4. serving: GPT-2 124M at full width (12 layers, 768 wide, 12 heads,
   vocab 50257, max_len 1024) with seeded random weights behind
   ``Server(max_batch=8, kv_page_size=16, paged_kernel=True)``; 8 greedy
   requests of 32 new tokens, prompts of 5..900 tokens, two sharing a
   256-token prefix.  Checks that all complete, that both kernels'
   launch counters advanced as the path requires, and that every served
   token is within 1e-3 of the best logit when the sequence is run
   again through the plain attention path.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero and
prints no ok line.  Exits non-zero at once without a CUDA card.
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


def profile_serving(server, prompts, new_tokens: int = 16) -> dict:
    """Serve the same prompts again under ``torch.profiler`` and split
    the wall time into device-busy time (the sum of kernel times; the
    serving path runs one stream) and idle time, with the kernels that
    took the most device time.  Reports "not measured" when the
    profiler records no device time."""
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
    rows = []
    for evt in prof.key_averages():
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=["kernels"], default=None)
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
    launches = {"flash_fwd": None, "paged_attention": None}
    if args.only != "kernels":
        serving = serve(dev)
        launches = serving["launches"]
        log(f"serving on {smi}: " + json.dumps(serving))
    main_flash = flash_rows[2]  # S=1024 causal: the longest prefill bucket
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

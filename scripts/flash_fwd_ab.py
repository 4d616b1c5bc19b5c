"""Two builds of the flash forward K1 side by side on an NVIDIA card.

Builds ``ml_trainer_tpu_torch/csrc/flash_fwd.cu`` of this checkout and of
another one (``--parent``: the root of a checkout of the commit to
compare with, such as a ``git archive`` of it unpacked under ``build/``)
with the same ``nvcc`` flags, loads both, and at every row of
``chip_smoke.BF16_CASES``:

- float32 inputs: the two builds' out and lse must be bitwise equal;
- bf16 inputs: this build's out must sit within 2 bf16 ulps of the plain
  version (``chip_smoke.bf16_gate`` <= 1), its lse within 1e-4, two
  calls must agree bit for bit, and out must lie within one bf16 step of
  this build's float32 kernel on the widened inputs
  (``chip_smoke.f32_kernel_ulps``); the other build's gate ratios, and
  whether the two builds' bf16 results are bitwise equal, are reported
  beside;
- device ms of each build's bf16 K1 (profiler events), timed in the
  order other, this, this, other, beside SDPA's bf16 forward on the same
  inputs (timed only; none at ``bh_over_65535``) and the bf16 bound.

Prints nvcc's register and spill report for this build, one JSON line
per row, and exits non-zero if a check fails.

    python3 scripts/flash_fwd_ab.py --parent build/parent
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402
from flash_bwd_ab import load_other, print_ptxas  # noqa: E402
from ml_trainer_tpu_torch.ops.kernels import _build  # noqa: E402


def launcher(lib, q, k, v, kv, causal):
    """K1 of ``lib`` on q, k, v (float32 or bf16) and kv_lens (or None):
    a function that launches it into preallocated out and lse, and the
    two."""
    import torch

    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    tag = "bf16" if q.dtype == torch.bfloat16 else "f32"
    fn = getattr(lib, f"flash_fwd_{tag}")
    lens = None if kv is None else kv.data_ptr()

    def run():
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens,
                        out.data_ptr(), lse.data_ptr(), b * h, h, s,
                        k.shape[2], d, int(causal), float(d ** -0.5),
                        torch.cuda.current_stream().cuda_stream),
                     f"flash_fwd_{tag}")

    return run, out, lse


def run_once(lib, q, k, v, kv, causal):
    import torch

    run, out, lse = launcher(lib, q, k, v, kv, causal)
    run()
    torch.cuda.synchronize()
    return out, lse


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True,
                        help="root of the checkout to compare with")
    opts = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_fwd_ab: no CUDA device visible", file=sys.stderr)
        return 2
    from ml_trainer_tpu_torch.ops.attention import flash_attention_reference

    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: "
          f"{cs.smi_line()} | torch {torch.__version__}", flush=True)
    libs = {"this": _build.load("flash_fwd"), "other": load_other(
        os.path.abspath(opts.parent), "flash_fwd")}
    print_ptxas("flash_fwd")
    ok = True
    for i, (name, b, h, s, d, causal, lens) in enumerate(cs.BF16_CASES):
        q, k, v, kv, _ = cs.bwd_case(dev, b, h, s, d, lens, cs.SEED + 80 + i)
        f32 = {n: run_once(lib, q, k, v, kv, causal) for n, lib in libs.items()}
        f32_equal = all(torch.equal(a, b2)
                        for a, b2 in zip(f32["this"], f32["other"]))
        del f32
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        del q, k, v
        out32 = run_once(libs["this"], qb.float(), kb.float(), vb.float(),
                         kv, causal)[0]
        ref_out, ref_lse = flash_attention_reference(qb, kb, vb, kv, causal)
        got = {n: run_once(lib, qb, kb, vb, kv, causal)
               for n, lib in libs.items()}
        again = run_once(libs["this"], qb, kb, vb, kv, causal)
        bf16_equal = all(torch.equal(a, b2)
                         for a, b2 in zip(got["this"], got["other"]))
        gates = {n: cs.bf16_gate(o, ref_out) for n, (o, _) in got.items()}
        lse_err = {n: (l_ - ref_lse).abs().max().item()
                   for n, (_, l_) in got.items()}
        repeat = all(torch.equal(a, b2) for a, b2 in zip(again, got["this"]))
        try:
            ulps = cs.f32_kernel_ulps(got["this"][0], out32)
        except AssertionError as e:
            print(f"flash_fwd_ab {name}: {e}", flush=True)
            ulps = None
        del out32, again, ref_out, ref_lse, got
        big = b * h > 65535
        times = {n: [] for n in libs}
        for n in ("other", "this", "this", "other"):
            run, _, _ = launcher(libs[n], qb, kb, vb, kv, causal)
            times[n].append(cs.profiled_ms(run, ("flash_fwd",),
                                           iters=5 if big else 20))
        lib_ms = None
        if not big:
            keep = None if kv is None else (
                torch.arange(s, device=dev)[None, :]
                < kv.long()[:, None])[:, None, None, :]
            lib_ms = cs.profiled_ms(
                lambda: F.scaled_dot_product_attention(
                    qb, kb, vb, attn_mask=keep,
                    is_causal=causal and keep is None), ("",), iters=10)
        row_ok = (f32_equal and repeat and ulps is not None
                  and gates["this"] <= 1.0 and lse_err["this"] <= cs.TOL)
        ok = ok and row_ok
        print("flash_fwd_ab " + json.dumps(dict(
            case=name, shape=[b, h, s, d], causal=causal, kv_lens=lens,
            ok=row_ok, f32_bitwise_equal=f32_equal,
            bf16_bitwise_equal=bf16_equal, bitwise_repeat=repeat,
            ulps_from_f32_kernel=ulps, gate_ratio=gates, lse_err=lse_err,
            device_ms={n: sum(t) / len(t) for n, t in times.items()},
            device_ms_each=times, library_device_ms=lib_ms,
            bound_ms=cs.fwd_bounds(b, h, s, d, causal, lens,
                                   bf16=True)["bound_ms"])), flush=True)
        del qb, kb, vb, kv
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

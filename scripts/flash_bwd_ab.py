"""Two builds of the flash backward K2/K3 side by side on an NVIDIA card.

Builds ``ml_trainer_tpu_torch/csrc/flash_bwd.cu`` of this checkout and of
another one (``--parent``: the root of a checkout of the commit to
compare with, such as a ``git archive`` of it unpacked under ``build/``)
with the same ``nvcc`` flags, loads both, and at every bf16 row of
``chip_smoke.BF16_BWD_CASES``:

- float32 inputs: the two builds' dQ, dK and dV must be bitwise equal;
- bf16 inputs: this build's dQ, dK and dV must sit within 2 bf16 ulps of
  the plain version (``chip_smoke.bf16_gate`` <= 1), two calls must agree
  bit for bit, and dK/dV must be 0 past kv_lens; the other build's gate
  ratios, and whether the two builds' bf16 gradients are bitwise equal,
  are reported beside;
- device ms of each build's bf16 K2 and K3 (profiler events), timed in
  the order other, this, this, other, beside SDPA's bf16 backward on the
  same inputs (timed only) and the bf16 bound.

Prints nvcc's register and spill report for this build, one JSON line
per row, and exits non-zero if a check fails.

    python3 scripts/flash_bwd_ab.py --parent build/parent
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from ml_trainer_tpu_torch.ops.kernels import _build  # noqa: E402

def load_other(root: str, name: str = "flash_bwd") -> ctypes.CDLL:
    """Kernel source ``name`` (``csrc/<name>.cu``) of the checkout at
    ``root``, built with this checkout's flags into ``build/ab/``."""
    source = f"ml_trainer_tpu_torch/csrc/{name}.cu"
    out = os.path.join(ROOT, "build", "ab", f"lib{name}_other.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    run = subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-o", out,
                          os.path.join(root, source)],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed for {root}/{source}:\n"
                           f"{run.stdout}{run.stderr}")
    lib = ctypes.CDLL(out)
    for fn, argtypes in _build.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def print_ptxas(name: str) -> None:
    """nvcc's register, shared memory and spill lines for this checkout's
    build of kernel source ``name``."""
    for line in _build.BUILD_LOG.get(name, {}).get("ptxas", []):
        if any(w in line for w in ("registers", "spill", "entry", "arning")):
            print("  " + line, flush=True)


def launchers(lib, args, outs):
    """K2 and K3 of ``lib`` on ``args`` (q, k, v, kv, lse, delta, dout,
    causal, scale) into the preallocated ``outs`` (dq, dk, dv)."""
    import torch

    q, k, v, kv, lse, delta, dout, causal, scale = args
    dq, dk, dv = outs
    b, h, s_q, d = q.shape
    tag = "bf16" if q.dtype == torch.bfloat16 else "f32"
    lens = None if kv is None else kv.data_ptr()
    common = (b * h, h, s_q, k.shape[2], d, int(causal), float(scale))
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens, dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr())

    def k2():
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(getattr(lib, f"flash_bwd_dq_{tag}")(
            *head, dq.data_ptr(), *common, stream), "dq")

    def k3():
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(getattr(lib, f"flash_bwd_dkv_{tag}")(
            *head, dk.data_ptr(), dv.data_ptr(), *common, stream), "dkv")

    return k2, k3


def run_both(lib, args):
    import torch

    outs = tuple(torch.empty_like(t) for t in args[:3])
    k2, k3 = launchers(lib, args, outs)
    k2()
    k3()
    torch.cuda.synchronize()
    return outs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True,
                        help="root of the checkout to compare with")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device visible", file=sys.stderr)
        return 2
    from ml_trainer_tpu_torch.ops.attention import (
        _backward_plain, _row_delta, flash_attention_reference)

    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: "
          f"{cs.smi_line()} | torch {torch.__version__}", flush=True)
    libs = {"this": _build.load("flash_bwd"), "other": load_other(
        os.path.abspath(opts.parent))}
    print_ptxas("flash_bwd")
    ok = True
    for i, (name, b, h, s, d, causal, lens) in enumerate(
            cs.BF16_BWD_CASES):
        q, k, v, kv, dout = cs.bwd_case(dev, b, h, s, d, lens,
                                        cs.SEED + 60 + i)
        scale = d ** -0.5
        out32, lse32 = flash_attention_reference(q, k, v, kv, causal)
        args32 = (q, k, v, kv, lse32, (dout * out32).sum(-1).contiguous(),
                  dout, causal, scale)
        f32 = {n: run_both(lib, args32) for n, lib in libs.items()}
        f32_equal = all(torch.equal(a, b2)
                        for a, b2 in zip(f32["this"], f32["other"]))
        del f32, out32, lse32, args32
        qb, kb, vb, db = (t.to(torch.bfloat16) for t in (q, k, v, dout))
        ref_out, lse = flash_attention_reference(qb, kb, vb, kv, causal)
        args = (qb, kb, vb, kv, lse, _row_delta(ref_out, db), db, causal,
                scale)
        want = _backward_plain(*args)
        got = {n: run_both(lib, args) for n, lib in libs.items()}
        again = run_both(libs["this"], args)
        gates = {n: [cs.bf16_gate(g, w) for g, w in zip(got[n], want)]
                 for n in got}
        repeat = all(torch.equal(a, b2) for a, b2 in zip(again, got["this"]))
        bf16_equal = all(torch.equal(a, b2)
                         for a, b2 in zip(got["this"], got["other"]))
        zero = True
        if lens is not None:
            pad = (torch.arange(s, device=dev)[None, None, :, None]
                   >= kv.long()[:, None, None, None]).expand_as(again[1])
            zero = all(bool((g[pad] == 0).all()) for g in again[1:])
        times = {n: {"flash_bwd_dq": [], "flash_bwd_dkv": []} for n in libs}
        for n in ("other", "this", "this", "other"):
            outs = tuple(torch.empty_like(t) for t in args[:3])
            for kname, fn in zip(("flash_bwd_dq", "flash_bwd_dkv"),
                                 launchers(libs[n], args, outs)):
                times[n][kname].append(cs.profiled_ms(fn, (kname + "_",)))
        lib_ms = cs.profiled_ms(cs._sdpa_bwd(qb, kb, vb, kv, db, causal),
                                ("",), iters=10)
        bounds = cs.bwd_bounds(b, h, s, d, causal, lens, bf16=True)
        row_ok = (f32_equal and repeat and zero
                  and max(gates["this"]) <= 1.0)
        ok = ok and row_ok
        print("flash_bwd_ab " + json.dumps(dict(
            case=name, shape=[b, h, s, d], causal=causal, kv_lens=lens,
            ok=row_ok, f32_bitwise_equal=f32_equal,
            bf16_bitwise_equal=bf16_equal, bitwise_repeat=repeat,
            zero_past_kv_lens=zero, gate_ratio=gates,
            device_ms={n: {k: sum(t) / len(t) for k, t in times[n].items()}
                       for n in times},
            device_ms_each=times, library_device_ms=lib_ms,
            bound_ms={k: r["bound_ms"] for k, r in bounds.items()})),
            flush=True)
        del q, k, v, kv, dout, qb, kb, vb, db, got, again, want, args
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

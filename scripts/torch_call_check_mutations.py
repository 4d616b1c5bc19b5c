"""Mutation check of ``chip_smoke.py``'s per-call check on an NVIDIA card.

For each planted defect below, copy the checkout into a temporary
directory, scale one bf16 kernel's output by 1 + 2^-6 (2 to 4 bf16
ulps) there, rebuild the kernels in the copy and run the per-call check
that the defect should fail: ``serve_call_check`` (K6, K7 and K1's
bf16 O: one prefill and one decode step of GPT-2 124M at bf16, 8
requests) or
``train_call_check`` (K3's dV, K2's dQ: one bf16 GPT-2 124M optimizer
step of 4 microbatches).  Prints one line per defect, ``RESULT failed ...`` when
the check caught it, and exits non-zero if a defect passed.  The
checkout itself is never changed.

    python3 scripts/torch_call_check_mutations.py
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = "ml_trainer_tpu_torch/csrc/"
# name -> (source, line as it is, line with the defect, check, quant_int8)
MUTATIONS = {
    "k6_out_x1.015625": (
        CSRC + "paged_attention.cu",
        "    orow[tid] = __float2bfloat16_rn(sum);",
        "    orow[tid] = __float2bfloat16_rn(sum * 1.015625f);",
        "serve", False),
    "k7_y_x1.015625": (
        CSRC + "int8_matmul.cu",
        "  __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(v, sc));",
        "  __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(v, sc) * 1.015625f);",
        "serve", True),
    "k3_dv_x1.015625": (
        CSRC + "flash_bwd.cu",
        "        store2(dv_out + at, dv_acc[c][e], dv_acc[c][e + 1]);",
        "        store2(dv_out + at, dv_acc[c][e] * 1.015625f, "
        "dv_acc[c][e + 1] * 1.015625f);",
        "train", None),
    "k1_out_x1.015625": (
        CSRC + "flash_fwd.cu",
        "        store2(ob + at, o_acc[c][e] / l[r], o_acc[c][e + 1] / l[r]);",
        "        store2(ob + at, o_acc[c][e] / l[r] * 1.015625f, "
        "o_acc[c][e + 1] / l[r] * 1.015625f);",
        "serve", False),
    "k2_dq_x1.015625": (
        CSRC + "flash_bwd.cu",
        "        store2(dq_out + at, dq_acc[c][e], dq_acc[c][e + 1]);",
        "        store2(dq_out + at, dq_acc[c][e] * 1.015625f, "
        "dq_acc[c][e + 1] * 1.015625f);",
        "train", None),
}
SERVE = r'''
import numpy as np
import chip_smoke as cs
import ml_trainer_tpu_torch as mt
from ml_trainer_tpu_torch.device import resolve_device
dev = resolve_device("cuda")
model = mt.init_gpt2("gpt2", seed=cs.SEED, device=dev, precision="bf16")
model.eval()
rng = np.random.default_rng(cs.SEED)
prompts = [rng.integers(0, model.vocab_size, n).astype(np.int32)
           for n in [5, 40, 100, 200, 300, 400, 640, 900]]
try:
    print("RESULT passed", cs.serve_call_check(model, prompts, QUANT))
except AssertionError as e:
    print("RESULT failed", str(e)[:300])
'''
TRAIN = r'''
import chip_smoke as cs
import ml_trainer_tpu_torch as mt
from ml_trainer_tpu_torch.data import prefetch_to_device
from ml_trainer_tpu_torch.device import resolve_device
dev = resolve_device("cuda")
c = cs.TRAIN
data = mt.SyntheticTokens(size=c["batch_size"], seq_len=c["seq_len"],
                          vocab_size=c["vocab_size"], seed=cs.SEED)
tr = mt.Trainer(c["model"], datasets=(data, data), epochs=1,
                batch_size=c["batch_size"], grad_accum_steps=c["accum"],
                optimizer="adamw", lr=3e-4, seed=cs.SEED, device=dev,
                precision="bf16", model_dir="build/mutation_train")
x, y = next(iter(prefetch_to_device(tr.train_loader, 1, dev)))
try:
    print("RESULT passed",
          cs.train_call_check(tr, x, y, tr.model.depth * c["accum"]))
except AssertionError as e:
    print("RESULT failed", str(e)[:300])
'''


def main() -> int:
    caught = True
    for name, (path, line, defect, check, quant) in MUTATIONS.items():
        with tempfile.TemporaryDirectory() as tmp:
            copy = os.path.join(tmp, "tree")
            shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
                "build", ".git"))
            with open(os.path.join(copy, path)) as f:
                src = f.read()
            if src.count(line) != 1:
                raise SystemExit(f"{name}: the line to change is not in {path}")
            with open(os.path.join(copy, path), "w") as f:
                f.write(src.replace(line, defect))
            code = SERVE.replace("QUANT", str(quant)) if check == "serve" \
                else TRAIN
            run = subprocess.run([sys.executable, "-c", code], cwd=copy,
                                 capture_output=True, text=True, timeout=900)
        results = [ln for ln in run.stdout.splitlines()
                   if ln.startswith("RESULT")]
        result = results[-1] if results else "no result: " + run.stderr[-800:]
        caught = caught and result.startswith("RESULT failed")
        print(name, result, flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())

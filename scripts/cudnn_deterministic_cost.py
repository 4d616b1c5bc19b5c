"""What cuDNN's deterministic algorithms cost the conv families on an
NVIDIA card.

``device.resolve_device`` sets ``torch.backends.cudnn.deterministic =
True`` and ``benchmark = False``: cuDNN's default convolution backward
adds with atomics, so two runs of a conv model differ, where the JAX
programs repeat bit for bit.  This times the optimizer step of ResNet-18
(CIFAR stem, batch 256) and ResNet-50 (224, batch 64), ``chip_smoke.py``'s
configurations, at K = 1 (eager steps) and K = 4 (one CUDA graph replay a
chunk), with the flag on and off (PyTorch's defaults), in the order on,
off, off, on: CUDA events around one chunk of 4 steps, after a warm-up
chunk (and, at K = 4, a fresh capture under each setting).  Then, from
one state (saved and restored through a port checkpoint), one eager step
run twice under each setting: whether the two leave the same state bit
for bit.

Prints one JSON line per family with the card's name and power limit,
and exits non-zero without a card.

    python3 scripts/cudnn_deterministic_cost.py
"""

import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

K = 4
RUNS = [  # (name, model kwargs, data, batch)
    ("resnet18", {"cifar_stem": True}, "cifar", 256),
    ("resnet50", {}, "imagenet", 64),
]
OUT_DIR = "build/cudnn_cost"  # each trainer's model_dir; removed after


def _set(deterministic: bool) -> None:
    import torch

    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = False


def _timed_ms(body, steps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    body()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def _step_ms(trainer, xs, ys, deterministic: bool) -> dict:
    """ms a step at K = 1 and K = 4 under one setting."""
    _set(deterministic)
    trainer._graphs.clear()

    def eager():
        for x, y in zip(xs, ys):
            trainer._train_step(x, y, 1.0)

    def graph():
        trainer._dispatch("train", trainer._train_chunk, xs, ys)

    eager()  # the algorithms' first use under this setting
    k1 = _timed_ms(eager, K)
    graph()  # warm-up chunk and capture
    graph()
    k4 = _timed_ms(graph, K)
    return {"k1_ms": k1, "k4_ms": k4}


def _repeats(trainer, x, y, deterministic: bool, path: str) -> bool:
    """One eager step from the state saved at ``path``, twice: the same
    state after both, bit for bit?"""
    import torch

    from ml_trainer_tpu_torch.checkpoint import restore_checkpoint
    from ml_trainer_tpu_torch.train_state import load_state_tree

    _set(deterministic)
    tree = restore_checkpoint(path)[0]
    after = []
    for _ in range(2):
        load_state_tree(trainer.state, trainer.model, tree)
        trainer._train_step(x, y, 1.0)
        after.append(cs._named_state(trainer))
    torch.cuda.synchronize()
    return cs._leaf_distance(after[1], after[0])[0] is None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("cudnn_deterministic_cost: no CUDA device visible",
              file=sys.stderr)
        return 2
    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.checkpoint import save_checkpoint
    from ml_trainer_tpu_torch.data import prefetch_to_device
    from ml_trainer_tpu_torch.train_state import state_tree
    from ml_trainer_tpu_torch.trainer import _chunk_batches

    dev = mt.resolve_device("cuda")
    smi = cs.smi_line()
    for name, model_kw, data, batch in RUNS:
        t0 = time.perf_counter()
        run_dir = f"{OUT_DIR}/{name}"
        shutil.rmtree(run_dir, ignore_errors=True)
        trainer = mt.Trainer(
            mt.init_model(name, seed=cs.SEED, device=dev, **model_kw),
            datasets=cs.model_sets(data, batch, K), epochs=1,
            batch_size=batch, steps_per_execution=K, model_dir=run_dir,
            seed=cs.SEED, device=dev, loader="python", **cs.SGD_02)
        xs, ys = next(iter(prefetch_to_device(
            _chunk_batches(trainer.train_loader, K, []), size=1,
            device=dev)))
        ckpt = save_checkpoint(f"{run_dir}/checkpoints",
                               state_tree(trainer.state, trainer.model), {},
                               0)
        repeats = {str(det): _repeats(trainer, xs[0], ys[0], det, ckpt)
                   for det in (True, False)}
        times = [(det, _step_ms(trainer, xs, ys, det))
                 for det in (True, False, False, True)]
        on = [t for det, t in times if det]
        off = [t for det, t in times if not det]
        mean = {f"{key}_{tag}": sum(t[key] for t in ts) / len(ts)
                for tag, ts in (("on", on), ("off", off))
                for key in ("k1_ms", "k4_ms")}
        rec = dict(model=name, batch=batch, k=K, card=smi,
                   order="on, off, off, on", deterministic_on=on,
                   deterministic_off=off, **mean,
                   k1_cost=mean["k1_ms_on"] / mean["k1_ms_off"] - 1.0,
                   k4_cost=mean["k4_ms_on"] / mean["k4_ms_off"] - 1.0,
                   step_repeats_bitwise=repeats,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(rec), flush=True)
        del trainer, xs, ys
        torch.cuda.empty_cache()
        shutil.rmtree(run_dir, ignore_errors=True)
    _set(True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

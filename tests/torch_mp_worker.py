"""One process of the port's two-process CPU runs (``gloo``), launched
twice by ``tests/test_torch_distributed.py`` and
``tests/test_torch_sharded_checkpoint.py`` (pytest does not collect this
file).  Every scenario of a suite runs in the one launch; each records
what it found, and the process writes them as JSON to
``<workdir>/<suite>_<rank>.json`` for the tests to assert on.

The reference of a bitwise scenario is the port's one-process run of two
replicas that share the CPU, fed the same global batches: process
``j``'s rows (the ``ShardedSampler`` split) are replica ``j``'s block.
Both run in this process at two threads, so each replica's gradients are
the same computation as the process's.

Usage: python tests/torch_mp_worker.py <suite> <port> <rank> <workdir>
"""

import faulthandler
import json
import os
import sys
import traceback

# A hung collective is the failure mode: dump the stacks and exit well
# inside the tests' limit.
faulthandler.dump_traceback_later(240, exit=True)

SUITE, PORT, RANK, WORKDIR = (sys.argv[1], int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import ml_trainer_tpu_torch as mt  # noqa: E402
import ml_trainer_tpu_torch.trainer as trainer_mod  # noqa: E402
from ml_trainer_tpu_torch.checkpoint.checkpoint import _flatten  # noqa: E402
from ml_trainer_tpu_torch.data import (  # noqa: E402
    JoinedLoader,
    ShardedSampler,
)
from ml_trainer_tpu_torch.data import transforms as tt  # noqa: E402
from ml_trainer_tpu_torch.models.layers import BatchNorm, Conv  # noqa: E402
from ml_trainer_tpu_torch.parallel import (  # noqa: E402
    check_desync,
    distributed,
    initialize_distributed,
)
from ml_trainer_tpu_torch.train_state import state_tree  # noqa: E402

N = 2
VOCAB, SEQ = 64, 16


# ------------------------------------------------------------- data
def token_sets():
    return (mt.SyntheticTokens(size=32, seq_len=SEQ, vocab_size=VOCAB),
            mt.SyntheticTokens(size=16, seq_len=SEQ, vocab_size=VOCAB,
                               seed=1))


def image_sets(side=32, n_train=64, n_val=32):
    def one(seed, n):
        rng = np.random.default_rng(seed)
        x = rng.integers(0, 256, size=(n, side, side, 3), dtype=np.uint8)
        y = rng.integers(0, 10, size=n).astype(np.int32)
        t = tt.Compose([tt.ToFloat(), tt.Normalize((0.5,) * 3,
                                                    (0.25,) * 3)])
        return mt.ArrayDataset(x, y, t)

    return one(0, n_train), one(1, n_val)


# ----------------------------------------------------------- models
def gpt(dropout=0.0):
    return mt.init_model("gpt2_tiny", seed=0, device="cpu",
                         vocab_size=VOCAB, max_len=SEQ,
                         dropout_rate=dropout)


def mlmodel():
    return mt.init_model("mlmodel", seed=0, device="cpu")


class BNNet(torch.nn.Module):
    """A conv, the port's BatchNorm, a dense head."""

    def __init__(self):
        super().__init__()
        self.conv = Conv(3, 8, 3, device="cpu")
        self.bn = BatchNorm(8, device="cpu")
        self.head = torch.nn.Linear(8, 10)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = torch.relu(self.bn(self.conv(x)))
        return self.head(x.mean((2, 3)))


def bnnet():
    """A BNNet with seeded weights (``Conv`` leaves its kernel unset)."""
    model, gen = BNNet(), torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return model


# ---------------------------------------------------------- helpers
def fit(model, sets, model_dir, distributed_run=True, **kw):
    """A fitted trainer: one process of the two-process run, or the
    one-process reference over the same global batches."""
    common = dict(datasets=sets, model_dir=os.path.join(WORKDIR, model_dir),
                  loader="python", seed=7)
    common.update(kw)
    if distributed_run:
        tr = mt.Trainer(model, is_parallel=True, device="cpu", **common)
    else:
        tr = mt.Trainer(model, device=["cpu"] * N, **common)
        tr.train_loader = JoinedLoader(
            mt.Loader(sets[0], batch_size=tr.global_batch // N,
                      drop_last=True,
                      sampler=ShardedSampler(len(sets[0]), N, r,
                                             shuffle=True, seed=7))
            for r in range(N))
    tr.fit()
    return tr


def leaves(tr) -> dict:
    """'/'-path -> numpy of the whole state (``state_tree``)."""
    return {"/".join(p): np.asarray(v.detach().cpu().numpy()
                                    if isinstance(v, torch.Tensor) else v)
            for p, v in _flatten(state_tree(tr.state, tr.model))
            if v is not None and not isinstance(v, dict)}


def compare(mine: dict, ref: dict, split=()) -> dict:
    """Leaf by leaf: bitwise equal, and the largest distance.  A leaf in
    ``split`` is this process's block of the reference's."""
    worst, differ = 0.0, []
    for k, want in ref.items():
        if k in split:
            want = want.reshape((N, -1) + want.shape[1:])[RANK].reshape(
                (-1,) + want.shape[1:])
        got = mine[k]
        if got.shape != want.shape or got.dtype != want.dtype:
            differ.append(f"{k} {got.shape} {got.dtype} vs {want.shape} "
                          f"{want.dtype}")
            continue
        if not np.array_equal(got, want):
            differ.append(k)
            worst = max(worst, float(np.max(np.abs(
                got.astype(np.float64) - want.astype(np.float64)))))
    return {"bitwise": not differ and set(mine) == set(ref),
            "differ": differ[:8], "max_abs": worst, "leaves": len(ref)}


def history(tr) -> dict:
    return {k: tr.history[k] for k in ("train_loss", "val_loss",
                                       "train_metric", "val_metric",
                                       "skipped_steps")}


def split_paths(tr) -> set:
    return {"/".join(p) for p in tr._ckpt_split()}


# -------------------------------------------------------- scenarios
def dist_fused_gpt2():
    kw = dict(epochs=2, batch_size=8, grad_accum_steps=2, optimizer="adamw",
              lr=3e-3, grad_clip_norm=1.0, metric=None)
    a = fit(gpt(), token_sets(), f"fused_{RANK}", **kw)
    r = fit(gpt(), token_sets(), f"fused_ref_{RANK}", False, **kw)
    return {"state": compare(leaves(a), leaves(r)),
            "history": history(a) == history(r), "mesh": a.mesh.shape,
            "loader_batch": a.train_loader.batch_size,
            "losses": a.history["train_loss"]}


def dist_sharded_gpt2_dropout():
    kw = dict(epochs=2, batch_size=8, optimizer="adam", lr=3e-3,
              grad_clip_norm=1.0, dp_update="sharded", metric=None)
    # Format 3 (the moments are split) needs one shared directory.
    a = fit(gpt(0.1), token_sets(), "sharded", **kw)
    r = fit(gpt(0.1), token_sets(), f"sharded_ref_{RANK}", False, **kw)
    split = split_paths(a)
    mine = leaves(a)
    return {"state": compare(mine, leaves(r), split),
            "history": history(a) == history(r),
            "fused_adam": a.fused_adam, "split": len(split),
            "format": mt.checkpoint.checkpoint_format(
                mt.checkpoint.latest_checkpoint(a._ckpt_dir())),
            "local_rows": {k: list(mine[k].shape) for k in sorted(split)[:2]},
            "dropout_masks_differ": a.history["train_loss"]
            != fit(gpt(), token_sets(), "nodrop", **kw
                   ).history["train_loss"]}


def dist_mlmodel_k2():
    kw = dict(epochs=2, batch_size=16, optimizer="adam", lr=1e-3,
              steps_per_execution=2)
    a = fit(mlmodel(), image_sets(), f"ml_{RANK}", **kw)
    r = fit(mlmodel(), image_sets(), f"ml_ref_{RANK}", False, **kw)
    return {"state": compare(leaves(a), leaves(r)),
            "history": history(a) == history(r)}


def dist_batch_norm():
    kw = dict(epochs=2, batch_size=16, optimizer="sgd", lr=0.05)
    sets = image_sets(side=8)
    a = fit(bnnet(), sets, f"bn_{RANK}", **kw)
    r = fit(bnnet(), sets, f"bn_ref_{RANK}", False, **kw)
    got, want = leaves(a), leaves(r)
    # The parameters and the BatchNorm buffers, each against its
    # largest entry.
    rel = {k: float(np.max(np.abs(got[k] - want[k])))
           / float(np.max(np.abs(want[k]))) for k in want
           if k.split("/")[0] in ("params", "batch_stats")}
    return {"synced": a.model.bn.synced, "ref_synced": r.model.bn.synced,
            "max_rel": max(rel.values()), "worst": max(rel, key=rel.get),
            "history_rel": max(
                abs(x - y) / max(abs(y), 1e-30)
                for key in ("train_loss", "val_loss")
                for x, y in zip(a.history[key], r.history[key]))}


def dist_planted_desync():
    a = fit(mlmodel(), image_sets(), f"desync_{RANK}", epochs=1,
            batch_size=16)
    params = {k: p.detach().clone() for k, p in a.model.named_parameters()}
    clean = None
    try:
        check_desync(params, step=11)
    except RuntimeError as e:
        clean = str(e)
    if RANK == 1:
        params["fc1.weight"].mul_(1 + 2 ** -10)
    raised = None
    try:
        check_desync(params, step=12)
    except RuntimeError as e:
        raised = str(e)
    return {"clean_raised": clean, "raised": raised}


def dist_resume_follows_rank0():
    kw = dict(batch_size=16, optimizer="adam", lr=1e-3)
    whole = fit(mlmodel(), image_sets(), f"whole_{RANK}", epochs=2, **kw)
    part = os.path.join(WORKDIR, f"part_{RANK}")
    fit(mlmodel(), image_sets(), f"part_{RANK}", epochs=1, **kw)
    if RANK == 1:
        import shutil

        shutil.rmtree(part, ignore_errors=True)  # rank 0 alone wrote
    tr = mt.Trainer(mlmodel(), datasets=image_sets(), is_parallel=True,
                    device="cpu", model_dir=part, loader="python", seed=7,
                    epochs=2, **kw)
    tr.fit(resume=True)
    return {"state": compare(leaves(tr), leaves(whole)),
            "history": history(tr) == history(whole),
            "epochs": tr.history["epochs"],
            "rank1_dir_empty": RANK == 0 or not os.path.exists(
                os.path.join(part, "checkpoints", "checkpoint_1")),
            "model_pth_written": os.path.exists(os.path.join(
                WORKDIR, f"whole_{RANK}", "model.pth"))}


def dist_desync_every_steps():
    seen = []
    real = trainer_mod.check_desync

    def spy(tree, step=None, **kw):
        seen.append(step)
        return real(tree, step=step, **kw)

    trainer_mod.check_desync = spy
    try:
        fit(mlmodel(), image_sets(), f"every_{RANK}", epochs=2,
            batch_size=16, desync_every_steps=3, steps_per_execution=2)
    finally:
        trainer_mod.check_desync = real
    return {"steps": seen}


def dist_refusals():
    out = {}
    try:
        mt.Trainer("gpt2_tiny", is_parallel=True, device=["cpu"] * 2)
    except NotImplementedError as e:
        out["local_replicas"] = str(e)
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: True
    try:
        mt.Trainer("gpt2_tiny", is_parallel=True, device="cuda:0",
                   steps_per_execution=2)
    except ValueError as e:
        out["gloo_graph"] = str(e)
    finally:
        torch.cuda.is_available = real
    try:
        mt.Trainer(torch.nn.Sequential(torch.nn.BatchNorm1d(4)),
                   is_parallel=True, device="cpu")
    except ValueError as e:
        out["torch_batch_norm"] = str(e)
    try:
        mt.Trainer("mlmodel", is_parallel=True, device="cpu",
                   dp_update="sharded", sharded_checkpoint=False)
    except ValueError as e:
        out["v2_of_split_state"] = str(e)
    return out


def dist_native_loader_split():
    """The native loader reads this process's share, as the Python one."""
    train, val = image_sets()
    tr = mt.Trainer(mlmodel(), datasets=(train, val), is_parallel=True,
                    device="cpu", loader="native", seed=7, batch_size=16,
                    epochs=1, model_dir=os.path.join(WORKDIR, "native"))
    py = mt.Loader(train, batch_size=8, drop_last=True,
                   sampler=ShardedSampler(len(train), N, RANK, seed=7))
    tr.train_loader.set_epoch(1)
    py.set_epoch(1)
    labels = [y.tolist() for _, y in tr.train_loader]
    want = [y.tolist() for _, y in py]
    tr.train_loader.stop()
    return {"kind": type(tr.train_loader).__name__, "labels": labels == want,
            "batches": len(labels)}


# ------------------------------------------------ sharded checkpoints
def ckpt_sharded_write_and_resume():
    kw = dict(batch_size=16, optimizer="adam", lr=1e-3, dp_update="sharded",
              grad_clip_norm=1.0)
    whole = fit(mlmodel(), image_sets(), "whole", epochs=2, **kw)
    part = fit(mlmodel(), image_sets(), "part", epochs=1, **kw)
    latest = os.path.join(part._ckpt_dir(), "checkpoint_1")
    with open(os.path.join(latest, f"manifest_p{RANK:05d}.json")) as fp:
        pieces = json.load(fp)["pieces"]
    with open(os.path.join(latest, "manifest.json")) as fp:
        manifest = json.load(fp)
    tr = mt.Trainer(mlmodel(), datasets=image_sets(), is_parallel=True,
                    device="cpu", model_dir=os.path.join(WORKDIR, "part"),
                    loader="python", seed=7, epochs=2, **kw)
    tr.fit(resume=True)
    split = split_paths(whole)
    mine = leaves(whole)
    np.savez(os.path.join(WORKDIR, f"whole_state_{RANK}.npz"), **mine)
    return {
        "format": manifest["format"], "process_count":
        manifest["process_count"], "split": sorted(split),
        "pieces": [(manifest["leaves"][e["leaf"]]["path"], e["start"],
                    e["stop"]) for e in pieces],
        "resumed": compare(leaves(tr), mine),
        "history": history(tr) == history(whole),
        "epochs": tr.history["epochs"],
        "local_shapes": {k: list(mine[k].shape) for k in sorted(split)}}


def ckpt_preempt_reaching_one_rank():
    """A preemption that reaches rank 1 alone (the injected fault at its
    global step 3 of 8): both processes leave after the same step and
    write the emergency format-3 checkpoint together (a collective), and
    a resume on both ends bitwise the uninterrupted run."""
    import contextlib

    from ml_trainer_tpu_torch.resilience import faults

    kw = dict(batch_size=16, optimizer="adam", lr=1e-3, dp_update="sharded",
              grad_clip_norm=1.0, epochs=2)
    whole = fit(mlmodel(), image_sets(), "preempt_whole", **kw)
    with (faults.injected("preempt@step=3") if RANK == 1
          else contextlib.nullcontext()):
        cut = fit(mlmodel(), image_sets(), "preempt", **kw)
    tr = mt.Trainer(mlmodel(), datasets=image_sets(), is_parallel=True,
                    device="cpu", model_dir=os.path.join(WORKDIR, "preempt"),
                    loader="python", seed=7, **kw)
    tr.fit(resume=True)
    return {"preempted": cut.preempted, "info": cut._preempt_info,
            "resumed": compare(leaves(tr), leaves(whole)),
            "history": history(tr) == history(whole)}


SUITES = {
    "dist": [dist_fused_gpt2, dist_sharded_gpt2_dropout, dist_mlmodel_k2,
             dist_batch_norm, dist_planted_desync, dist_resume_follows_rank0,
             dist_desync_every_steps, dist_refusals,
             dist_native_loader_split],
    "ckpt": [ckpt_sharded_write_and_resume,
             ckpt_preempt_reaching_one_rank],
}


def main() -> int:
    initialize_distributed("gloo", f"localhost:{PORT}", N, RANK,
                           device="cpu")
    out = {"rank": distributed.process_index(),
           "world": distributed.process_count()}
    for fn in SUITES[SUITE]:
        try:
            out[fn.__name__] = fn()
        except Exception:  # noqa: BLE001 - recorded for the test to show
            out[fn.__name__] = {"error": traceback.format_exc()}
            print(out[fn.__name__]["error"], flush=True)
        distributed.barrier()
    with open(os.path.join(WORKDIR, f"{SUITE}_{RANK}.json"), "w") as fp:
        json.dump(out, fp, default=str)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

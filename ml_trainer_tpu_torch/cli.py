"""The port's training command line: ``python -m ml_trainer_tpu_torch``
(or the ``ml-trainer-tpu-torch`` console script), the JAX package's
``main.py`` on the port.

The flags, their names and defaults are ``main.py``'s, except
``--backend``: it defaults to ``cuda`` (the card) and takes the port's
names and aliases (``config.BACKEND_ALIASES``: ``cpu``/``gloo`` run on
the host).  The datasets (``build_datasets``) and the error for a model
that does not take a knob are ``main.py``'s.  The model is built by
``init_model`` from ``--seed`` (the weights a ``Trainer`` given the
model's name would draw); ``--moe_top_k`` other than 1 is refused (no
MoE model is ported).  ``--profile DIR`` records the whole fit with
``torch.profiler`` into ``DIR/trace.json``.

    python -m ml_trainer_tpu_torch --synthetic --epochs 2 --backend cpu
    python -m ml_trainer_tpu_torch --model gpt2 --synthetic_tokens \\
        --seq_len 1024 --vocab_size 50257 --dtype bf16 --remat \\
        --ema_decay 0.999 --steps_per_execution 4 --optimizer adamw

Under ``torchrun`` with ``--is_parallel`` each process trains one
replica (NCCL on ``cuda:<LOCAL_RANK>``; gloo on the CPU with ``--backend
cpu``), and process 0 writes the history, ``model.pth`` and the
checkpoints:

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m ml_trainer_tpu_torch --is_parallel --synthetic --epochs 2
"""

from __future__ import annotations

import argparse
import os

import torch

from ml_trainer_tpu_torch.config import BACKEND_ALIASES
from ml_trainer_tpu_torch.convert import init_model
from ml_trainer_tpu_torch.data.datasets import (
    CIFAR10,
    SyntheticCIFAR10,
    SyntheticTokens,
)
from ml_trainer_tpu_torch.parallel.distributed import (
    PG_BACKENDS,
    initialize_distributed,
    is_primary,
)
from ml_trainer_tpu_torch.trainer import Trainer
from ml_trainer_tpu_torch.utils.functions import custom_pre_process_function

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "bf16": torch.bfloat16, "f32": torch.float32}


def build_datasets(args):
    """``main.py``'s: synthetic token streams for ``--synthetic_tokens``,
    else CIFAR-10, synthetic or from ``--data_dir``."""
    if args.synthetic_tokens:
        if args.custom_function:
            raise SystemExit(
                "--custom_function is the CIFAR augmentation pipeline; it "
                "does not apply to --synthetic_tokens"
            )
        if "bert" in args.model:
            raise SystemExit(
                "--synthetic_tokens drives next-token LM training; the "
                "bert models are sequence classifiers — fine-tune them on "
                "a TokenizedDataset instead (examples/05_bert_finetune.py)"
            )
        return (
            SyntheticTokens(size=args.synthetic_train_size,
                            seq_len=args.seq_len,
                            vocab_size=args.vocab_size),
            SyntheticTokens(size=args.synthetic_val_size,
                            seq_len=args.seq_len,
                            vocab_size=args.vocab_size, seed=1),
        )
    transform = custom_pre_process_function() if args.custom_function else None
    if args.synthetic:
        return (
            SyntheticCIFAR10(size=args.synthetic_train_size,
                             transform=transform),
            SyntheticCIFAR10(size=args.synthetic_val_size,
                             transform=transform, seed=1),
        )
    return (
        CIFAR10(root=args.data_dir, train=True, transform=transform),
        CIFAR10(root=args.data_dir, train=False, transform=transform),
    )


def model_kwargs(args) -> dict:
    """The model knobs the flags set, as ``main.py`` gathers them."""
    model_kw = {}
    if args.dtype:
        model_kw["dtype"] = DTYPES[args.dtype]
    if args.remat_policy != "none" and not args.remat:
        raise SystemExit(
            "--remat_policy only applies with --remat (it controls what "
            "the per-block checkpoint may keep)"
        )
    if args.remat:
        model_kw["remat"] = True
        if args.remat_policy != "none":
            model_kw["remat_policy"] = args.remat_policy
    if args.synthetic_tokens:
        # The model's vocabulary/context must cover the synthetic stream.
        model_kw["vocab_size"] = args.vocab_size
        model_kw["max_len"] = args.seq_len
    if args.loss_chunk:
        model_kw["loss_chunk"] = args.loss_chunk
    if args.moe_top_k != 1:
        raise NotImplementedError(
            f"moe_top_k={args.moe_top_k!r} is not ported yet; see "
            "ROADMAP.md Queue A")
    return model_kw


def main(args) -> None:
    if args.is_parallel:
        # Under torchrun: join the group first, so that the model is built
        # on this process's card.
        initialize_distributed(PG_BACKENDS[BACKEND_ALIASES[args.backend]])
    datasets = build_datasets(args)
    model_kw = model_kwargs(args)
    device = "cpu" if BACKEND_ALIASES[args.backend] == "cpu" else None
    try:
        model = init_model(args.model, seed=args.seed, device=device,
                           **model_kw)
    except TypeError as e:
        raise SystemExit(
            f"model {args.model!r} does not accept {sorted(model_kw)} "
            f"(--dtype applies to the transformer/resnet families, "
            f"--remat/--remat_policy to the transformer families, "
            f"--loss_chunk to the "
            f"GPT-2 family, --moe_top_k to the MoE variants; "
            f"--synthetic_tokens itself injects vocab_size/max_len, so "
            f"it only pairs with the token models): {e}"
        )
    config = {
        "seed": args.seed,
        "scheduler": args.scheduler,
        "optimizer": args.optimizer,
        "momentum": args.momentum,
        "weight_decay": args.weight_decay,
        "lr": args.lr,
        "criterion": args.criterion,
        "pred_function": args.pred_function,
        "metric": args.metric,
        "model_dir": args.model_dir,
        "backend": args.backend,
    }
    trainer = Trainer(
        model,
        datasets=datasets,
        epochs=args.epochs,
        batch_size=args.batch_size,
        is_parallel=args.is_parallel,
        save_history=True,
        steps_per_execution=args.steps_per_execution,
        grad_accum_steps=args.grad_accum_steps,
        shard_opt_state=args.shard_opt_state,
        grad_clip_norm=args.grad_clip_norm,
        ema_decay=args.ema_decay,
        early_stop_patience=args.early_stop_patience,
        save_best=args.save_best,
        decay_exclude_bias_norm=args.decay_exclude_bias_norm,
        label_smoothing=args.label_smoothing,
        **config,
    )
    if args.profile:
        from ml_trainer_tpu_torch.utils.profiler import trace

        with trace(args.profile):
            trainer.fit(resume=args.resume)
        if is_primary():
            print(f"profiler trace -> "
                  f"{os.path.join(args.profile, 'trace.json')}"
                  " (open in Perfetto or chrome://tracing)")
    else:
        trainer.fit(resume=args.resume)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch_size", type=int, default=32,
                        help="global batch size for training (default: 32)")
    parser.add_argument("--epochs", type=int, default=10,
                        help="number of epochs to train (default: 10)")
    parser.add_argument("--optimizer", type=str, default="sgd",
                        help="optimizer for the update step (default: sgd)")
    parser.add_argument("--lr", type=float, default=0.001,
                        help="learning rate (default: 0.001)")
    parser.add_argument("--momentum", type=float, default=0.9,
                        help="optimizer momentum (default: 0.9)")
    parser.add_argument("--weight_decay", type=float, default=0.0,
                        help="optimizer weight decay (default: 0.0)")
    parser.add_argument("--seed", type=int, default=32,
                        help="random seed (default: 32)")
    parser.add_argument("--scheduler", type=str, default=None,
                        help="LR scheduler name (default: None)")
    parser.add_argument("--criterion", type=str, default="cross_entropy",
                        help="loss function (default: cross_entropy)")
    parser.add_argument("--metric", type=str, default=None,
                        help="evaluation metric (default: None)")
    parser.add_argument("--backend", type=str, default="cuda",
                        choices=sorted(BACKEND_ALIASES),
                        help="where to train: cuda (the card; smddp, nccl "
                             "and tpu are aliases) or cpu (gloo)")
    parser.add_argument("--custom_function", action="store_true",
                        help="apply the custom preprocess pipeline")
    parser.add_argument("--pred_function", type=str, default=None,
                        help="probability function for predictions")
    parser.add_argument("--model", type=str, default="mlmodel",
                        help="model zoo name (default: mlmodel)")
    parser.add_argument("--is_parallel", action="store_true",
                        help="train data-parallel: one replica a process "
                             "under torchrun")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest full checkpoint")
    parser.add_argument("--synthetic", action="store_true",
                        help="use deterministic synthetic CIFAR-10 data")
    parser.add_argument("--synthetic_tokens", action="store_true",
                        help="use synthetic token streams (next-token "
                             "prediction) — the LM path for the "
                             "gpt2 family")
    parser.add_argument("--seq_len", type=int, default=128,
                        help="sequence length for --synthetic_tokens")
    parser.add_argument("--vocab_size", type=int, default=1024,
                        help="vocabulary size for --synthetic_tokens")
    parser.add_argument("--synthetic_train_size", type=int, default=2048)
    parser.add_argument("--synthetic_val_size", type=int, default=512)
    parser.add_argument("--dtype", type=str, default=None,
                        choices=["float32", "bfloat16", "bf16", "f32"],
                        help="model compute dtype (params stay f32)")
    parser.add_argument("--remat", action="store_true",
                        help="torch.utils.checkpoint per transformer block "
                             "(activation memory O(depth) -> O(1) layers)")
    parser.add_argument("--remat_policy", type=str, default="none",
                        choices=["none", "dots"],
                        help="with --remat: what the checkpoint may keep "
                             "('dots' keeps matmul outputs — less "
                             "recompute for some memory back)")
    parser.add_argument("--loss_chunk", type=int, default=0,
                        help="GPT-2 family: compute the LM loss in "
                             "sequence chunks of this size inside the "
                             "forward — the [B,S,V] logits tensor is never "
                             "materialized (metric must be none)")
    parser.add_argument("--moe_top_k", type=int, default=1,
                        help="MoE variants: experts per token (no MoE "
                             "model is ported: only 1)")
    parser.add_argument("--profile", type=str, default=None,
                        help="directory for a torch.profiler trace of the "
                             "whole fit (trace.json)")
    parser.add_argument("--steps_per_execution", type=int, default=1,
                        help="optimizer steps per dispatch (one CUDA graph "
                             "of K steps; trajectory identical)")
    parser.add_argument("--grad_accum_steps", type=int, default=1,
                        help="microbatches per optimizer update")
    parser.add_argument("--shard_opt_state", action="store_true",
                        help="ZeRO-1 placement: partition optimizer moments "
                        "over the data mesh axis")
    parser.add_argument("--grad_clip_norm", type=float, default=None,
                        help="clip gradients to this global L2 norm "
                             "before the optimizer update")
    parser.add_argument("--ema_decay", type=float, default=None,
                        help="keep an exponential moving average of the "
                             "params; eval/save then use the EMA weights")
    parser.add_argument("--early_stop_patience", type=int, default=None,
                        help="stop when validation loss has not improved "
                             "for this many epochs (counters live in "
                             "checkpoints, so --resume keeps counting)")
    parser.add_argument("--save_best", action="store_true",
                        help="also export weights to <model_dir>/best "
                             "whenever validation loss improves")
    parser.add_argument("--decay_exclude_bias_norm", action="store_true",
                        help="weight decay touches matrices only (skip "
                             "biases/LayerNorm — the transformer recipe)")
    parser.add_argument("--label_smoothing", type=float, default=0.0,
                        help="mix one-hot targets with the uniform "
                             "distribution at this weight (cross_entropy "
                             "only; the ViT/ResNet recipe)")
    parser.add_argument("--model_dir", type=str,
                        default=os.environ.get("SM_MODEL_DIR", "model_output"))
    parser.add_argument("--data_dir", type=str,
                        default=os.environ.get("SM_CHANNEL_TRAIN", "data"))
    return parser.parse_args(argv)


def cli(argv=None) -> None:
    """Console-script entry point (``ml-trainer-tpu-torch``)."""
    main(parse_args(argv))

"""Trainer: the config-driven fit/validate/test orchestrator (the core
of the JAX package's ``trainer.py``), in eager PyTorch.

Same constructor surface as the reference (``Trainer(model, datasets,
epochs, batch_size, is_parallel, save_history, **config)`` with the
eleven whitelisted config keys and the reference-parity ``TypeError``),
the same ``fit()`` / ``test()`` / ``save_model()`` / ``save_history_()``
/ ``clear()`` / ``validate_kwargs()``, and the same ``history`` keys.

The train step follows the JAX package's compiled step, written out:

* ``grad_accum_steps`` microbatches each run forward and ``backward()``;
  the summed gradients are divided by the count, as the reference's
  ``lax.scan`` does, and the loss and metric are their microbatch means;
* the optimizer is the functional optax-style chain of
  ``ops/optimizers.py``, with ``grad_clip_norm`` as optax's
  ``clip_by_global_norm`` in front, then ``lr_scale`` (the plateau
  controller's factor) on the updates;
* ``nonfinite_guard``: a non-finite loss or gradient keeps the old
  params and optimizer state, counts included (Adam's and the
  schedule's), through device-side selects; only ``step`` advances and
  the skipped/streak counters live on the device;
* the epoch loops read the device only every ``log_every`` steps and at
  the epoch's end;
* ``steps_per_execution`` K > 1 (the JAX package's ``lax.scan`` of K
  steps over batches stacked to [K, B, ...]): each full chunk of K
  batches runs the step K times, writing the state back into the same
  tensors (``_train_step_in_place``); on the card the chunk is one
  replay of a CUDA graph of those K steps (``step_graph.py``), captured
  after the first chunk ran them for real.  The ragged tail runs batch
  by batch, and the history is the K = 1 run's up to the order of the
  epoch sums (a dispatch's K losses are added first, as in JAX);
* ``precision="bf16"`` (``precision.py``): the loss function runs the
  model on bf16 copies of the float32 master parameters
  (``torch.func.functional_call``; the gradients come home float32
  through the casts' backward), floating inputs cast to bf16, BatchNorm
  buffers float32, the output cast to float32 before the criterion and
  the metric.  ``loss_scale`` (dynamic by default) multiplies the loss
  before ``backward()`` and divides the gradients after; the guard backs
  the scale off on an overflow without advancing ``bad_streak`` while it
  can still fall, and grows it after ``growth_interval`` finite steps,
  all by device-side selects.  At fp32 none of this runs.

Data parallelism (``is_parallel`` / ``mesh_shape={"data": n}`` with a
list of ``n`` devices) follows the JAX package's two step flavours over
replicas that share one device (``parallel/``): replica ``j`` takes row
block ``j`` of the global batch, its ``grad_accum_steps`` microbatches
cut from its own rows.

* ``dp_update="fused"`` (the default): the replicas' local-mean
  gradients are ``pmean``-ed, then go through the single-card update.
  A model with BatchNorm instead runs each of the ``grad_accum_steps``
  GLOBAL microbatches at once, as the JAX package's compiled step does
  (SyncBN): its statistics cover the global microbatch and the running
  statistics update once per microbatch, not once per replica.
* ``dp_update="sharded"`` (``_make_sharded_train_step`` of the JAX
  package, written out): the summed local-mean gradients leave through
  one reduce-scatter per bucket (leaves whose dim 0 does not divide by
  ``n`` through one ``psum``), are divided by ``n * accum``, clipped by
  ``clip / max(global norm, clip)`` with the norm summed over the
  replicas' shards, and each replica updates its dim-0 shard of the
  params and of the ZeRO-1 moments; a skip needs every replica's
  consent; the fresh shards come back through one all-gather per bucket.
  With ``fused_adam`` (on by default for plain Adam with no weight
  decay) the tail runs kernels K4 and K5 (``ops/kernels/fused_adam.py``),
  each one launch per replica over that replica's whole list of leaves,
  and stays bitwise the unfused chain's on the CPU.

The loaders are the C++ ``NativeLoader`` (``data/native.py``) where
``loader`` asks for it, or where it is 'auto' and ``native_plan`` takes
the dataset (uint8 images with the reference augmentation), the library
builds and the batches split evenly; else the Python ``Loader``.  A
model that computes its own loss (GPT-2 or Llama with ``loss_chunk``:
the chunked LM head, which never holds the [B, S, V] logits) gets the labels through
its forward (``targets=``) in every step and evaluation, and returns the
loss; it needs ``metric=None`` and no ``label_smoothing``.

The model runs on the CUDA card unless ``device="cpu"`` (or a CPU
``backend``) is asked for.  A model named from the registry is built by
``init_model``'s seeded initializer (at the policy's compute dtype); an
``nn.Module`` is trained as given (moved to the device), except that one
the registry built at another compute dtype than an active policy's is
rebuilt at the policy's, with the same weights.  Training runs the model
in train mode, evaluation in eval mode (BatchNorm: the running
statistics).  The non-finite guard also reverts the model's buffers
(BatchNorm's running statistics) on a skipped step.  Knobs not ported
yet are accepted at their defaults and raise ``NotImplementedError``
naming ROADMAP.md otherwise.

Full-state checkpoints follow the JAX package's ``fit``: after each
epoch's ``model.pth`` the whole state (``train_state.state_tree``: the
parameters, buffers, optimizer state, step and counters) goes to
``<model_dir>/checkpoints/checkpoint_<epoch>`` (``checkpoint/``, format
v2, CRC32 per leaf), copied to the host at once and written on a
background thread.  ``save_every_steps`` adds mid-epoch checkpoints with
the batch cursor and the epoch's sums; ``fit(resume=True)`` restores the
newest valid one into the tensors that hold the state (``copy_``, so
that a CUDA graph's addresses stay valid) and continues bit for bit,
consuming the batches already trained from the loader.  The fault hooks
(``resilience/faults.py``: ``preempt``, ``nan_grad``) fire per batch at
K = 1; a SIGTERM/SIGINT takes the ``preempt`` path.

A model with dropout (``models/layers.py``'s ``DropoutStream``) draws
its masks from a hash of the config's ``seed``, the step, the site and
the element's row in the global batch: each step sets the stream's keys
from a device step counter and each microbatch its first row, so
``grad_accum_steps``, the replicas and the K-step graph all see the
masks of one single-card step, and a resumed run needs no RNG state.
``ema_decay`` keeps ``state.ema_params`` (``e = d * e + (1 - d) * p``
after each update, the old value kept on a skipped step); the
evaluations, ``test()``, ``predict()`` and the saved weights use it.

``lora`` (``lora.LoraConfig`` or its kwargs; the GPT-2 family only, as
in the JAX package): the model is cloned with train-mode adapters
(``GPT2.clone``, copies of the base weights; A drawn from the config's
``seed``, B zero), the base parameters are frozen (``requires_grad=
False``: their gradient products are never computed) and the optimizer
is ``multi_transform({"lora": chain(clip, optimizer), "frozen":
set_to_zero()})``, so the clip's norm is the adapters' and the base
carries no optimizer state.  The step and its guard run over the
adapters' gradients, with the loss: a non-finite gradient of a base
leaf reaches an adapter's through the residual stream below it (the
lowest targeted projection's gradient sums every later block's), so the
guard decides as the JAX guard, which also reads the base's gradients,
but for an overflow of a product whose inputs are finite.  The EMA
covers every parameter, as the JAX package's.  ``export_lora(path)``
writes the adapter artifact; ``export_torch(path)`` the weights as a
reference-style ``model.pth`` (``checkpoint/torch_export.py``).
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import itertools
import json
import logging
import math
import os
import pickle
import signal
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ml_trainer_tpu_torch.checkpoint import (
    latest_valid_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from ml_trainer_tpu_torch.config import TrainerConfig, validate_kwargs
from ml_trainer_tpu_torch.convert import init_model
from ml_trainer_tpu_torch.data import Loader, prefetch_to_device
from ml_trainer_tpu_torch.data.native import (
    NativeLoader,
    native_available,
    native_plan,
)
from ml_trainer_tpu_torch.device import resolve_device
from ml_trainer_tpu_torch.models.layers import (
    BatchNorm,
    dropout_stream,
    init_lora,
)
from ml_trainer_tpu_torch.ops.kernels.fused_adam import (
    adam_scalars,
    fused_adam_update_list,
    unscale_sqsum_list,
)
from ml_trainer_tpu_torch.ops.losses import get_criterion
from ml_trainer_tpu_torch.ops.metrics import get_metric
from ml_trainer_tpu_torch.ops.optimizers import (
    chain,
    clip_by_global_norm,
    decay_mask_matrices_only,
    get_optimizer,
    identity,
    multi_transform,
    set_to_zero,
    tree_leaves,
    tree_map,
)
from ml_trainer_tpu_torch.ops.predictions import get_prediction_function
from ml_trainer_tpu_torch.ops.schedules import (
    PlateauController,
    make_lr_schedule,
)
from ml_trainer_tpu_torch.parallel import collectives as col
from ml_trainer_tpu_torch.parallel.distributed import initialize_distributed
from ml_trainer_tpu_torch.parallel.mesh import create_mesh
from ml_trainer_tpu_torch.parallel.sharding import (
    bucketed_all_gather,
    bucketed_reduce_scatter,
    join_replica_views,
    plan_grad_buckets,
    replica_view,
    zero1_opt_shardings,
)
from ml_trainer_tpu_torch.precision import (
    cast_floating,
    resolve_loss_scale,
    resolve_precision,
)
from ml_trainer_tpu_torch.resilience.faults import active_plan
from ml_trainer_tpu_torch.step_graph import StepGraph
from ml_trainer_tpu_torch.train_state import (
    TrainState,
    load_state_tree,
    state_tree,
)
from ml_trainer_tpu_torch.utils.logging import get_logger
from ml_trainer_tpu_torch.utils.utils import LoadedModel

logger = get_logger("ml_trainer_tpu_torch.trainer")

MODEL_FILE = "model.pth"
PREEMPT_MARKER = "PREEMPTED.json"


def _own_storage(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when it is a view into a larger buffer."""
    if t.untyped_storage().nbytes() > t.numel() * t.element_size():
        return t.clone()
    return t


def _chunk_batches(loader, k: int, tail: list):
    """Yield [K, B, ...] stacks of full batches; ragged batches (and the
    final partial chunk) land in ``tail`` once the generator drains (the
    JAX package's ``_chunk_batches``)."""
    xs, ys = [], []
    full = None  # leading dim of a full batch (first seen)
    for x, y in loader:
        if full is None:
            full = x.shape[0]
        if x.shape[0] != full:
            # Ragged final batch (drop_last=False): un-stackable, so it
            # always goes through the per-batch tail path even when it
            # would land inside a full chunk.
            tail.append((x, y))
            continue
        xs.append(x)
        ys.append(y)
        if len(xs) == k:
            yield np.stack(xs), np.stack(ys)
            xs, ys = [], []
    tail.extend(zip(xs, ys))


def _summed_steps(step, xs, ys):
    """``step(x, y)`` over the batches of the stacks ``xs``/``ys``: the
    summed losses and metrics, added in step order."""
    loss = metric = None
    for x, y in zip(xs, ys):
        lo, me = step(x, y)
        loss = lo if loss is None else loss + lo
        metric = me if metric is None else metric + me
    return loss, metric


def _state_tensors(state: TrainState) -> list:
    """Every tensor of ``state`` that a step replaces: the optimizer
    state's leaves, the guard's counters, the loss scale's and the EMA's
    leaves."""
    return tree_leaves(state.opt_state) + [
        t for t in (state.skipped_steps, state.bad_streak, state.loss_scale,
                    state.good_steps) if t is not None] + list(
        (state.ema_params or {}).values())


def _module_takes_targets(module) -> bool:
    """Whether ``module`` computes its own loss: its forward accepts
    ``targets`` and it carries an active ``loss_chunk`` (GPT-2 or Llama
    with ``loss_chunk`` > 0).  The Trainer then feeds the labels through the
    forward instead of applying the criterion to returned logits."""
    import inspect

    try:
        params = inspect.signature(module.forward).parameters
    except (TypeError, ValueError, AttributeError):
        return False
    return "targets" in params and bool(getattr(module, "loss_chunk", 0))


def _refuse(knob: str, value, accepted) -> None:
    if value not in accepted:
        raise NotImplementedError(
            f"{knob}={value!r} is not ported yet; see ROADMAP.md Queue A"
        )


# Whether this process has logged the inert knobs' warning.
_INERT_WARNED = False


def _warn_inert_knobs(desync_every_steps) -> None:
    """One ``logging`` warning per process when a knob the port accepts
    and ignores is set so the JAX package would act on it: a
    ``desync_every_steps`` (its replica-desync check, multi-host only).
    The other two never qualify here: ``straggler_factor`` acts only under
    ``telemetry=True``, which is refused, and ``moe_aux_weight`` only on a
    model that sows auxiliary losses (MoE), of which none is ported."""
    global _INERT_WARNED
    if desync_every_steps is not None and not _INERT_WARNED:
        _INERT_WARNED = True
        logging.getLogger(__name__).warning(
            "Trainer: %s accepted with no effect: not ported yet (the JAX "
            "package would act on it); see ROADMAP.md Queue A",
            f"desync_every_steps={desync_every_steps!r}")


def _poison_batch(x: torch.Tensor) -> torch.Tensor:
    """The ``nan_grad`` fault: a floating batch filled with NaN, so the
    step's loss and gradients are non-finite."""
    if x.is_floating_point():
        return x * float("nan")
    logger.warning(
        "nan_grad fault ignored: integer input batch cannot carry NaN")
    return x


class Trainer:
    def __init__(
        self,
        model,
        datasets=None,
        epochs: Optional[int] = None,
        batch_size: Optional[int] = None,
        is_parallel: bool = False,
        save_history: bool = False,
        mesh_shape: Optional[dict] = None,
        sharding_rules=None,
        grad_accum_steps: int = 1,
        loader: str = "auto",
        steps_per_execution: int = 1,
        shard_opt_state: bool = False,
        grad_clip_norm: Optional[float] = None,
        ema_decay: Optional[float] = None,
        moe_aux_weight: float = 0.01,
        early_stop_patience: Optional[int] = None,
        save_best: bool = False,
        decay_exclude_bias_norm: bool = False,
        label_smoothing: float = 0.0,
        sharded_checkpoint: Optional[bool] = None,
        nonfinite_guard: bool = True,
        rollback_bad_steps: Optional[int] = None,
        rollback_lr_backoff: float = 0.5,
        save_every_steps: Optional[int] = None,
        handle_preemption: bool = True,
        telemetry: bool = False,
        log_every_steps: Optional[int] = None,
        desync_every_steps: Optional[int] = None,
        straggler_factor: float = 2.0,
        precision: Any = None,
        loss_scale: Any = "dynamic",
        dp_update: str = "fused",
        fused_adam: Optional[bool] = None,
        bucket_mb: float = 4.0,
        pipeline_schedule: Optional[str] = None,
        elastic: Any = None,
        lora: Any = None,
        device=None,
        **config: Any,
    ):
        """The JAX package's ``Trainer`` arguments, plus ``device``.

        ``device``: one device, or the mesh's device list (one entry per
        data replica; the replicas must share one device, which may
        repeat: ``["cpu"] * 8``, ``["cuda", "cuda"]``).

        Ported: ``grad_accum_steps``, ``grad_clip_norm``,
        ``early_stop_patience``, ``save_best``, ``decay_exclude_bias_norm``,
        ``label_smoothing``, ``nonfinite_guard``, ``log_every_steps``,
        ``precision`` (None | 'fp32' | 'bf16' | a ``Precision``),
        ``loss_scale`` ('dynamic' | a float | a ``LossScaleConfig`` |
        None; it acts only with bf16, and needs ``nonfinite_guard``),
        ``loader`` ('auto' | 'native' | 'python': 'auto' takes the C++
        ``NativeLoader`` where ``data.native_plan`` accepts the dataset,
        the library builds and the batches split evenly, as the JAX
        package's 'auto' does), a model that computes its own loss (GPT-2
        with ``loss_chunk``: the labels go through the forward, ``metric``
        must be None and ``label_smoothing`` 0),
        ``steps_per_execution`` (K optimizer steps a dispatch: on the
        card one CUDA graph replay a chunk of K batches), data
        parallelism: ``is_parallel``, ``mesh_shape`` (the data
        axis only), ``dp_update`` ('fused' | 'sharded'), ``fused_adam``
        (None: on exactly for the sharded step with plain Adam and no
        weight decay), ``bucket_mb`` and ``shard_opt_state`` (ZeRO-1,
        implied by the sharded step; under the fused step a placement
        with no effect on replicas that share a device), and the
        full-state checkpoints: ``save_every_steps`` (a mid-epoch
        checkpoint every N batches; K = 1 only), ``rollback_bad_steps``
        and ``rollback_lr_backoff`` (restore the newest valid checkpoint
        after N consecutive skipped steps, the LR scaled down), and
        ``handle_preemption`` (SIGTERM/SIGINT end ``fit()`` with an
        emergency checkpoint; ``fit(resume=True)`` continues), and
        ``ema_decay`` (a float32 moving average of the parameters, kept
        by every step flavour and reverted with a skipped step; eval,
        ``test()``, ``predict()``, ``save_model`` and ``save_best`` use
        it), and ``lora`` (a ``LoraConfig`` or its kwargs dict: a
        frozen base and trainable adapters, GPT-2 family, the fused
        update only).  Accepted with no effect here: ``moe_aux_weight`` (no MoE model is
        ported), ``desync_every_steps`` and ``straggler_factor``
        (multi-host and telemetry only); the first ``Trainer`` of a
        process logs one warning when the JAX package would act on a
        ``desync_every_steps`` as set (``_warn_inert_knobs``).
        Refused unless at their defaults: ``sharding_rules``,
        ``telemetry``, ``elastic``,
        ``pipeline_schedule`` and ``sharded_checkpoint=True``; so are
        mesh axes other than ``data`` and
        replicas on distinct devices.
        """
        logger.info("Config inputs.", config=config)
        cfg = TrainerConfig.from_kwargs(**config)
        self.config = cfg
        self.precision = resolve_precision(precision)
        self._compute_dtype = (self.precision.compute
                               if self.precision.active else None)
        self._loss_scale_cfg = resolve_loss_scale(loss_scale, self.precision)
        if self._loss_scale_cfg is not None and not nonfinite_guard:
            raise ValueError(
                "loss scaling rides the non-finite guard (overflow steps "
                "are skipped by the same where-selects); pass "
                "loss_scale=None to run bare bf16 with nonfinite_guard "
                "disabled")
        if dp_update not in ("fused", "sharded"):
            raise ValueError(
                f"dp_update must be 'fused' | 'sharded', got {dp_update!r}")
        if fused_adam:
            if dp_update != "sharded":
                raise ValueError(
                    "fused_adam=True needs dp_update='sharded': the fused "
                    "kernels replace the sharded step's optimizer tail (the "
                    "fused step keeps the unfused update)")
            if cfg.optimizer != "adam":
                raise ValueError(
                    "fused_adam=True supports optimizer='adam' only (got "
                    f"{cfg.optimizer!r}): the kernels replicate optax.adam's "
                    "exact op chain")
            if cfg.weight_decay:
                raise ValueError(
                    "fused_adam=True needs weight_decay=0: coupled L2 "
                    "prepends add_decayed_weights, which the fused kernels "
                    "do not replicate")
        if steps_per_execution < 1:
            raise ValueError(
                f"steps_per_execution must be >= 1, got {steps_per_execution}")
        if dp_update == "sharded" and steps_per_execution > 1:
            raise ValueError(
                "dp_update='sharded' requires steps_per_execution=1")
        for knob, value, accepted in (
            ("sharding_rules", sharding_rules, (None,)),
            ("telemetry", telemetry, (False,)),
            ("elastic", elastic, (None,)),
            ("pipeline_schedule", pipeline_schedule, (None,)),
            ("sharded_checkpoint", sharded_checkpoint, (None, False)),
        ):
            _refuse(knob, value, accepted)
        if lora is not None:
            from ml_trainer_tpu_torch.lora import LoraConfig

            if isinstance(lora, dict):
                lora = LoraConfig(**lora)
            if not isinstance(lora, LoraConfig):
                raise ValueError(
                    f"lora must be a LoraConfig (or its kwargs dict), "
                    f"got {type(lora).__name__}")
            if dp_update == "sharded":
                raise ValueError(
                    "lora training uses the fused update: the sharded "
                    "path's dim-0 partition rule does not cover the "
                    "masked optimizer state (dp_update='fused')")
        self.lora = lora
        if loader not in ("auto", "native", "python"):
            raise ValueError(
                f"loader must be 'auto' | 'native' | 'python', got {loader!r}")
        self._loader_kind = loader
        if grad_accum_steps < 1:
            raise ValueError(
                f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
        if grad_clip_norm is not None and grad_clip_norm <= 0:
            raise ValueError(
                f"grad_clip_norm must be positive, got {grad_clip_norm}")
        if ema_decay is not None and not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        self.ema_decay = ema_decay
        if moe_aux_weight < 0:
            raise ValueError(
                f"moe_aux_weight must be >= 0, got {moe_aux_weight}")
        if early_stop_patience is not None and early_stop_patience < 1:
            raise ValueError(
                f"early_stop_patience must be >= 1, got {early_stop_patience}")
        if rollback_bad_steps is not None and rollback_bad_steps < 1:
            raise ValueError(
                f"rollback_bad_steps must be >= 1, got {rollback_bad_steps}")
        if not 0.0 < rollback_lr_backoff <= 1.0:
            raise ValueError(
                f"rollback_lr_backoff must be in (0, 1], got "
                f"{rollback_lr_backoff}")
        if save_every_steps is not None:
            if save_every_steps < 1:
                raise ValueError(
                    f"save_every_steps must be >= 1, got {save_every_steps}")
            if steps_per_execution > 1:
                raise ValueError(
                    "save_every_steps (step-granular mid-epoch checkpoints) "
                    "requires steps_per_execution=1: the multi-step scan "
                    "dispatch has no per-batch cursor to checkpoint")
        if log_every_steps is not None and log_every_steps < 1:
            raise ValueError(
                f"log_every_steps must be >= 1, got {log_every_steps}")
        if straggler_factor <= 1.0:
            raise ValueError(
                f"straggler_factor must be > 1, got {straggler_factor}")
        if bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be positive, got {bucket_mb}")
        _warn_inert_knobs(desync_every_steps)

        listed = isinstance(device, (list, tuple))
        if listed and not device:
            raise ValueError("device=[] names no device")
        if cfg.backend == "cpu":
            asked = list(device) if listed else [device]
            if any(d is not None and torch.device(d).type != "cpu"
                   for d in asked):
                raise ValueError(
                    f"backend={config.get('backend')!r} runs on the CPU, "
                    f"but device={device!r} was asked for")
            device = ["cpu"] * len(asked) if listed else "cpu"
        devices = [resolve_device(d) for d in (device if listed
                                               else [device])]
        if is_parallel:
            initialize_distributed(cfg.backend)
        self.mesh = create_mesh(mesh_shape, devices)
        self.device = self.mesh.device
        n_replicas = self.mesh.size
        self.dp_update = dp_update
        self.fused_adam = (
            dp_update == "sharded" and cfg.optimizer == "adam"
            and not cfg.weight_decay and lora is None
        ) if fused_adam is None else bool(fused_adam)
        self.bucket_mb = float(bucket_mb)
        if dp_update == "sharded":
            if n_replicas < 2:
                logger.warning(
                    "dp_update='sharded' on a single-replica mesh has "
                    "nothing to shard; falling back to the fused step.")
                self.dp_update = "fused"
                self.fused_adam = False
            elif not shard_opt_state:
                logger.info("dp_update='sharded' implies shard_opt_state=True "
                            "(ZeRO-1 moment placement).")
                shard_opt_state = True
        self.shard_opt_state = bool(shard_opt_state)

        # Parity attribute names of the reference.
        self.epochs = epochs
        self.scheduler_type = cfg.scheduler
        self.optimizer_type = cfg.optimizer
        self.momentum = cfg.momentum
        self.weight_decay = cfg.weight_decay
        self.lr = cfg.lr
        self.criterion_type = cfg.criterion
        self.metric = cfg.metric
        self.pred_function_type = cfg.pred_function
        self.model_dir = cfg.model_dir
        self.is_parallel = is_parallel
        self.save_history = save_history

        self.train_losses: list = []
        self.val_losses: list = []
        self.train_metrics: list = []
        self.val_metrics: list = []
        self.history: dict = {}
        self.log_every = 50 if log_every_steps is None else int(
            log_every_steps)
        self.grad_accum_steps = int(grad_accum_steps)
        self.steps_per_execution = int(steps_per_execution)
        self.grad_clip_norm = grad_clip_norm
        self.early_stop_patience = early_stop_patience
        self.save_best = bool(save_best)
        self.decay_exclude_bias_norm = bool(decay_exclude_bias_norm)
        self.nonfinite_guard = bool(nonfinite_guard)
        self.rollback_bad_steps = rollback_bad_steps
        self.rollback_lr_backoff = float(rollback_lr_backoff)
        self.save_every_steps = save_every_steps
        self.handle_preemption = bool(handle_preemption)
        self.preempted = False
        self._preempt_requested = False
        self._preempt_info: Optional[dict] = None
        # The mid-epoch record of the checkpoint a resume starts from.
        self._resume_mid: Optional[dict] = None
        self.skipped_steps: list = []
        self.rollbacks = 0
        self.reshapes: list = []
        self._skipped_base = 0
        self._best_val = math.inf
        self._bad_epochs = 0

        if isinstance(model, str):
            model = init_model(model, seed=cfg.seed, device=self.device,
                               precision=self.precision)
        elif isinstance(model, nn.Module):
            model = self._at_compute_dtype(model.to(self.device))
        else:
            raise TypeError(
                f"model must be a registry name or an nn.Module, got "
                f"{type(model).__name__}")
        self._trainable = None
        if lora is not None:
            model = self._with_lora(model, lora, cfg.seed)
        self._has_batch_norm = any(
            isinstance(m, (BatchNorm, nn.modules.batchnorm._BatchNorm))
            for m in model.modules())
        if self.dp_update == "sharded" and self._has_batch_norm:
            raise ValueError(
                "dp_update='sharded' does not support batch_stats models "
                "(per-replica BatchNorm statistics would diverge from the "
                "fused global-batch stats); use the fused step for "
                "BatchNorm models")
        self.model = model
        self._takes_targets = _module_takes_targets(model)
        # Dropout: the masks hash (seed, step, site, element), the step
        # read from a device counter that a CUDA graph of K steps advances.
        self._dropout = dropout_stream(model)
        self._step_t = None
        if self._dropout is not None:
            self._dropout.reseed(cfg.seed)
            self._step_t = torch.zeros((), dtype=torch.int64,
                                       device=self.device)
        logger.info(f"Training on device: {self.device}.")

        if label_smoothing and self._takes_targets:
            raise ValueError(
                "label_smoothing is not supported for models that "
                "compute their own loss (the chunked LM head applies "
                "plain cross entropy inside the forward)")
        self.criterion = get_criterion(cfg.criterion,
                                       label_smoothing=label_smoothing)
        self.pred_function = get_prediction_function(cfg.pred_function)
        self.metric_fn = get_metric(cfg.metric, self.pred_function)
        fin = getattr(self.metric_fn, "finalize", None)
        self._metric_finalize = (
            (lambda v: float(fin(torch.tensor(v)))) if fin is not None
            else (lambda v: v))
        if self._takes_targets and self.metric_fn is not None:
            raise ValueError(
                "metric must be None for models that compute their own "
                "loss (the forward returns a scalar, not logits to score); "
                f"got metric={cfg.metric!r}")

        self.state: Optional[TrainState] = None
        self.train_loader: Optional[Loader] = None
        self.val_loader: Optional[Loader] = None
        self._plateau: Optional[PlateauController] = None
        self._lr_scale = 1.0
        # The chunked steps' lr_scale: a device scalar, filled each epoch
        # and always multiplied in (a graph cannot branch on a host float).
        self._lr_t = torch.ones((), dtype=torch.float32, device=self.device)
        # (train | eval, input shapes) -> StepGraph; freed when fit() ends.
        self._graphs: dict = {}

        if datasets:
            train_set, val_set = datasets
            self._build_loaders(train_set, val_set, batch_size, cfg)
            self._build_state(cfg)
        else:
            logger.warning("Testing only available. No datasets in arguments.")

    def _with_lora(self, model: nn.Module, lora, seed: int) -> nn.Module:
        """The JAX package's ``model.clone(lora_rank=...)``: a train-mode
        LoRA copy of ``model`` (adapters drawn from ``seed``), its base
        frozen; ``_trainable`` names the adapters."""
        if not (hasattr(model, "lora_rank") and hasattr(model, "clone")):
            raise ValueError(
                "lora requires a model carrying the lora_* knobs "
                f"(the GPT-2 family); got {type(model).__name__}")
        from ml_trainer_tpu_torch.lora import lora_param_labels

        model = model.clone(share=False, lora_rank=int(lora.rank),
                            lora_alpha=float(lora.alpha),
                            lora_targets=tuple(lora.targets), lora_slots=0)
        init_lora(model, seed)
        self._labels = lora_param_labels(dict(model.named_parameters()))
        self._trainable = [k for k, v in self._labels.items() if v == "lora"]
        if not self._trainable:
            raise ValueError(
                "Trainer(lora=...) found no *_lora_A/*_lora_B params — do "
                "the configured targets exist on this model?")
        for k, p in model.named_parameters():
            p.requires_grad_(k in self._trainable)
        n = len(list(model.parameters()))
        logger.info(
            f"LoRA: training {len(self._trainable)} adapter leaves (rank "
            f"{lora.rank}, targets {lora.targets}); "
            f"{n - len(self._trainable)} base leaves frozen with no "
            "optimizer state.")
        return model

    def _at_compute_dtype(self, model: nn.Module) -> nn.Module:
        """A registry-built model whose ``dtype`` disagrees with an active
        policy, rebuilt at the policy's compute dtype with the same
        (float32) weights: the JAX package's ``model.clone(dtype=...)``,
        so that the module's own casts agree with the trainer's."""
        dt = self._compute_dtype
        config = getattr(model, "registry_config", None)
        if dt is None or config is None or getattr(model, "dtype", dt) == dt:
            return model
        from ml_trainer_tpu_torch.models.registry import get_model

        name, kwargs = config
        rebuilt = get_model(name, **{**kwargs, "device": self.device,
                                     "dtype": dt})
        rebuilt.load_state_dict(model.state_dict())
        return rebuilt

    # ------------------------------------------------------------------ data
    def _build_loaders(self, train_set, val_set, batch_size, cfg) -> None:
        logger.info("Loading training and validation set.")
        d = self.mesh.size * self.grad_accum_steps
        # The global batch rounds down to a multiple of the data replicas
        # x microbatch count (and up to one sample per replica per
        # microbatch), as in the reference.
        eff = max(batch_size // d, 1) * d
        if eff != batch_size:
            logger.warning(
                f"Global batch {batch_size} adjusted to {eff} to divide "
                f"across {d} data-parallel microbatches.")
        drop_last = d > 1  # equal microbatches
        self.global_batch = eff
        self.train_loader = self._make_loader(train_set, eff, drop_last,
                                              cfg.seed)
        self.val_loader = self._make_loader(val_set, eff, drop_last,
                                            cfg.seed + 1)
        if len(self.train_loader) == 0 or len(self.val_loader) == 0:
            raise ValueError(
                f"Loader yields no batches (train {len(self.train_loader)}, "
                f"val {len(self.val_loader)}): dataset smaller than the "
                f"batch {eff} with drop_last={drop_last}.")

    def _make_loader(self, dataset, batch: int, drop_last: bool, seed: int):
        """A shuffled loader of ``dataset``: the C++ ``NativeLoader`` for
        ``loader='native'``, and for 'auto' where ``native_plan`` takes
        the dataset, the library builds and the batches split evenly (a
        ragged tail would be wrapped, not short: 'auto' never changes
        the batches' count or size); else the Python ``Loader``."""
        plan = None
        if self._loader_kind in ("auto", "native"):
            plan = native_plan(dataset)
            if plan is not None and not native_available():
                plan = None
            if (plan is not None and self._loader_kind == "auto"
                    and not drop_last and len(dataset) % batch != 0):
                plan = None
            if self._loader_kind == "native" and plan is None:
                raise ValueError(
                    "loader='native' requires a uint8 NHWC ArrayDataset "
                    "with the reference augmentation pipeline (and a "
                    "working g++); got an unsupported dataset/transform")
        if plan is not None:
            logger.info("Using the native (C++) input pipeline.")
            return NativeLoader(dataset, batch_size=batch, shuffle=True,
                                drop_last=drop_last, seed=seed, **plan)
        return Loader(dataset, batch_size=batch, shuffle=True,
                      drop_last=drop_last, seed=seed)

    # ----------------------------------------------------------------- state
    def _params(self) -> dict:
        """The parameters a step updates: all of them, or with ``lora``
        the adapters."""
        params = dict(self.model.named_parameters())
        if self._trainable is None:
            return params
        return {k: params[k] for k in self._trainable}

    def _build_state(self, cfg) -> None:
        self.steps_per_epoch = len(self.train_loader)
        self.lr_schedule = make_lr_schedule(
            cfg.scheduler, cfg.lr, self.steps_per_epoch,
            total_steps=(self.steps_per_epoch * self.epochs
                         if self.epochs else None))
        # The sharded step keeps the identity slot (same state structure)
        # and clips by the global norm it sums over the replicas itself:
        # a chained clip would see one replica's shard.
        self.tx = chain(
            clip_by_global_norm(self.grad_clip_norm)
            if (self.grad_clip_norm is not None
                and self.dp_update != "sharded") else identity(),
            get_optimizer(
                cfg.optimizer, self.lr_schedule, cfg.momentum,
                cfg.weight_decay,
                decay_mask=(decay_mask_matrices_only
                            if self.decay_exclude_bias_norm else None)),
        )
        if self.lora is not None:
            # Only the adapters reach the optimizer, the clip included;
            # the base gets zero updates and no optimizer state.
            self.tx = multi_transform(
                {"lora": self.tx, "frozen": set_to_zero()}, self._labels)
        if cfg.scheduler == "ReduceLROnPlateau":
            self._plateau = PlateauController(cfg.lr)
        with torch.no_grad():
            params = {k: p.detach()
                      for k, p in self.model.named_parameters()}
            scale_cfg = self._loss_scale_cfg
            self.state = TrainState.create(
                self.tx.init(params), self.device,
                init_scale=None if scale_cfg is None else scale_cfg.init_scale)
            if self.ema_decay is not None:
                # Float32 copies of the (float32) masters.
                self.state.ema_params = {k: p.clone()
                                         for k, p in params.items()}
        n = self.mesh.size
        self._zero1 = self._bucket_plan = None
        if self.dp_update == "sharded":
            # ZeRO-1: which state leaves split over the replicas.
            self._zero1 = zero1_opt_shardings(self.state.opt_state, n)
            self._bucket_plan = plan_grad_buckets(
                params, n, bucket_bytes=int(self.bucket_mb * 2 ** 20))
            logger.info(
                f"Sharded DP update: {len(self._bucket_plan.buckets)} "
                f"reduce-scatter buckets over data={n} (bucket_mb="
                f"{self.bucket_mb}, analytic overlap fraction "
                f"{self._bucket_plan.overlap_fraction:.2f}).")

    # ------------------------------------------------------------- the step
    def _apply_model(self, model: nn.Module, x, targets=None, params=None):
        """``model(x)`` (with ``targets`` for a model that computes its
        own loss), on ``params`` (a dict of its parameters, e.g. the EMA's)
        in place of its own when given; under an active policy, on
        compute-dtype copies of the parameters (buffers as they are) and
        a floating ``x`` cast likewise, the output cast back to float32."""
        kwargs = {} if targets is None else {"targets": targets}
        dt = self._compute_dtype
        if dt is None and params is None:
            return model(x, **kwargs)
        if params is None:
            params = dict(model.named_parameters())
        if dt is None:
            return torch.func.functional_call(model, params, (x,), kwargs)
        return torch.func.functional_call(
            model, cast_floating(params, dt), (cast_floating(x, dt),),
            kwargs).float()

    def _eval_params(self, model):
        """The EMA weights when ``model`` is the trainer's own and
        ``ema_decay`` is set (the JAX package's ``_state_variables``:
        eval, ``test()``, ``predict()`` and the saved weights use them),
        else None (the model's own)."""
        if (model is self.model and self.state is not None
                and self.state.ema_params is not None):
            return self.state.ema_params
        return None

    def _forward_loss(self, x, y):
        """Loss and metric of one microbatch, the graph kept for backward."""
        if self._takes_targets:
            # The forward returns the loss; there are no logits to score.
            loss = self._apply_model(self.model, x, targets=y)
            return loss, torch.zeros((), device=loss.device)
        out = self._apply_model(self.model, x)
        loss = self.criterion(out, y)
        with torch.no_grad():
            metric = (self.metric_fn(out.detach(), y)
                      if self.metric_fn is not None
                      else torch.zeros((), device=loss.device))
        return loss, metric

    def _local_grads(self, params, x, y, scale=None, row0: int = 0):
        """Forward and backward over the ``grad_accum_steps`` microbatches
        of rows ``(x, y)``, which start at row ``row0`` of the global
        batch (the dropout masks' place): the summed gradients (taken out
        of ``.grad``; of ``loss * scale`` with a loss scale) and the
        summed, unscaled loss and metric."""
        accum = self.grad_accum_steps
        self.model.train()
        for p in params.values():
            p.grad = None
        micro = x.shape[0] // accum
        loss_sum = metric_sum = None
        for i in range(accum):
            sl = slice(i * micro, (i + 1) * micro)
            if self._dropout is not None:
                self._dropout.row0 = row0 + i * micro
            loss, metric = self._forward_loss(x[sl], y[sl])
            (loss if scale is None else loss * scale).backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            metric_sum = metric if metric_sum is None else metric_sum + metric
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        return grads, loss_sum, metric_sum

    def _replica_grads(self, params, x, y, scale=None):
        """``_local_grads`` of each replica's row block of the global
        batch, in replica order; for a BatchNorm model, of the whole
        global batch at once (global-batch statistics, as the JAX
        package's SyncBN: the replicas' blocks are equal, so the mean
        over the batch is the mean of their means)."""
        if self._has_batch_norm:
            return [self._local_grads(params, x, y, scale)]
        rows = x.shape[0] // self.mesh.size
        return [self._local_grads(params, x[j * rows:(j + 1) * rows],
                                  y[j * rows:(j + 1) * rows], scale,
                                  row0=j * rows)
                for j in range(self.mesh.size)]

    def _train_step(self, x, y, lr_scale: float):
        """One optimizer step on the global batch ``(x, y)``; returns the
        (guarded) loss and metric as device scalars.  With dropout, the
        masks' keys come from the device step counter, which the step
        then advances (a CUDA graph of K steps replays the advance; an
        eager step first sets the counter from ``state.step``)."""
        if self._dropout is not None:
            if (self.device.type != "cuda"
                    or not torch.cuda.is_current_stream_capturing()):
                self._step_t.fill_(self.state.step)
            self._dropout.begin_step(self._step_t)
        if self.dp_update == "sharded":
            out = self._sharded_train_step(x, y, lr_scale)
        else:
            out = self._fused_train_step(x, y, lr_scale)
        if self._dropout is not None:
            self._step_t.add_(1)
        return out

    def _fused_train_step(self, x, y, lr_scale: float):
        """``_train_step`` of the single-card and the fused data-parallel
        update."""
        accum = self.grad_accum_steps
        params = self._params()
        scale = self.state.loss_scale
        # The running statistics the guard restores on a skipped step.
        buffers = ({k: b.clone() for k, b in self.model.named_buffers()}
                   if self.nonfinite_guard else {})
        local = self._replica_grads(params, x, y, scale)
        with torch.no_grad():
            # One division folds the microbatch mean and the loss scale.
            denom = accum if scale is None else accum * scale
            if len(local) == 1:
                grads, loss, metric = local[0]
                if accum > 1 or scale is not None:
                    grads = {k: g / denom for k, g in grads.items()}
                if accum > 1:
                    loss, metric = loss / accum, metric / accum
            else:
                # Local-mean gradients, averaged over the replicas.
                grads = {k: col.pmean([g[k] / denom for g, _, _ in local])[0]
                         for k in params}
                loss = col.pmean([lo / accum for _, lo, _ in local])[0]
                metric = col.pmean([m / accum for _, _, m in local])[0]
            del local
            return self._apply_grads(params, grads, loss, metric, lr_scale,
                                     buffers)

    def _train_step_in_place(self, x, y, lr_t: torch.Tensor):
        """``_train_step`` with ``lr_t`` (a device scalar), its new state
        written back into the tensors the state held before (``copy_``),
        so that a CUDA graph captured over it reads and writes the same
        addresses on every replay.  The parameters and the model's
        buffers are written in place by the step itself."""
        kept = dataclasses.replace(self.state)
        loss, metric = self._train_step(x, y, lr_t)
        with torch.no_grad():
            for old, new in zip(_state_tensors(kept),
                                _state_tensors(self.state)):
                old.copy_(new)
        kept.step = self.state.step
        self.state = kept
        return loss, metric

    def _train_chunk(self, xs, ys):
        """K in-place steps over the stacked batches ``xs``/``ys``
        [K, B, ...] (the JAX package's ``multi_step``)."""
        return _summed_steps(
            lambda x, y: self._train_step_in_place(x, y, self._lr_t), xs, ys)

    def _dispatch(self, kind: str, fn, xs, ys):
        """One chunk through ``fn(xs, ys)``.  On the CPU it runs as it is.
        On the card the first chunk of each (``kind``, shapes) runs as
        real steps on a side stream, which builds the kernels, the cuBLAS
        handles and autograd's state (none of which may happen during a
        capture); then ``fn`` is captured as one CUDA graph, and every
        later chunk is one replay of it.  A failed capture or replay
        raises."""
        if self.device.type != "cuda":
            return fn(xs, ys)
        key = (kind, tuple(xs.shape), xs.dtype, tuple(ys.shape), ys.dtype)
        graph = self._graphs.get(key)
        if graph is not None:
            if kind == "train" and self._step_t is not None:
                self._step_t.fill_(self.state.step)
            out = graph.replay(xs, ys)
            if kind == "train":
                self.state.step += xs.shape[0]
            return out
        graph = StepGraph(self.device)
        out = graph.warm_up(fn, xs, ys)
        step = self.state.step
        graph.capture(fn, xs, ys)
        self.state.step = step  # the capture ran the steps' Python only
        self._graphs[key] = graph
        return out

    @torch.no_grad()
    def _sharded_train_step(self, x, y, lr_scale: float):
        """The bucketed reduce-scatter + 1/N-shard update step
        (``dp_update="sharded"``), the JAX package's
        ``_make_sharded_train_step`` with its replicas given as lists."""
        n, plan, accum = self.mesh.size, self._bucket_plan, self.grad_accum_steps
        clip = self.grad_clip_norm
        params = self._params()
        names = list(params)
        flags = dict(zip(names, plan.sharded))
        scale = self.state.loss_scale
        with torch.enable_grad():
            local = self._replica_grads(params, x, y, scale)
        # Epoch accounting reads global means.
        loss = col.pmean([lo / accum for _, lo, _ in local])[0]
        metric = col.pmean([m / accum for _, _, m in local])[0]
        # (1) one reduce-scatter per bucket of the summed local-mean
        # gradients; each replica keeps its dim-0 shard, summed.
        g = bucketed_reduce_scatter([[gr[k] for k in names]
                                     for gr, _, _ in local], plan)
        del local
        rep_idx = [i for i, s in enumerate(plan.sharded) if not s]
        if rep_idx:
            # Leaves whose dim 0 does not divide by n: ONE psum over their
            # concatenation, a replicated update.
            flat = col.psum([torch.cat([gj[i].reshape(-1) for i in rep_idx])
                             for gj in g])
            for j, gj in enumerate(g):
                off = 0
                for i in rep_idx:
                    size = gj[i].numel()
                    gj[i] = flat[j][off:off + size].reshape(gj[i].shape)
                    off += size
        # (2) unscale: the psum/scatter summed n replicas' local means of
        # accum microbatches (of the scaled loss: /scale folds into the
        # same division); then each replica's squared-norm parts.
        dev = self.device
        denom = float(n * accum)
        denom_t = torch.full((), denom, dtype=torch.float32, device=dev)
        if scale is not None:
            denom = denom_t = denom_t * scale
        grads, sq_loc, sq_rep = [], [], []
        for gj in g:
            if self.fused_adam:
                # K4: one launch over the replica's leaves, the sums added
                # in leaf order as below.
                outs, _, (loc, rep) = unscale_sqsum_list(
                    gj, denom, sharded=plan.sharded,
                    compute_sq=clip is not None)
                grads.append(dict(zip(names, outs)))
                sq_loc.append(loc)
                sq_rep.append(rep)
                continue
            leaves = {}
            loc = torch.zeros((), dtype=torch.float32, device=dev)
            rep = torch.zeros((), dtype=torch.float32, device=dev)
            for name, gi in zip(names, gj):
                g_u = torch.div(gi, denom_t)
                s = (torch.sum(torch.square(g_u.to(torch.float32)))
                     if clip is not None else None)
                leaves[name] = g_u
                if s is not None:
                    loc, rep = (loc + s, rep) if flags[name] else (loc, rep + s)
            grads.append(leaves)
            sq_loc.append(loc)
            sq_rep.append(rep)
        del g
        # (3) the global clip factor, from the psum of the shards' squared
        # sums plus the replicated leaves' (counted once).
        factors = [None] * n
        if clip is not None:
            clip_t = torch.full((), float(clip), dtype=torch.float32,
                                device=dev)
            loc_sum = col.psum(sq_loc)
            factors = [torch.div(clip_t, torch.maximum(
                torch.sqrt(loc_sum[j] + sq_rep[j]), clip_t))
                for j in range(n)]
        # (4) each replica updates its shard of the params and moments.
        full = {k: p.detach() for k, p in params.items()}
        state = self.state
        old_p = [replica_view(full, flags, n, j) for j in range(n)]
        old_opt = [replica_view(state.opt_state, self._zero1, n, j)
                   for j in range(n)]
        new_p, new_opt, checked = [], [], []
        for j in range(n):
            if self.fused_adam:
                pj, oj = self._fused_tail(grads[j], old_p[j], old_opt[j],
                                          factors[j], lr_scale)
                checked.append(grads[j])
            else:
                gj = grads[j] if factors[j] is None else {
                    k: t * factors[j] for k, t in grads[j].items()}
                updates, oj = self.tx.update(gj, old_opt[j], old_p[j])
                pj = {k: old_p[j][k] + u * lr_scale
                      for k, u in updates.items()}
                checked.append(gj)
            new_p.append(pj)
            new_opt.append(oj)
        if self.nonfinite_guard:
            # A non-finite value lives only in its owner's shard: every
            # replica must consent for the step to be taken.
            oks = []
            for gj in checked:
                ok = torch.isfinite(loss)
                for t in gj.values():
                    ok = ok & torch.isfinite(t).all()
                oks.append(ok.to(torch.float32))
            ok = col.psum(oks)[0] > (n - 0.5)

            def sel(a, b):
                return torch.where(ok, a, b)

            new_p = [tree_map(sel, new_p[j], old_p[j]) for j in range(n)]
            new_opt = [tree_map(sel, new_opt[j], old_opt[j])
                       for j in range(n)]
            self._count_skip(ok)
            loss = torch.where(ok, loss, torch.zeros_like(loss))
            metric = torch.where(ok, metric, torch.zeros_like(metric))
        # (5) the fresh weights: one all-gather per bucket.
        gathered = bucketed_all_gather([[pj[k] for k in names] for pj in new_p],
                                       plan, [full[k].shape for k in names])
        # The replicas share the model: replica 0's copy is everyone's.
        for k, leaf in zip(names, gathered[0]):
            params[k].copy_(leaf)
        if state.ema_params is not None:
            # From the gathered weights; a skipped step keeps the old EMA.
            new_ema = self._ema_update(state.ema_params, full)
            if self.nonfinite_guard:
                new_ema = tree_map(sel, new_ema, state.ema_params)
            state.ema_params = new_ema
        state.opt_state = join_replica_views(new_opt, self._zero1)
        if self.fused_adam and not self.nonfinite_guard:
            # K5's moments are views of one buffer per replica, and a
            # replicated leaf joins as replica 0's view: copy such a leaf
            # out, or it would keep that whole buffer alive.
            state.opt_state = tree_map(_own_storage, state.opt_state)
        state.step += 1
        return loss, metric

    def _fused_tail(self, grads, params, opt_state, factor, lr_scale):
        """K5 over one replica's leaves (shards and replicated leaves) in
        one launch, the optimizer state rebuilt in the unfused chain's
        structure: ``({}, ({count, mu, nu}, {count}))``."""
        _, (adam, sched) = opt_state
        count, bc1, bc2, step_size, sched_count = adam_scalars(
            adam["count"], sched["count"], self.lr_schedule)
        lr_t = torch.full((), float(lr_scale), dtype=torch.float32,
                          device=self.device)
        names = list(grads)
        p_n, mu_n, nu_n, _ = fused_adam_update_list(
            [grads[k] for k in names], [params[k] for k in names],
            [adam["mu"][k] for k in names], [adam["nu"][k] for k in names],
            bc1=bc1, bc2=bc2, step_size=step_size, lr_scale=lr_t,
            factor=factor)
        new_opt = ({}, ({"count": count, "mu": dict(zip(names, mu_n)),
                         "nu": dict(zip(names, nu_n))},
                        {"count": sched_count}))
        return dict(zip(names, p_n)), new_opt

    def _apply_grads(self, params, grads, loss, metric, lr_scale: float,
                     buffers: dict):
        """The update of the fused step; the guard's revert covers the
        model's ``buffers`` as they were before the forward."""
        state = self.state
        old = {k: p.detach() for k, p in params.items()}
        updates, new_opt = self.tx.update(grads, state.opt_state, old)
        # A device scalar (the chunked steps') is always multiplied in, as
        # the JAX step does; a host float only when it is not 1.0 (x 1.0
        # is exact either way).
        if isinstance(lr_scale, torch.Tensor) or lr_scale != 1.0:
            updates = {k: u * lr_scale for k, u in updates.items()}
        new_params = {k: old[k] + u for k, u in updates.items()}
        new_ema = None
        if state.ema_params is not None:
            # Over every parameter, the frozen ones too (as in JAX).
            new_ema = self._ema_update(state.ema_params, {
                **{k: p.detach() for k, p in self.model.named_parameters()},
                **new_params})
        if self.nonfinite_guard:
            ok = torch.isfinite(loss)
            for g in grads.values():
                ok = ok & torch.isfinite(g).all()

            def sel(n, o):
                return torch.where(ok, n, o)

            new_params = tree_map(sel, new_params, old)
            new_opt = tree_map(sel, new_opt, state.opt_state)
            if new_ema is not None:
                new_ema = tree_map(sel, new_ema, state.ema_params)
            live = dict(self.model.named_buffers())
            for k, before in buffers.items():
                live[k].copy_(sel(live[k], before))
            self._count_skip(ok)
            # A skipped step adds zero to the epoch's sums.
            loss = torch.where(ok, loss, torch.zeros_like(loss))
            metric = torch.where(ok, metric, torch.zeros_like(metric))
        for k, p in params.items():
            p.copy_(new_params[k])
            p.grad = None
        state.opt_state = new_opt
        state.ema_params = new_ema
        state.step += 1
        return loss, metric

    def _ema_update(self, ema: dict, params: dict) -> dict:
        """``d * e + (1 - d) * p`` per leaf, in the JAX package's order
        (a multiply, then the add of ``(1 - d) * p``; no ``lerp``)."""
        d = self.ema_decay
        return {k: d * e + (1.0 - d) * params[k] for k, e in ema.items()}

    def _count_skip(self, ok: torch.Tensor) -> None:
        """The guard's counters after a step whose finiteness is ``ok``,
        with the loss scale's arithmetic folded in (the JAX package's
        ``_scale_streak_updates``): an overflow is the scale's fault
        while the scale can still back off, so it does NOT advance the
        rollback streak; the scale halves on it and doubles after
        ``growth_interval`` finite steps.  Device-side selects only."""
        state, cfg = self.state, self._loss_scale_cfg
        bad = (~ok).to(torch.int32)
        state.skipped_steps = state.skipped_steps + bad
        if cfg is None:
            state.bad_streak = (state.bad_streak + 1) * bad
            return
        scale, good = state.loss_scale, state.good_steps
        attributed = scale > cfg.min_scale
        state.bad_streak = torch.where(
            ok, torch.zeros_like(state.bad_streak),
            torch.where(attributed, state.bad_streak, state.bad_streak + 1))
        grown = good + 1 >= cfg.growth_interval
        state.loss_scale = torch.where(
            ok,
            torch.where(grown,
                        torch.clamp(scale * cfg.growth_factor,
                                    max=cfg.max_scale),
                        scale),
            torch.clamp(scale * cfg.backoff_factor, min=cfg.min_scale))
        state.good_steps = torch.where(ok & ~grown, good + 1,
                                       torch.zeros_like(good))

    @torch.no_grad()
    def _eval_step(self, model, x, y):
        params = self._eval_params(model)
        if self._computes_own_loss(model):
            loss = self._apply_model(model, x, targets=y, params=params)
            return loss, torch.zeros((), device=loss.device)
        out = self._apply_model(model, x, params=params)
        loss = self.criterion(out, y)
        metric = (self.metric_fn(out, y) if self.metric_fn is not None
                  else torch.zeros((), device=loss.device))
        return loss, metric

    def _computes_own_loss(self, model) -> bool:
        return (self._takes_targets if model is self.model
                else _module_takes_targets(model))

    # ------------------------------------------------------------------ loops
    def _postfix_metric(self, metric_sum, seen: int, n: int) -> float:
        """Running metric for the progress log: the reference's
        average-over-the-full-epoch display, except that a finalized
        metric divides by the batches seen."""
        if getattr(self.metric_fn, "finalize", None) is not None:
            return self._metric_finalize(float(metric_sum) / max(seen, 1))
        return float(metric_sum) / n

    def _log_progress(self, what: str, done: int, n: int, loss_sum,
                      metric_sum, last_loss) -> None:
        if self.metric:
            logger.info(
                f"{what} {done}/{n}: loss={float(loss_sum) / n:.6f} "
                f"{self.metric}={self._postfix_metric(metric_sum, done, n):.6f}")
        else:
            logger.info(f"{what} {done}/{n}: loss={float(last_loss):.6f}")

    def _dispatches(self, loader, kind: str, chunk, single):
        """The epoch's dispatches as ``(loss, metric, steps)``: each batch
        through ``single`` when ``steps_per_execution`` is 1; else each
        full chunk of K batches through ``chunk`` (``_dispatch``), then
        the ragged batches and the final partial chunk batch by batch
        through ``single`` (the JAX package's ``_train_one_epoch_multi``
        and its validation twin, ``_eval_multi_step``)."""
        k = self.steps_per_execution
        if k == 1:
            for x, y in prefetch_to_device(loader, size=2,
                                           device=self.device):
                yield (*single(x, y), 1)
            return
        tail: list = []  # filled once the chunks are drained
        for xs, ys in prefetch_to_device(_chunk_batches(loader, k, tail),
                                         size=2, device=self.device):
            yield (*self._dispatch(kind, chunk, xs, ys), k)
        for x, y in prefetch_to_device(iter(tail), size=2,
                                       device=self.device):
            yield (*single(x, y), 1)

    def _run_epoch(self, what: str, n: int, dispatches, done: int = 0,
                   sums=None, after=None):
        """Sum the dispatches' losses and metrics, each dispatch's sum
        added to the epoch's (the JAX package's order), logging where a
        multiple of ``max(log_every, K)`` steps fell inside the last
        dispatch and at the end: the only host reads of the epoch.  A
        resumed epoch starts at batch ``done`` from the saved ``sums``.
        ``after(done, synced, loss_sum, metric_sum)`` runs after each
        dispatch (``synced``: it logged) and ends the epoch there when
        it returns True."""
        every = max(self.log_every, self.steps_per_execution)
        loss_sum, metric_sum = sums or (
            torch.zeros((), device=self.device) for _ in range(2))
        for loss, metric, steps in dispatches:
            loss_sum = loss_sum + loss
            metric_sum = metric_sum + metric
            done += steps
            synced = done % every < steps or done == n
            if synced:
                # Without a metric: the last dispatch's mean loss.
                self._log_progress(what, done, n, loss_sum, metric_sum,
                                   loss if steps == 1 else loss / steps)
            if after is not None and after(done, synced, loss_sum,
                                           metric_sum):
                break
        return loss_sum, metric_sum

    def _train_one_epoch(self, epoch: int) -> None:
        self.train_loader.set_epoch(epoch - 1)
        n = len(self.train_loader)
        epoch_t0 = time.time()
        start, sums = 0, None
        mid, self._resume_mid = self._resume_mid, None
        if mid is not None and int(mid["epoch"]) == epoch:
            # Mid-epoch resume from the record's batch cursor and sums
            # (float32 -> JSON float64 -> float32 is exact).
            start = int(mid["batches_done"])
            sums = tuple(torch.tensor(float(mid[k]), dtype=torch.float32,
                                      device=self.device)
                         for k in ("loss_sum", "metric_sum"))
            self._skipped_base = int(mid.get("skipped_base", 0))
            logger.info(f"Mid-epoch resume: epoch {epoch} continues at "
                        f"batch {start + 1}/{n}.")
        batches = iter(self.train_loader)
        # Consumed, not skipped: the transforms' rng advances as in the
        # uninterrupted run, so the remaining batches are its batches.
        for _ in range(start):
            next(batches)
        self._lr_t.fill_(self._lr_scale)
        if self.steps_per_execution == 1:
            plan = active_plan()
            gsteps = itertools.count((epoch - 1) * n + start + 1)

            def step(x, y):
                gstep = next(gsteps)  # the 1-based global train step
                if plan is not None:
                    if plan.fire("preempt", step=gstep) is not None:
                        self._request_preemption("injected preempt")
                    if plan.fire("nan_grad", step=gstep) is not None:
                        x = _poison_batch(x)
                return self._train_step(x, y, self._lr_scale)
        else:  # the tail keeps the state where the chunks' graph reads it
            def step(x, y):
                return self._train_step_in_place(x, y, self._lr_t)

        def after(done, synced, loss_sum, metric_sum) -> bool:
            if self.steps_per_execution > 1:
                # No batch cursor to save: a resume restarts the epoch
                # from the last epoch-boundary checkpoint.
                self.preempted = self._preempt_requested
                return self.preempted
            if synced:
                self._maybe_rollback()
            if (self.save_every_steps and done % self.save_every_steps == 0
                    and done < n):
                self._save_mid_epoch(epoch, done, loss_sum, metric_sum)
            if self._preempt_requested:
                # The in-flight step finished: an emergency checkpoint
                # with the batch cursor, then out.
                self._save_mid_epoch(epoch, done, loss_sum, metric_sum)
                wait_for_checkpoints()
                self._preempt_info = {"epoch": epoch, "batches_done": done}
                self.preempted = True
            return self.preempted

        loss_sum, metric_sum = self._run_epoch(
            f"epoch {epoch} train", n, self._dispatches(
                batches, "train", self._train_chunk, step), start, sums,
            after)
        if self.preempted:
            return  # a partial epoch: no history entry
        self.train_losses.append(float(loss_sum) / n)
        cum = int(self.state.skipped_steps)
        self.skipped_steps.append(cum - self._skipped_base)
        self._skipped_base = cum
        dt = time.time() - epoch_t0
        logger.info(
            f"Epoch {epoch}: {n * self.global_batch / max(dt, 1e-9):,.0f} "
            f"samples/s ({dt:.1f}s, global batch {self.global_batch})")
        if self.metric:
            self.train_metrics.append(
                self._metric_finalize(float(metric_sum) / n))

    def _evaluate(self, model, loader, what: str, dispatches=None):
        """Mean loss and metric of ``model`` over ``loader``, batch by
        batch, or through ``dispatches`` (the validation's chunks)."""
        n = len(loader)
        if self._computes_own_loss(model) and self.metric_fn is not None:
            # The constructor's guard covers only the trainer's own model;
            # a made-up 0.0 metric must not pass for a measurement.
            raise ValueError(
                "metric must be None when evaluating a model that computes "
                "its own loss (its forward returns a scalar, not logits)")
        model.eval()
        if dispatches is None:
            dispatches = ((*self._eval_step(model, x, y), 1)
                          for x, y in prefetch_to_device(
                              loader, size=2, device=self.device))
        loss_sum, metric_sum = self._run_epoch(what, n, dispatches)
        return float(loss_sum) / n, float(metric_sum) / n

    def _validate_one_epoch(self) -> None:
        def step(x, y):
            return self._eval_step(self.model, x, y)

        loss, metric = self._evaluate(
            self.model, self.val_loader, "validation", self._dispatches(
                self.val_loader, "eval",
                lambda xs, ys: _summed_steps(step, xs, ys), step))
        self.val_losses.append(loss)
        if self.metric:
            self.val_metrics.append(self._metric_finalize(metric))

    # ------------------------------------------------------------------- fit
    def fit(self, resume: bool = False) -> None:
        """Train ``epochs`` epochs, validating after each, then exporting
        the weights (``model.pth``) and writing a full-state checkpoint
        (``<model_dir>/checkpoints/checkpoint_<epoch>``, on the writer
        thread).  ``resume=True`` restarts from the newest valid
        checkpoint (corrupt ones quarantined), mid-epoch where it was
        written mid-epoch, bit for bit.  With ``handle_preemption`` (the
        default) SIGTERM/SIGINT finish the in-flight step, write an
        emergency checkpoint and ``PREEMPTED.json`` and return with
        ``self.preempted`` True (under ``steps_per_execution`` > 1 at the
        next dispatch, with no mid-epoch checkpoint)."""
        if self.state is None:
            raise ValueError("fit() needs datasets; this Trainer was built "
                             "for testing only")
        self.preempted = False
        self._preempt_requested = False
        self._preempt_info = None
        prev_handlers = self._install_preempt_handlers()
        try:
            self._fit(resume)
        finally:
            self._restore_preempt_handlers(prev_handlers)
            self._graphs.clear()  # their memory pools with them
            self.clear()

    def _install_preempt_handlers(self) -> dict:
        """SIGTERM and SIGINT to ``_on_preempt_signal``; the handlers they
        replace, by signal.  Python runs handlers on the main thread
        only, so on any other thread nothing is installed (the injected
        ``preempt`` fault still works)."""
        if (not self.handle_preemption
                or threading.current_thread() is not threading.main_thread()):
            return {}
        return {sig: signal.signal(sig, self._on_preempt_signal)
                for sig in (signal.SIGTERM, signal.SIGINT)}

    @staticmethod
    def _restore_preempt_handlers(prev: dict) -> None:
        for sig, handler in prev.items():
            if handler is not None:  # None: installed outside Python
                signal.signal(sig, handler)

    def _on_preempt_signal(self, signum, frame) -> None:
        self._request_preemption(f"signal {signum}")

    def _request_preemption(self, reason: str) -> None:
        if not self._preempt_requested:
            logger.warning(
                f"Preemption requested ({reason}): finishing the in-flight "
                "step, then writing an emergency checkpoint.")
        self._preempt_requested = True

    def _ckpt_dir(self) -> str:
        return os.path.join(self.model_dir, "checkpoints")

    def _fit(self, resume: bool) -> None:
        logger.info("Start training..")
        start_epoch = self._resume_from_latest() if resume else 1
        for epoch in range(start_epoch, self.epochs + 1):
            # Before training, so that a resumed run that is already out
            # of patience trains (and exports) nothing.
            if self._out_of_patience():
                break
            logger.info(f"{'-' * 30} EPOCH {epoch} / {self.epochs} "
                        f"{'-' * 30}")
            self._train_one_epoch(epoch)
            if self.preempted:
                self._write_preempt_marker()
                logger.warning(
                    "Preempted: emergency checkpoint committed; exiting "
                    "fit() cleanly (resume with fit(resume=True)).")
                break
            self.clear()
            self._validate_one_epoch()
            self.clear()
            if self._plateau is not None:
                self._lr_scale = self._plateau.update(self.val_losses[-1])
            improved = self.val_losses[-1] < self._best_val
            if improved:
                self._best_val = self.val_losses[-1]
                self._bad_epochs = 0
            else:
                self._bad_epochs += 1
            self.save_model(self.model_dir)
            if improved and self.save_best:
                self.save_model(os.path.join(self.model_dir, "best"))
            # The host copy blocks; the write runs while the next epoch
            # trains, and the end of fit() joins it.
            save_checkpoint(self._ckpt_dir(),
                            state_tree(self.state, self.model),
                            self._partial_history(), epoch, block=False)
            if self.metric:
                logger.info(f"train loss: {self.train_losses[-1]} - "
                            f"train {self.metric}: {self.train_metrics[-1]}")
                logger.info(f"valid loss: {self.val_losses[-1]} - "
                            f"valid {self.metric}: {self.val_metrics[-1]}\n\n")
            else:
                logger.info(f"train loss: {self.train_losses[-1]}")
                logger.info(f"valid loss: {self.val_losses[-1]}\n\n")
            if self._out_of_patience():
                break
        self.history = {
            "epochs": [*range(1, len(self.train_losses) + 1)],
            "train_loss": self.train_losses,
            "val_loss": self.val_losses,
            "train_metric": self.train_metrics,
            "val_metric": self.val_metrics,
            "metric_type": self.metric,
            "skipped_steps": self.skipped_steps,
            "rollbacks": self.rollbacks,
            "reshapes": self.reshapes,
        }
        if self.save_history:
            self.save_history_(self.model_dir)
        wait_for_checkpoints()
        logger.info("Training Complete.")

    def _out_of_patience(self) -> bool:
        stop = (self.early_stop_patience is not None
                and self._bad_epochs >= self.early_stop_patience)
        if stop:
            logger.info(
                f"Early stop: no val-loss improvement in {self._bad_epochs} "
                f"epochs (best {self._best_val:.6f}).")
        return stop

    # ------------------------------------------------------------ resilience
    def _partial_history(self) -> dict:
        """The history and the host-side scalars a resume needs, as a
        checkpoint's manifest records them."""
        h = {
            "train_loss": self.train_losses,
            "val_loss": self.val_losses,
            "train_metric": self.train_metrics,
            "val_metric": self.val_metrics,
            "metric_type": self.metric,
            "lr_scale": self._lr_scale,
            "skipped_steps": self.skipped_steps,
            "rollbacks": self.rollbacks,
            "reshapes": self.reshapes,
        }
        if self._plateau is not None:
            h["plateau"] = {
                "best": self._plateau.best,
                "num_bad_epochs": self._plateau.num_bad_epochs,
                "scale": self._plateau.scale,
            }
        h["early_stop"] = {"best_val": self._best_val,
                           "bad_epochs": self._bad_epochs}
        return h

    def _apply_resume_scalars(self, saved: dict) -> None:
        """Re-install the host-side scalars of ``_partial_history``."""
        self.train_losses = list(saved.get("train_loss", []))
        self.val_losses = list(saved.get("val_loss", []))
        self.train_metrics = list(saved.get("train_metric", []))
        self.val_metrics = list(saved.get("val_metric", []))
        self.skipped_steps = list(saved.get("skipped_steps", []))
        self.rollbacks = int(saved.get("rollbacks", 0))
        self.reshapes = list(saved.get("reshapes", []))
        self._lr_scale = float(saved.get("lr_scale", 1.0))
        plateau = saved.get("plateau", {})
        if self._plateau is not None:
            self._plateau.best = float(plateau.get("best", np.inf))
            self._plateau.num_bad_epochs = int(
                plateau.get("num_bad_epochs", 0))
            self._plateau.scale = float(plateau.get("scale", 1.0))
        early = saved.get("early_stop", {})
        self._best_val = float(early.get("best_val", np.inf))
        self._bad_epochs = int(early.get("bad_epochs", 0))

    def _save_mid_epoch(self, epoch: int, batches_done: int, loss_sum,
                        metric_sum) -> None:
        """A checkpoint of epoch ``epoch`` in progress, ``batches_done``
        batches trained: its ``mid_epoch`` record holds the batch cursor
        and the epoch's sums, so that ``fit(resume=True)`` continues bit
        for bit; the end-of-epoch save overwrites the same directory.
        One host read of the two sums."""
        hist = self._partial_history()
        hist["mid_epoch"] = {
            "epoch": int(epoch),
            "batches_done": int(batches_done),
            "loss_sum": float(loss_sum),
            "metric_sum": float(metric_sum),
            "skipped_base": int(self._skipped_base),
        }
        save_checkpoint(self._ckpt_dir(), state_tree(self.state, self.model),
                        hist, epoch, block=False)

    def _maybe_rollback(self) -> bool:
        """Rollback to the last good state: after ``rollback_bad_steps``
        consecutive skipped steps, restore the newest valid checkpoint
        (corrupt ones quarantined) and scale the LR by
        ``rollback_lr_backoff``.  Called at the ``log_every`` cadence;
        one host read of the streak."""
        if self.rollback_bad_steps is None:
            return False
        streak = int(self.state.bad_streak)
        if streak < self.rollback_bad_steps:
            return False
        self._lr_scale *= self.rollback_lr_backoff
        self.rollbacks += 1
        wait_for_checkpoints()  # the writes in flight must land first
        latest = latest_valid_checkpoint(self._ckpt_dir())
        if latest is None:
            # The guard reverted every bad update: the live state is the
            # last good one.
            logger.warning(
                f"Rollback: {streak} consecutive non-finite steps and no "
                f"valid checkpoint; LR scale backed off to "
                f"{self._lr_scale:.4g}, continuing from current params.")
            self.state.bad_streak.zero_()
            return True
        # The cumulative skipped count survives (diagnostics); the streak
        # restarts: the restored counters predate the event.
        skipped_now = self.state.skipped_steps.clone()
        load_state_tree(self.state, self.model, restore_checkpoint(latest)[0])
        self.state.skipped_steps.copy_(skipped_now)
        self.state.bad_streak.zero_()
        self._reseed_loss_scale()
        logger.warning(
            f"Rollback: {streak} consecutive non-finite steps; restored "
            f"{latest} and backed LR off to scale {self._lr_scale:.4g}.")
        return True

    def _write_preempt_marker(self) -> None:
        """``PREEMPTED.json``: the run left through the preemption path
        (its emergency checkpoint committed), not by a crash;
        ``fit(resume=True)`` logs and removes it."""
        ckpt_dir = self._ckpt_dir()
        os.makedirs(ckpt_dir, exist_ok=True)
        info = dict(self._preempt_info or {}, time=time.time(), mesh=None)
        tmp = os.path.join(ckpt_dir, PREEMPT_MARKER + ".tmp")
        with open(tmp, "w") as fp:
            json.dump(info, fp)
        os.replace(tmp, os.path.join(ckpt_dir, PREEMPT_MARKER))

    def _consume_preempt_marker(self) -> None:
        marker = os.path.join(self._ckpt_dir(), PREEMPT_MARKER)
        if not os.path.exists(marker):
            return
        with open(marker) as fp:
            info = json.load(fp)
        logger.info(f"Clean preemption exit detected ({info}); resuming "
                    "from the emergency checkpoint.")
        os.remove(marker)

    def _reseed_loss_scale(self) -> None:
        """After a restore: a checkpoint without a loss scale (an fp32
        run's) leaves a zero one; start it at the configured scale."""
        if self.state.loss_scale is None:
            return
        if float(self.state.loss_scale) <= 0.0:
            self.state.loss_scale.fill_(self._loss_scale_cfg.init_scale)
            self.state.good_steps.zero_()

    def _require_mid_resume_support(self) -> None:
        if self.steps_per_execution > 1:
            raise ValueError(
                "the latest checkpoint is mid-epoch (written by "
                "save_every_steps or a preemption exit), which resumes "
                "through the per-batch dispatch path; restart with "
                "steps_per_execution=1 to continue it")

    def _resume_from_latest(self) -> int:
        """Restore the newest valid checkpoint into the live state; the
        epoch to start from (1 when there is none)."""
        self._consume_preempt_marker()
        latest = latest_valid_checkpoint(self._ckpt_dir())
        if latest is None:
            return 1
        tree, saved, done_epoch = restore_checkpoint(latest)
        mid = saved.get("mid_epoch")
        if mid is not None:
            self._require_mid_resume_support()
        load_state_tree(self.state, self.model, tree)
        self._apply_resume_scalars(saved)
        self._skipped_base = int(self.state.skipped_steps)
        self._reseed_loss_scale()
        if mid is not None:
            # Re-enter the record's epoch at its batch cursor.
            self._resume_mid = dict(mid)
            logger.info(f"Resuming mid-epoch {mid['epoch']} at batch "
                        f"{mid['batches_done']} ({latest}).")
            return int(mid["epoch"])
        logger.info(f"Resuming from epoch {done_epoch + 1} ({latest}).")
        return done_epoch + 1

    # ------------------------------------------------------------------ test
    def _resolve_model(self, model) -> nn.Module:
        """``test()``'s and ``predict()``'s ``model``: None (the trained
        model, served with the EMA weights when ``ema_decay`` is set), a
        ``LoadedModel`` from ``load_model``, an ``nn.Module``, or a
        ``state_dict`` for a copy of this trainer's model; on the
        trainer's device."""
        if model is None:
            return self.model
        if isinstance(model, LoadedModel):
            module = model.module
        elif isinstance(model, nn.Module):
            module = model
        elif isinstance(model, dict):
            module = copy.deepcopy(self.model)
            module.load_state_dict(model)
        else:
            raise TypeError(
                f"Cannot interpret model argument of type {type(model)}")
        return module.to(self.device)

    def test(self, model=None, test_loader=None):
        """Loss (and metric) of ``model`` over ``test_loader`` with this
        trainer's criterion and metric; ``model`` as ``_resolve_model``
        takes it."""
        logger.info("Testing..")
        module = self._resolve_model(model)
        if len(test_loader) == 0:
            raise ValueError("test_loader yields no batches")
        loss, metric = self._evaluate(module, test_loader, "test")
        if self.metric:
            return loss, self._metric_finalize(metric)
        return loss

    @torch.no_grad()
    def predict(self, loader, model=None, apply_pred_function: bool = True):
        """The model's outputs for every batch of ``loader``, in order, as
        one numpy array [N, ...] (the JAX package's ``predict``).
        ``model`` resolves as in ``test()`` (None: the trained model, with
        the EMA weights when ``ema_decay`` is set).  With
        ``apply_pred_function`` the trainer's prediction function
        (softmax, logsoftmax or None) maps the logits, as the metric sees
        them.  Batches may be ``(x, y)`` pairs or bare ``x``; labels are
        ignored.  A model that computes its own loss has no outputs to
        return and is refused."""
        module = self._resolve_model(model)
        if self._computes_own_loss(module):
            raise ValueError(
                "predict() needs model outputs; this model computes its "
                "own loss (build it with loss_chunk=0 for inference)")
        params = self._eval_params(module)
        pred_fn = self.pred_function if apply_pred_function else None
        module.eval()
        outs = []
        for batch in loader:
            x = batch[0] if isinstance(batch, (tuple, list)) else batch
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x))
            x = x.to(self.device)
            out = self._apply_model(module, x, params=params)
            if pred_fn is not None:
                out = pred_fn(out)
            outs.append(out.cpu().numpy())
        if not outs:
            raise ValueError("loader yields no batches")
        return np.concatenate(outs, axis=0)

    # ----------------------------------------------------------- persistence
    def save_model(self, model_dir: str) -> None:
        """The weights as a torch ``state_dict`` in
        ``<model_dir>/model.pth`` (the reference's own format); the EMA
        weights in place of the parameters when ``ema_decay`` is set."""
        logger.info("Saving the model.")
        os.makedirs(model_dir, exist_ok=True)
        served = self._eval_params(self.model) or {}
        state = {k: served.get(k, v).detach().cpu() for k, v in
                 self.model.state_dict().items()}
        tmp = os.path.join(model_dir, MODEL_FILE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(model_dir, MODEL_FILE))

    def export_lora(self, path: str, name: Optional[str] = None) -> dict:
        """Write the trained adapter as one ``.npz`` artifact, the unit
        ``Server.load_adapter`` hot-loads: every ``*_lora_A``/``_B`` leaf
        plus the meta (rank, alpha, targets, the frozen base's
        fingerprint).  Requires ``Trainer(lora=...)``; returns the meta."""
        if self.lora is None:
            raise ValueError(
                "export_lora requires Trainer(lora=LoraConfig(...))")
        if self.state is None:
            raise ValueError("trainer has no state (datasets were not given)")
        from ml_trainer_tpu_torch.convert import variables_to_jax
        from ml_trainer_tpu_torch.lora import export_lora_artifact

        meta = export_lora_artifact(variables_to_jax(self.model)["params"],
                                    self.lora, path, name=name)
        logger.info(f"LoRA adapter exported -> {path} ({meta['n_leaves']} "
                    f"leaves, rank {meta['rank']}).")
        return meta

    def export_torch(self, path: str, ddp_prefix: bool = False,
                     spatial_inputs=None) -> str:
        """Write the weights as the reference's torch ``model.pth``, the
        file the JAX package's ``export_torch`` writes for the same
        weights (``checkpoint/torch_export.py``): ``ddp_prefix=True``
        writes DDP's ``module.`` keys; ``spatial_inputs`` maps a dense
        layer after a conv stack to its (C, H, W) input (default:
        MLModel's ``fc1``; ``{}`` for none).  With ``ema_decay`` set, the
        EMA weights.  A transformer's or a ResNet's nested tree raises
        ``ValueError``, as in the JAX package."""
        from ml_trainer_tpu_torch.checkpoint.torch_export import (
            save_torch_checkpoint,
        )
        from ml_trainer_tpu_torch.convert import variables_to_jax

        variables = variables_to_jax(self.model,
                                     self._eval_params(self.model))
        return save_torch_checkpoint(path, variables,
                                     spatial_inputs=spatial_inputs,
                                     ddp_prefix=ddp_prefix)

    def save_history_(self, model_dir: str) -> None:
        """``history.pkl`` (the reference's name, so ``load_history``
        round-trips) plus a ``history.json`` mirror."""
        logger.info("Saving the training history.")
        os.makedirs(model_dir, exist_ok=True)
        with open(os.path.join(model_dir, "history.pkl"), "wb") as fp:
            pickle.dump(self.history, fp)
        tmp = os.path.join(model_dir, "history.json.tmp")
        with open(tmp, "w", encoding="utf-8") as fp:
            json.dump(self.history, fp, default=float, indent=1)
        os.replace(tmp, os.path.join(model_dir, "history.json"))

    def clear(self) -> None:
        """GC pass, and the CUDA caching allocator's free blocks back."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def validate_kwargs(self, kwargs, allowed_kwargs,
                        error_message="Keyword argument not understood:"):
        """Parity shim of the reference."""
        validate_kwargs(kwargs, allowed_kwargs, error_message)

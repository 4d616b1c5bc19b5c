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
  the epoch's end.

The model runs on the CUDA card unless ``device="cpu"`` (or a CPU
``backend``) is asked for.  A model named from the registry is built by
``init_gpt2``'s seeded initializer; an ``nn.Module`` is trained as
given (moved to the device).  Knobs not ported yet are accepted at their
defaults and raise ``NotImplementedError`` naming ROADMAP.md otherwise.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import os
import pickle
import time
from typing import Any, Optional

import torch
from torch import nn

from ml_trainer_tpu_torch.config import TrainerConfig, validate_kwargs
from ml_trainer_tpu_torch.convert import init_gpt2
from ml_trainer_tpu_torch.data import Loader, prefetch_to_device
from ml_trainer_tpu_torch.device import resolve_device
from ml_trainer_tpu_torch.ops.losses import get_criterion
from ml_trainer_tpu_torch.ops.metrics import get_metric
from ml_trainer_tpu_torch.ops.optimizers import (
    chain,
    clip_by_global_norm,
    decay_mask_matrices_only,
    get_optimizer,
    identity,
    tree_map,
)
from ml_trainer_tpu_torch.ops.predictions import get_prediction_function
from ml_trainer_tpu_torch.ops.schedules import (
    PlateauController,
    make_lr_schedule,
)
from ml_trainer_tpu_torch.train_state import TrainState
from ml_trainer_tpu_torch.utils.logging import get_logger
from ml_trainer_tpu_torch.utils.utils import LoadedModel

logger = get_logger("ml_trainer_tpu_torch.trainer")

MODEL_FILE = "model.pth"


def _refuse(knob: str, value, accepted) -> None:
    if value not in accepted:
        raise NotImplementedError(
            f"{knob}={value!r} is not ported yet; see ROADMAP.md Queue A"
        )


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

        Ported: ``grad_accum_steps``, ``grad_clip_norm``,
        ``early_stop_patience``, ``save_best``, ``decay_exclude_bias_norm``,
        ``label_smoothing``, ``nonfinite_guard``, ``log_every_steps`` and
        ``loader`` ('auto' and 'python' both take the Python ``Loader``).
        Accepted with no effect here: ``moe_aux_weight`` (no MoE model is
        ported), ``loss_scale`` and ``bucket_mb`` (they act only with
        bf16 and the sharded update), ``desync_every_steps`` and
        ``straggler_factor`` (multi-host and telemetry only), and
        ``handle_preemption`` (no signal handlers are installed yet).
        Refused unless at their defaults: ``is_parallel``,
        ``mesh_shape``, ``sharding_rules``, ``steps_per_execution``,
        ``shard_opt_state``, ``ema_decay``, ``precision`` other than
        fp32, ``telemetry``, ``elastic``, ``lora``,
        ``pipeline_schedule``, ``dp_update='sharded'``,
        ``fused_adam=True``, ``save_every_steps``,
        ``rollback_bad_steps``, ``sharded_checkpoint=True`` and
        ``loader='native'``.
        """
        logger.info("Config inputs.", config=config)
        cfg = TrainerConfig.from_kwargs(**config)
        self.config = cfg
        for knob, value, accepted in (
            ("is_parallel", is_parallel, (False,)),
            ("mesh_shape", mesh_shape, (None,)),
            ("sharding_rules", sharding_rules, (None,)),
            ("steps_per_execution", steps_per_execution, (1,)),
            ("shard_opt_state", shard_opt_state, (False,)),
            ("ema_decay", ema_decay, (None,)),
            ("precision", precision, (None, "fp32")),
            ("telemetry", telemetry, (False,)),
            ("elastic", elastic, (None,)),
            ("lora", lora, (None,)),
            ("pipeline_schedule", pipeline_schedule, (None,)),
            ("dp_update", dp_update, ("fused",)),
            ("fused_adam", fused_adam, (None, False)),
            ("save_every_steps", save_every_steps, (None,)),
            ("rollback_bad_steps", rollback_bad_steps, (None,)),
            ("sharded_checkpoint", sharded_checkpoint, (None, False)),
            ("loader", loader, ("auto", "python")),
        ):
            _refuse(knob, value, accepted)
        if grad_accum_steps < 1:
            raise ValueError(
                f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
        if grad_clip_norm is not None and grad_clip_norm <= 0:
            raise ValueError(
                f"grad_clip_norm must be positive, got {grad_clip_norm}")
        if moe_aux_weight < 0:
            raise ValueError(
                f"moe_aux_weight must be >= 0, got {moe_aux_weight}")
        if early_stop_patience is not None and early_stop_patience < 1:
            raise ValueError(
                f"early_stop_patience must be >= 1, got {early_stop_patience}")
        if not 0.0 < rollback_lr_backoff <= 1.0:
            raise ValueError(
                f"rollback_lr_backoff must be in (0, 1], got "
                f"{rollback_lr_backoff}")
        if log_every_steps is not None and log_every_steps < 1:
            raise ValueError(
                f"log_every_steps must be >= 1, got {log_every_steps}")
        if straggler_factor <= 1.0:
            raise ValueError(
                f"straggler_factor must be > 1, got {straggler_factor}")
        if bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be positive, got {bucket_mb}")

        if cfg.backend == "cpu":
            if device is not None and torch.device(device).type != "cpu":
                raise ValueError(
                    f"backend={config.get('backend')!r} runs on the CPU, "
                    f"but device={device!r} was asked for")
            device = "cpu"
        self.device = resolve_device(device)

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
        self.grad_clip_norm = grad_clip_norm
        self.early_stop_patience = early_stop_patience
        self.save_best = bool(save_best)
        self.decay_exclude_bias_norm = bool(decay_exclude_bias_norm)
        self.nonfinite_guard = bool(nonfinite_guard)
        self.handle_preemption = bool(handle_preemption)
        self.skipped_steps: list = []
        self.rollbacks = 0
        self.reshapes: list = []
        self._skipped_base = 0
        self._best_val = math.inf
        self._bad_epochs = 0

        if isinstance(model, str):
            model = init_gpt2(model, seed=cfg.seed, device=self.device)
        elif isinstance(model, nn.Module):
            model = model.to(self.device)
        else:
            raise TypeError(
                f"model must be a registry name or an nn.Module, got "
                f"{type(model).__name__}")
        self.model = model
        logger.info(f"Training on device: {self.device}.")

        self.criterion = get_criterion(cfg.criterion,
                                       label_smoothing=label_smoothing)
        self.pred_function = get_prediction_function(cfg.pred_function)
        self.metric_fn = get_metric(cfg.metric, self.pred_function)
        fin = getattr(self.metric_fn, "finalize", None)
        self._metric_finalize = (
            (lambda v: float(fin(torch.tensor(v)))) if fin is not None
            else (lambda v: v))

        self.state: Optional[TrainState] = None
        self.train_loader: Optional[Loader] = None
        self.val_loader: Optional[Loader] = None
        self._plateau: Optional[PlateauController] = None
        self._lr_scale = 1.0

        if datasets:
            train_set, val_set = datasets
            self._build_loaders(train_set, val_set, batch_size, cfg)
            self._build_state(cfg)
        else:
            logger.warning("Testing only available. No datasets in arguments.")

    # ------------------------------------------------------------------ data
    def _build_loaders(self, train_set, val_set, batch_size, cfg) -> None:
        logger.info("Loading training and validation set.")
        d = self.grad_accum_steps
        # The global batch rounds down to a multiple of the microbatch
        # count (and up to one sample per microbatch), as in the reference.
        eff = max(batch_size // d, 1) * d
        if eff != batch_size:
            logger.warning(
                f"Global batch {batch_size} adjusted to {eff} to divide "
                f"into {d} microbatches.")
        drop_last = d > 1  # equal microbatches
        self.global_batch = eff
        self.train_loader = Loader(train_set, batch_size=eff, shuffle=True,
                                   drop_last=drop_last, seed=cfg.seed)
        self.val_loader = Loader(val_set, batch_size=eff, shuffle=True,
                                 drop_last=drop_last, seed=cfg.seed + 1)
        if len(self.train_loader) == 0 or len(self.val_loader) == 0:
            raise ValueError(
                f"Loader yields no batches (train {len(self.train_loader)}, "
                f"val {len(self.val_loader)}): dataset smaller than the "
                f"batch {eff} with drop_last={drop_last}.")

    # ----------------------------------------------------------------- state
    def _params(self) -> dict:
        return dict(self.model.named_parameters())

    def _build_state(self, cfg) -> None:
        self.steps_per_epoch = len(self.train_loader)
        self.lr_schedule = make_lr_schedule(
            cfg.scheduler, cfg.lr, self.steps_per_epoch,
            total_steps=(self.steps_per_epoch * self.epochs
                         if self.epochs else None))
        self.tx = chain(
            clip_by_global_norm(self.grad_clip_norm)
            if self.grad_clip_norm is not None else identity(),
            get_optimizer(
                cfg.optimizer, self.lr_schedule, cfg.momentum,
                cfg.weight_decay,
                decay_mask=(decay_mask_matrices_only
                            if self.decay_exclude_bias_norm else None)),
        )
        if cfg.scheduler == "ReduceLROnPlateau":
            self._plateau = PlateauController(cfg.lr)
        with torch.no_grad():
            params = {k: p.detach() for k, p in self._params().items()}
            self.state = TrainState.create(self.tx.init(params), self.device)

    # ------------------------------------------------------------- the step
    def _forward_loss(self, x, y):
        """Loss and metric of one microbatch, the graph kept for backward."""
        out = self.model(x)
        loss = self.criterion(out, y)
        with torch.no_grad():
            metric = (self.metric_fn(out.detach(), y)
                      if self.metric_fn is not None
                      else torch.zeros((), device=loss.device))
        return loss, metric

    def _train_step(self, x, y, lr_scale: float):
        """One optimizer step on the global batch ``(x, y)``; returns the
        (guarded) loss and metric as device scalars."""
        accum = self.grad_accum_steps
        params = self._params()
        self.model.train()
        for p in params.values():
            p.grad = None
        micro = x.shape[0] // accum
        loss_sum = metric_sum = None
        for i in range(accum):
            sl = slice(i * micro, (i + 1) * micro)
            loss, metric = self._forward_loss(x[sl], y[sl])
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            metric_sum = metric if metric_sum is None else metric_sum + metric
        with torch.no_grad():
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in params.items()}
            if accum > 1:
                grads = {k: g / accum for k, g in grads.items()}
                loss_sum, metric_sum = loss_sum / accum, metric_sum / accum
            return self._apply_grads(params, grads, loss_sum, metric_sum,
                                     lr_scale)

    def _apply_grads(self, params, grads, loss, metric, lr_scale: float):
        state = self.state
        old = {k: p.detach() for k, p in params.items()}
        updates, new_opt = self.tx.update(grads, state.opt_state, old)
        if lr_scale != 1.0:
            updates = {k: u * lr_scale for k, u in updates.items()}
        new_params = {k: old[k] + u for k, u in updates.items()}
        if self.nonfinite_guard:
            ok = torch.isfinite(loss)
            for g in grads.values():
                ok = ok & torch.isfinite(g).all()

            def sel(n, o):
                return torch.where(ok, n, o)

            new_params = tree_map(sel, new_params, old)
            new_opt = tree_map(sel, new_opt, state.opt_state)
            bad = (~ok).to(torch.int32)
            state.skipped_steps = state.skipped_steps + bad
            state.bad_streak = (state.bad_streak + 1) * bad
            # A skipped step adds zero to the epoch's sums.
            loss = torch.where(ok, loss, torch.zeros_like(loss))
            metric = torch.where(ok, metric, torch.zeros_like(metric))
        for k, p in params.items():
            p.copy_(new_params[k])
            p.grad = None
        state.opt_state = new_opt
        state.step += 1
        return loss, metric

    @torch.no_grad()
    def _eval_step(self, model, x, y):
        out = model(x)
        loss = self.criterion(out, y)
        metric = (self.metric_fn(out, y) if self.metric_fn is not None
                  else torch.zeros((), device=loss.device))
        return loss, metric

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

    def _train_one_epoch(self, epoch: int) -> None:
        self.train_loader.set_epoch(epoch - 1)
        n = len(self.train_loader)
        loss_sum = torch.zeros((), device=self.device)
        metric_sum = torch.zeros((), device=self.device)
        epoch_t0 = time.time()
        batches = prefetch_to_device(self.train_loader, size=2,
                                     device=self.device)
        for i, (x, y) in enumerate(batches):
            done = i + 1
            loss, metric = self._train_step(x, y, self._lr_scale)
            loss_sum = loss_sum + loss
            metric_sum = metric_sum + metric
            if done % self.log_every == 0 or done == n:
                # The only host reads of the epoch besides its end.
                self._log_progress(f"epoch {epoch} train", done, n,
                                   loss_sum, metric_sum, loss)
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

    def _evaluate(self, model, loader, what: str):
        n = len(loader)
        loss_sum = torch.zeros((), device=self.device)
        metric_sum = torch.zeros((), device=self.device)
        model.eval()
        for i, (x, y) in enumerate(
                prefetch_to_device(loader, size=2, device=self.device)):
            loss, metric = self._eval_step(model, x, y)
            loss_sum = loss_sum + loss
            metric_sum = metric_sum + metric
            if (i + 1) % self.log_every == 0 or (i + 1) == n:
                self._log_progress(what, i + 1, n, loss_sum, metric_sum,
                                   loss)
        return float(loss_sum) / n, float(metric_sum) / n

    def _validate_one_epoch(self) -> None:
        loss, metric = self._evaluate(self.model, self.val_loader,
                                      "validation")
        self.val_losses.append(loss)
        if self.metric:
            self.val_metrics.append(self._metric_finalize(metric))

    # ------------------------------------------------------------------- fit
    def fit(self, resume: bool = False) -> None:
        """Train ``epochs`` epochs, validating and exporting the weights
        after each.  ``resume`` (full-state checkpoints) is not ported."""
        if resume:
            raise NotImplementedError(
                "fit(resume=True) and full-state checkpoints are not ported "
                "yet; see ROADMAP.md Queue A")
        if self.state is None:
            raise ValueError("fit() needs datasets; this Trainer was built "
                             "for testing only")
        logger.info("Start training..")
        for epoch in range(1, self.epochs + 1):
            if self._out_of_patience():
                break
            logger.info(f"{'-' * 30} EPOCH {epoch} / {self.epochs} "
                        f"{'-' * 30}")
            self._train_one_epoch(epoch)
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
        logger.info("Training Complete.")

    def _out_of_patience(self) -> bool:
        stop = (self.early_stop_patience is not None
                and self._bad_epochs >= self.early_stop_patience)
        if stop:
            logger.info(
                f"Early stop: no val-loss improvement in {self._bad_epochs} "
                f"epochs (best {self._best_val:.6f}).")
        return stop

    # ------------------------------------------------------------------ test
    def test(self, model=None, test_loader=None):
        """Loss (and metric) of ``model`` over ``test_loader`` with this
        trainer's criterion and metric.  ``model``: None (the trained
        model), a ``LoadedModel`` from ``load_model``, an ``nn.Module``,
        or a ``state_dict`` for a copy of this trainer's model."""
        logger.info("Testing..")
        if model is None:
            module = self.model
        elif isinstance(model, LoadedModel):
            module = model.module
        elif isinstance(model, nn.Module):
            module = model
        elif isinstance(model, dict):
            module = copy.deepcopy(self.model)
            module.load_state_dict(model)
        else:
            raise TypeError(
                f"Cannot interpret model argument of type {type(model)}")
        if len(test_loader) == 0:
            raise ValueError("test_loader yields no batches")
        module = module.to(self.device)
        loss, metric = self._evaluate(module, test_loader, "test")
        if self.metric:
            return loss, self._metric_finalize(metric)
        return loss

    # ----------------------------------------------------------- persistence
    def save_model(self, model_dir: str) -> None:
        """The weights as a torch ``state_dict`` in
        ``<model_dir>/model.pth`` (the reference's own format)."""
        logger.info("Saving the model.")
        os.makedirs(model_dir, exist_ok=True)
        state = {k: v.detach().cpu() for k, v in
                 self.model.state_dict().items()}
        tmp = os.path.join(model_dir, MODEL_FILE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(model_dir, MODEL_FILE))

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

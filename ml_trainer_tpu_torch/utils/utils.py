"""History, model loading and plots (the JAX package's
``utils/utils.py``): ``load_history(dir)``, ``load_model(model, path)``,
whose result the trainer's ``test()`` takes, and ``plot_history``.

A ``model.pth`` has one layout per kind of model
(``checkpoint/torch_import.is_reference_layout``): a flat model's
(every key ``<layer>.<leaf>``: MLModel, an MLP) is the reference's, the
file the reference, the JAX package's ``export_torch`` and the port's
``save_model`` and ``export_torch`` all write, with MLModel's ``fc1``
columns in C*H*W order; a nested family's (ResNet, ViT, BERT, GPT-2,
Llama) is the port's own ``state_dict``."""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Dict

import torch
from torch import nn


def load_history(file_dir: str) -> dict:
    """A run's history: ``history.json`` when present, else the
    ``history.pkl`` the trainer writes beside it."""
    json_path = os.path.join(file_dir, "history.json")
    if os.path.exists(json_path):
        with open(json_path, encoding="utf-8") as fp:
            return json.load(fp)
    with open(os.path.join(file_dir, "history.pkl"), "rb") as fp:
        return pickle.load(fp)


@dataclasses.dataclass
class LoadedModel:
    """A module with restored weights, callable for inference."""

    module: nn.Module
    state_dict: Dict[str, torch.Tensor]

    def __call__(self, x, **kwargs):
        return self.module(x, **kwargs)


def _read_state(path: str) -> Dict[str, torch.Tensor]:
    if not path.endswith((".pth", ".pt")):
        pth = os.path.join(path, "model.pth")
        msgpack = os.path.join(path, "model.msgpack")
        if not os.path.exists(pth) and os.path.exists(msgpack):
            raise ValueError(
                f"{msgpack} is the JAX package's native format, which the "
                "port does not read; write the weights from the JAX "
                "trainer with export_torch(path) and load that .pth")
        path = pth
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model(model: nn.Module, PATH: str) -> LoadedModel:
    """Load weights from ``PATH`` (a ``.pth``/``.pt`` file, or a
    directory holding ``model.pth``) into ``model``, on the device its
    weights live on.  A reference-layout file (the module docstring's
    rule) is converted as the JAX package's ``load_model`` converts it
    (``checkpoint/torch_import.py``: DDP's ``module.`` prefix stripped
    when every key has it, MLModel's ``fc1`` columns from C*H*W order);
    a nested family's file loads as the port's ``state_dict``, the
    prefix stripped by the same rule.  A directory with only the JAX
    package's ``model.msgpack`` raises ``ValueError``."""
    from ml_trainer_tpu_torch.checkpoint.torch_import import (
        _strip_ddp_prefix,
        convert_torch_state_dict,
        is_reference_layout,
        spatial_inputs_of,
    )
    from ml_trainer_tpu_torch.convert import params_from_jax

    state = _strip_ddp_prefix(_read_state(PATH))
    if is_reference_layout(state):
        params = convert_torch_state_dict(
            {k: v.numpy() for k, v in state.items()},
            spatial_inputs=spatial_inputs_of(state))
        state = params_from_jax(params)
    device = next(model.parameters()).device
    state = {k: v.to(device) for k, v in state.items()}
    model.load_state_dict(state)
    return LoadedModel(model, state)


def plot_history(history: dict, show: bool = True):
    """Train-vs-validation curves (the JAX package's ``plot_history``):
    two panels (loss and metric) when a metric was tracked, one
    otherwise; x-ticks thinned past 25 epochs.  ``show=False`` returns
    the figure without ``plt.show()``; ``show=True`` shows it and
    returns None.  matplotlib is imported here, at the call."""
    import numpy as np
    from matplotlib import pyplot as plt

    x = history["epochs"]
    metric_type = history.get("metric_type")

    def thin_ticks(ax):
        if len(x) > 25:
            ticks = np.arange(0, len(x) + 1, 5)
            ax.set_xticks(ticks)
            ax.set_xticklabels(ticks, rotation=45)
        else:
            ax.set_xticks(x)

    if metric_type is not None:
        fig, (ax_loss, ax_metric) = plt.subplots(2, 1, figsize=(10, 10))
        for ax, train_key, val_key, ylabel, title in (
            (ax_loss, "train_loss", "val_loss", "Loss",
             "Training Loss vs. Validation Loss"),
            (ax_metric, "train_metric", "val_metric", metric_type,
             f"{metric_type} - Training vs. Validation"),
        ):
            ax.plot(x, history[train_key], c="C0", label="train")
            ax.plot(x, history[val_key], c="C1", label="validation")
            thin_ticks(ax)
            ax.set_ylabel(ylabel)
            ax.set_title(title)
            ax.legend()
        ax_loss.set_xlabel("Epochs")
    else:
        fig, ax = plt.subplots(figsize=(10, 5))
        ax.plot(x, history["train_loss"], c="C0", label="train")
        ax.plot(x, history["val_loss"], c="C1", label="validation")
        thin_ticks(ax)
        ax.tick_params(axis="x", rotation=45)
        ax.set_xlabel("Epochs")
        ax.set_ylabel("Loss")
        ax.set_title("Training Loss vs. Validation Loss")
        ax.legend()
    plt.tight_layout()
    if show:
        # One render; returning the figure too would draw it twice in a
        # notebook cell that ends with the call.
        plt.show()
        return None
    return fig

"""History and model loading (the JAX package's ``utils/utils.py``):
``load_history(dir)`` and ``load_model(model, path)``, whose result the
trainer's ``test()`` takes."""

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


def load_model(model: nn.Module, PATH: str) -> LoadedModel:
    """Load a ``state_dict`` from ``PATH`` (a ``.pth``/``.pt`` file, or a
    directory holding ``model.pth``) into ``model``, on the device its
    weights live on.  The ``module.`` prefix of a DDP checkpoint is
    stripped, as the reference does."""
    path = PATH if PATH.endswith((".pth", ".pt")) else os.path.join(
        PATH, "model.pth")
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    state = {(k[len("module."):] if k.startswith("module.") else k): v
             for k, v in state.items()}
    model.load_state_dict(state)
    return LoadedModel(model, state)

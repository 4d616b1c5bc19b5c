"""Write a model's weights as a reference-style ``model.pth`` (the JAX
package's ``checkpoint/torch_export.py`` and ``torch_import.py``'s
``MLMODEL_SPATIAL_INPUTS``, copied).

The input is the flax-layout variables (``convert.variables_to_jax``),
so the file is the one the JAX package writes for the same weights: the
same keys, bitwise the same arrays.  Its rules:

* conv kernels: flax HWIO -> torch OIHW;
* dense kernels: flax (in, out) -> torch (out, in);
* the first dense after a conv stack un-permutes its input features
  from the H*W*C flatten order to torch's C*H*W (``spatial_inputs``;
  default: MLModel's ``fc1``);
* BatchNorm ``scale``/``mean``/``var`` -> ``weight``/``running_mean``/
  ``running_var``;
* ``ddp_prefix=True`` writes DDP's ``module.``-prefixed keys.

A nested tree (a transformer's, a ResNet's blocks) raises ``ValueError``,
as in the JAX package: it needs a model-specific key mapping.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

# The reference MLModel's conv-to-dense boundary: fc1 reads the
# flattened (16, 5, 5) output of the conv stack.
MLMODEL_SPATIAL_INPUTS = {"fc1": (16, 5, 5)}


def convert_to_torch_state_dict(
    params: Mapping[str, Mapping[str, np.ndarray]],
    spatial_inputs: Optional[Dict[str, Tuple[int, int, int]]] = None,
    ddp_prefix: bool = False,
) -> Dict[str, np.ndarray]:
    """flax ``{layer: {kernel/bias/...}}`` -> torch ``{layer.weight:
    ...}``."""
    spatial_inputs = (
        MLMODEL_SPATIAL_INPUTS if spatial_inputs is None else spatial_inputs
    )
    out: Dict[str, np.ndarray] = {}
    prefix = "module." if ddp_prefix else ""

    def put(layer: str, leaf: str, arr: np.ndarray) -> None:
        out[f"{prefix}{layer.replace('/', '.')}.{leaf}"] = arr

    for layer, leaves in params.items():
        for leaf, value in leaves.items():
            if isinstance(value, Mapping):
                raise ValueError(
                    f"nested module {layer}/{leaf}: flatten the tree to "
                    "{layer: {leaf: array}} first (transformer trees need "
                    "a model-specific key mapping, not this generic one)"
                )
            arr = np.asarray(value)
            if leaf == "kernel":
                if arr.ndim == 4:  # HWIO -> OIHW
                    put(layer, "weight", arr.transpose(3, 2, 0, 1))
                elif arr.ndim == 2:
                    w = arr.T  # (in, out) -> (out, in)
                    if layer in spatial_inputs:
                        c, h, w_ = spatial_inputs[layer]
                        # Columns are H*W*C-ordered here; torch flattens
                        # C*H*W: permute back.
                        w = (
                            w.reshape(w.shape[0], h, w_, c)
                            .transpose(0, 3, 1, 2)
                            .reshape(w.shape[0], c * h * w_)
                        )
                    put(layer, "weight", w)
                else:
                    raise ValueError(
                        f"{layer}/kernel has rank {arr.ndim}; only dense "
                        "(2-D) and conv (4-D HWIO) kernels have a defined "
                        "torch export layout"
                    )
            elif leaf == "scale":
                put(layer, "weight", arr)
            elif leaf == "mean":
                put(layer, "running_mean", arr)
            elif leaf == "var":
                put(layer, "running_var", arr)
            else:
                put(layer, leaf, arr)
    return out


def save_torch_checkpoint(
    path: str,
    variables: Mapping,
    spatial_inputs: Optional[Dict[str, Tuple[int, int, int]]] = None,
    ddp_prefix: bool = False,
) -> str:
    """Write a torch-loadable ``model.pth`` from flax-layout
    ``variables`` (``{'params': ...}`` or a bare params tree; BatchNorm
    statistics merge in from ``variables['batch_stats']``)."""
    import torch

    params = dict(variables.get("params", variables))
    batch_stats = variables.get("batch_stats")
    if batch_stats:
        merged: Dict[str, Dict] = {k: dict(v) for k, v in params.items()}
        for layer, stats in batch_stats.items():
            merged.setdefault(layer, {}).update(stats)
        params = merged
    state = convert_to_torch_state_dict(params, spatial_inputs, ddp_prefix)
    torch.save(
        {k: torch.from_numpy(np.array(v)) for k, v in state.items()}, path
    )
    return path

"""Read a reference-layout torch ``model.pth`` (the JAX package's
``checkpoint/torch_import.py``, copied).

The reference's ``load_model`` strips DDP's ``module.`` prefix; the JAX
package makes that explicit (only when every key carries it) and
converts the layouts into a flax parameter tree:

* conv weights: torch OIHW -> flax HWIO;
* linear weights: torch (out, in) -> flax (in, out);
* the first dense layer after a conv stack additionally permutes its
  input features from torch's C*H*W flatten order to the H*W*C order
  both packages flatten in (``spatial_inputs`` maps a layer name to its
  (C, H, W); MLModel's ``fc1`` is (16, 5, 5));
* BatchNorm ``weight``/``running_mean``/``running_var`` -> ``scale``/
  ``mean``/``var``; ``num_batches_tracked`` is dropped.

``convert.params_from_jax`` then maps the flax tree onto the port's
modules.

Which files are in that layout is one rule, ``is_reference_layout``: a
key set (after the prefix is stripped) in which every key is
``<layer>.<leaf>``.  That is every file the reference writes for its
flat models and every file ``export_torch`` writes (both packages
refuse a nested tree there); each nested family of the port (ResNet,
ViT, BERT, GPT-2, Llama) has keys of more levels or none, and keeps the
port's own ``state_dict`` layout.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np

from ml_trainer_tpu_torch.checkpoint.torch_export import (
    MLMODEL_SPATIAL_INPUTS,
)


def _strip_ddp_prefix(state_dict: Mapping[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """Remove the DDP ``module.`` prefix when every key carries it."""
    keys = list(state_dict)
    if keys and all(k.startswith("module.") for k in keys):
        return {k[len("module."):]: v for k, v in state_dict.items()}
    return dict(state_dict)


def is_reference_layout(keys: Iterable[str]) -> bool:
    """True when every key (DDP prefix stripped) is ``<layer>.<leaf>``:
    the reference's flat layout, read through ``convert_torch_state_dict``."""
    keys = list(_strip_ddp_prefix(dict.fromkeys(keys)))
    return bool(keys) and all(k.count(".") == 1 for k in keys)


def convert_torch_state_dict(
    state_dict: Mapping[str, np.ndarray],
    spatial_inputs: Optional[Dict[str, Tuple[int, int, int]]] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """torch ``{layer.weight/bias: tensor}`` -> flax ``{layer:
    {kernel/bias}}``."""
    spatial_inputs = (
        MLMODEL_SPATIAL_INPUTS if spatial_inputs is None else spatial_inputs
    )
    state_dict = _strip_ddp_prefix(state_dict)
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in state_dict.items():
        arr = np.asarray(value)
        layer, _, leaf = key.rpartition(".")
        layer = layer.replace(".", "/")
        entry = params.setdefault(layer, {})
        if leaf == "weight":
            if arr.ndim == 4:  # OIHW -> HWIO
                entry["kernel"] = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                if layer in spatial_inputs:
                    c, h, w = spatial_inputs[layer]
                    arr = (
                        arr.reshape(arr.shape[0], c, h, w)
                        .transpose(0, 2, 3, 1)
                        .reshape(arr.shape[0], c * h * w)
                    )
                entry["kernel"] = arr.T
            else:
                entry["scale" if arr.ndim == 1 else "kernel"] = arr
        elif leaf == "bias":
            entry["bias"] = arr
        elif leaf in ("running_mean", "running_var"):
            entry["mean" if leaf == "running_mean" else "var"] = arr
        elif leaf == "num_batches_tracked":
            continue
        else:
            entry[leaf] = arr
    return params


def spatial_inputs_of(state_dict: Mapping[str, np.ndarray]
                      ) -> Dict[str, Tuple[int, int, int]]:
    """The ``MLMODEL_SPATIAL_INPUTS`` entries whose layer has a dense
    ``weight`` of C*H*W input features in ``state_dict`` (torch layout),
    so a flat model without MLModel's conv stack converts with no
    permutation."""
    widths = {k.rpartition(".")[0]: v.shape[1] for k, v in state_dict.items()
              if k.endswith(".weight") and len(v.shape) == 2}
    return {layer: chw for layer, chw in MLMODEL_SPATIAL_INPUTS.items()
            if widths.get(layer) == int(np.prod(chw))}

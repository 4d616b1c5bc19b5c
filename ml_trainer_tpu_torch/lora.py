"""LoRA: train a low-rank adapter on a frozen base, export it, serve it
from the adapter pool (the JAX package's ``lora.py``).

* :class:`LoraConfig`, the ``Trainer(lora=...)`` knob: rank, alpha and
  the targeted projections (``models/layers.py`` ``LORA_TARGETS``).  The
  Trainer clones the model with the matching ``lora_*`` knobs (A and B
  become parameters, B zero so that step 0 is the base model), freezes
  the base (``requires_grad=False``; an ``ops/optimizers.multi_transform``
  in which frozen leaves get ``set_to_zero`` and no optimizer state) and
  trains only A and B.
* The artifact, unchanged from the JAX package's so that either package
  reads the other's: one ``.npz`` with every adapter leaf under
  ``leaf::<flax path>`` (``block0/attn/qkv_lora_A``; A [in, r], B [r,
  out]) and a JSON ``meta`` record (version 1: rank, alpha, targets, the
  base's fingerprint, the leaf count).  :func:`export_lora_artifact`
  writes it, :func:`load_lora_artifact` reads it, and the serving
  engine's adapter pool (``serving/adapter_pool.py``) hot-loads it.
* The ``_lora_A``/``_lora_B`` suffixes decide what is adapter and what
  is base, on flax paths and on the port's parameter names alike.

The tree helpers take the flax-layout parameter tree (nested dicts of
numpy arrays, ``convert.variables_to_jax(model)["params"]``) or a model,
which they convert to it.  :func:`base_fingerprint` is a CRC32 over the
flax path and the flax-layout bytes of every base leaf, in the sorted
path order of ``jax.tree_util``: the same weights give the same
fingerprint in both packages.

Host file I/O and tree walks only: numpy and the standard library.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import zlib
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np

from ml_trainer_tpu_torch.models.layers import LORA_TARGETS

# Parameter-name suffixes of adapter leaves (``<target>_lora_A/B``).
_LORA_MARKERS = ("_lora_A", "_lora_B")

ARTIFACT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """The ``Trainer(lora=...)`` knob.

    ``rank``: adapter rank r (A: [in, r], B: [r, out]).  ``alpha``: the
    scale's numerator; the delta is ``alpha/rank * x A B``.  ``targets``:
    the projections that carry adapters (default: the attention's qkv
    and output proj)."""

    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = ("qkv", "proj")

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"lora rank must be >= 1, got {self.rank}")
        if self.alpha <= 0:
            raise ValueError(f"lora alpha must be > 0, got {self.alpha}")
        targets = tuple(self.targets)
        if not targets:
            raise ValueError("lora targets must name >= 1 projection")
        bad = [t for t in targets if t not in LORA_TARGETS]
        if bad:
            raise ValueError(
                f"unknown lora target(s) {bad}; choose from {LORA_TARGETS}"
            )
        object.__setattr__(self, "targets", targets)

    def scale(self) -> float:
        return float(self.alpha) / float(self.rank)


def is_lora_path(path_name: str) -> bool:
    """True when a flax path or a parameter name is an adapter leaf."""
    return any(m in path_name for m in _LORA_MARKERS)


def _as_tree(params) -> Mapping:
    """A model's flax-layout params tree; a tree as it is."""
    if hasattr(params, "named_parameters"):
        from ml_trainer_tpu_torch.convert import variables_to_jax

        return variables_to_jax(params)["params"]
    return params


def flat_paths(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``(path, leaf)`` of a nested dict in ``jax.tree_util``'s order
    (keys sorted at every level), paths joined with ``/``."""
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from flat_paths(value, path)
        else:
            yield path, value


def lora_param_labels(params) -> Dict[str, str]:
    """``{name: 'lora' | 'frozen'}`` over a ``{name: tensor}`` dict (the
    port's parameters): the ``multi_transform`` labels the Trainer
    freezes the base with."""
    return {k: "lora" if is_lora_path(k) else "frozen" for k in params}


def split_lora_params(params) -> Tuple[Dict[str, np.ndarray], int, int]:
    """The adapter leaves of a trained params tree (or model):
    ``(leaves, n_lora, n_frozen)``, ``leaves`` by flax path."""
    leaves: Dict[str, np.ndarray] = {}
    n_frozen = 0
    for name, leaf in flat_paths(_as_tree(params)):
        if is_lora_path(name):
            leaves[name] = np.asarray(leaf)
        else:
            n_frozen += 1
    return leaves, len(leaves), n_frozen


def strip_lora_params(params) -> dict:
    """The base-only params tree: every ``*_lora_*`` leaf removed."""
    def walk(node):
        return {k: walk(v) if isinstance(v, Mapping) else v
                for k, v in node.items()
                if not (isinstance(k, str) and is_lora_path(k))}

    return walk(_as_tree(params))


def base_fingerprint(params) -> str:
    """CRC32 over each base (non-LoRA) leaf's flax path and bytes, in
    path order: the same string as the JAX package's for the same
    weights.  It rides the artifact's meta, so that a server can tell an
    adapter trained on another base."""
    crc = 0
    for name, leaf in flat_paths(_as_tree(params)):
        if is_lora_path(name):
            continue
        arr = np.ascontiguousarray(np.asarray(leaf))
        crc = zlib.crc32(name.encode() + arr.tobytes(), crc)
    return f"{crc:#010x}"


def export_lora_artifact(params, config: LoraConfig, path: str,
                         name: Optional[str] = None) -> dict:
    """Write one adapter artifact (``.npz``): every ``*_lora_A``/``_B``
    leaf of ``params`` (a flax-layout tree or a model) and the JSON meta.
    Returns the meta."""
    tree = _as_tree(params)
    leaves, n_lora, _ = split_lora_params(tree)
    if not n_lora:
        raise ValueError(
            "params carry no *_lora_A/*_lora_B leaves — was the model "
            "built with Trainer(lora=LoraConfig(...))?"
        )
    meta = {
        "version": ARTIFACT_VERSION,
        "name": name or os.path.splitext(os.path.basename(path))[0],
        "rank": int(config.rank),
        "alpha": float(config.alpha),
        "targets": list(config.targets),
        "base_fingerprint": base_fingerprint(tree),
        "n_leaves": n_lora,
    }
    buf = io.BytesIO()
    np.savez(
        buf,
        meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
        **{f"leaf::{k}": v for k, v in sorted(leaves.items())},
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        fp.write(buf.getvalue())
    os.replace(tmp, path)
    return meta


def load_lora_artifact(source) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Read an adapter artifact: a path, bytes, or a ``(meta, leaves)``
    pair (passed through).  Returns ``(meta, {flax path: array})``."""
    if isinstance(source, tuple) and len(source) == 2:
        return source
    if isinstance(source, (bytes, bytearray)):
        data = np.load(io.BytesIO(bytes(source)), allow_pickle=False)
    else:
        data = np.load(source, allow_pickle=False)
    with data as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        leaves = {
            k[len("leaf::"):]: np.asarray(z[k])
            for k in z.files if k.startswith("leaf::")
        }
    if int(meta.get("version", 0)) != ARTIFACT_VERSION:
        raise ValueError(
            f"unsupported lora artifact version {meta.get('version')!r} "
            f"(this build reads {ARTIFACT_VERSION})"
        )
    if len(leaves) != int(meta.get("n_leaves", -1)):
        raise ValueError(
            f"lora artifact corrupt: {len(leaves)} leaves, meta says "
            f"{meta.get('n_leaves')}"
        )
    return meta, leaves

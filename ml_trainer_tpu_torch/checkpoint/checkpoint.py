"""Full-state checkpoints (the JAX package's ``checkpoint/checkpoint.py``,
format v2), for trees of torch tensors.

A checkpoint is a ``checkpoint_<epoch>/`` directory: one ``.npy`` file
per state leaf (``leaf_<i:05d>.npy``, the leaves in sorted-path order,
written and read with ``allow_pickle=False``) and a ``manifest.json``
with ``format`` (2), ``epoch``, ``history``, ``leaves`` (each leaf's
path, file and the CRC32 of the file's bytes; an empty dict is
``{"empty": true}``, a None ``{"none": true}``), ``mesh`` (None: the
port's replicas share one process) and ``weights_fingerprint``.  The
layout and the manifest are the JAX package's, so each package's
``verify_checkpoint`` accepts the other's directories.

A write is atomic: the files go into ``checkpoint_<epoch>.tmp/``, which
is then renamed; a directory without a committed manifest is never
taken for a checkpoint.  ``save_checkpoint(..., block=False)`` copies
every leaf to the host before it returns (the trainer's step writes its
state in place, so a reference would be read half-updated) and leaves
the disk writes to one background writer thread, in submission order;
``wait_for_checkpoints()`` joins them and raises what failed.

Format 3 (``save_checkpoint_sharded``, the JAX package's sharded
format): every process writes only the pieces it owns, ``leaf_<i>_s<j>_
p<proc>.npy`` with a piece table ``manifest_p<proc>.json`` (each
piece's global start/stop and CRC32); process 0 writes ``manifest.json``
(format 3, the leaves' global shapes and dtypes, ``process_count``)
last, after a barrier, as the commit marker.  A leaf split over the data
replicas (ZeRO-1's moments) is written as each replica's dim-0 block by
the process that holds it; any other leaf whole, by process 0.
``restore_checkpoint`` reads either format, a format-3 leaf stitched
from its pieces, whole or (``pick``) only the box a process holds, so a
checkpoint restores onto another process count.  The directory is
shared storage, as in the JAX package.

The JAX package's v1 pickles are not read.
"""

from __future__ import annotations

import copy
import hashlib
import io
import json
import os
import re
import shutil
import threading
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ml_trainer_tpu_torch.parallel import distributed
from ml_trainer_tpu_torch.resilience.faults import active_plan
from ml_trainer_tpu_torch.utils.logging import get_logger

logger = get_logger("ml_trainer_tpu_torch.checkpoint")

CHECKPOINT_PREFIX = "checkpoint_"
MANIFEST = "manifest.json"
MODEL_MANIFEST = "model_manifest.json"  # beside model.pth
CORRUPT_SUFFIX = ".corrupt"
FORMAT = 2
_CKPT_RE = re.compile(rf"^{CHECKPOINT_PREFIX}(\d+)$")

# Tensor dtypes that numpy holds exactly; bf16 and the float8 types are
# not among them.
_NUMPY_DTYPES = (torch.float16, torch.float32, torch.float64, torch.int8,
                 torch.int16, torch.int32, torch.int64, torch.uint8,
                 torch.bool)


class CheckpointCorrupt(ValueError):
    """A checkpoint failed its integrity check (a missing leaf file, an
    unreadable manifest, or a CRC32 that differs from the manifest's)."""


# One writer thread: writes land in the order they were submitted
# (epoch N before N + 1) and never overlap.
_writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
_pending: List[Future] = []
_pending_lock = threading.Lock()


# Path -> (n, local): a leaf held as the dim-0 blocks ``local`` of ``n``.
Split = Dict[Tuple[str, ...], Tuple[int, Sequence[int]]]


# ------------------------------------------------------------- the tree
def _flatten(tree: Any, path=()):
    """(path tuple, leaf) pairs over nested dicts, keys sorted.  Empty
    dicts (stateless optimizer slots, a model without buffers) are
    leaves themselves, so that the structure survives a round trip."""
    if isinstance(tree, dict) and tree:
        for key in sorted(tree):
            yield from _flatten(tree[key], path + (str(key),))
    else:
        yield path, tree


def _unflatten(pairs) -> dict:
    root: dict = {}
    for path, leaf in pairs:
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return root


def _check_dtype(path, leaf: torch.Tensor) -> None:
    if leaf.dtype not in _NUMPY_DTYPES:
        raise ValueError(
            f"checkpoint leaf {'/'.join(path)}: {leaf.dtype} has no "
            "numpy dtype, and the format stores numpy arrays")


def _host_copy(path, leaf):
    """A host copy of one leaf: numpy for a tensor, an array or a
    number; empty dicts and None as they are."""
    if leaf is None or isinstance(leaf, dict):
        return leaf
    if isinstance(leaf, torch.Tensor):
        _check_dtype(path, leaf)
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _shape_dtype(path, leaf):
    """(shape as a list, numpy dtype name) of a tensor, an array or a
    number, with no host copy."""
    if isinstance(leaf, torch.Tensor):
        _check_dtype(path, leaf)
        return (list(leaf.shape),
                torch.empty(0, dtype=leaf.dtype).numpy().dtype.name)
    arr = np.asarray(leaf)
    return list(arr.shape), arr.dtype.name


def _crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _write_npy(path: str, arr: np.ndarray) -> int:
    """Write ``arr`` as ``np.save`` writes it (a format 1.0 header, the
    data in C order) with no copy of the data; return the CRC32 of the
    file's bytes."""
    arr = np.asarray(arr, order="C")
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        head, np.lib.format.header_data_from_array_1_0(arr))
    header = head.getvalue()
    body = arr.reshape(-1).view(np.uint8)
    with open(path, "wb") as fp:
        fp.write(header)
        fp.write(body)
    return zlib.crc32(body, zlib.crc32(header)) & 0xFFFFFFFF


# ------------------------------------------------------ weights identity
def _fingerprint_rows(pairs):
    for path, leaf in pairs:
        if leaf is None or isinstance(leaf, dict):
            continue
        arr = np.asarray(
            leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
            else leaf, order="C")
        yield ("/".join(path), str(arr.shape), str(arr.dtype),
               _crc32(arr.reshape(-1).view(np.uint8)))


def weights_structure_digest(variables: Any) -> str:
    """sha1 over the sorted (path | shape | dtype) rows of a tree: two
    trees of one architecture share it whatever their values."""
    h = hashlib.sha1()
    for path, shape, dtype, _ in _fingerprint_rows(_flatten(variables)):
        h.update(f"{path}|{shape}|{dtype}\n".encode())
    return f"cfg:{h.hexdigest()[:16]}"


def weights_fingerprint(variables: Any) -> str:
    """sha1 over the sorted (path | shape | dtype | crc32 of the bytes)
    rows of a tree: the identity of one set of weights."""
    h = hashlib.sha1()
    for path, shape, dtype, crc in _fingerprint_rows(_flatten(variables)):
        h.update(f"{path}|{shape}|{dtype}|{crc:#010x}\n".encode())
    return f"w:{h.hexdigest()[:16]}"


def write_model_manifest(model_dir: str, variables: Any,
                         data: Optional[bytes] = None) -> dict:
    """``model_manifest.json`` beside ``model.pth``: the weights
    fingerprint and structure digest of ``variables`` (the flax names
    and layouts, ``convert.variables_to_jax``), so they equal the JAX
    package's manifest for the same weights and the serving engine's
    ``weights_fp``, plus the CRC32 and size of ``data`` (the written
    file's bytes) when given.  The CRC differs from the JAX package's
    for the same weights: its file is ``model.msgpack``, this one
    ``model.pth``.  Returns the manifest."""
    os.makedirs(model_dir, exist_ok=True)
    manifest = {
        "format": 1,
        "weights_fingerprint": weights_fingerprint(variables),
        "structure_digest": weights_structure_digest(variables),
    }
    if data is not None:
        manifest["model_crc32"] = _crc32(data)
        manifest["model_bytes"] = len(data)
    _atomic_write(os.path.join(model_dir, MODEL_MANIFEST),
                  json.dumps(manifest, indent=1).encode())
    return manifest


def load_model_manifest(path: str) -> Optional[dict]:
    """The export manifest of a model directory (or of the directory of
    ``model.pth``), or None when there is none."""
    if not os.path.isdir(path):
        path = os.path.dirname(path) or "."
    try:
        with open(os.path.join(path, MODEL_MANIFEST)) as fp:
            return json.load(fp)
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------- write
def _apply_ckpt_faults(final_dir: str, epoch: int) -> None:
    """The ``ckpt_truncate`` hook: halve the largest leaf file of a
    checkpoint just committed."""
    plan = active_plan()
    if plan is None or plan.fire("ckpt_truncate", epoch=epoch) is None:
        return
    npys = [os.path.join(final_dir, n) for n in os.listdir(final_dir)
            if n.endswith(".npy")]
    if not npys:
        return
    victim = max(npys, key=os.path.getsize)
    with open(victim, "r+b") as fp:
        fp.truncate(max(os.path.getsize(victim) // 2, 1))


def _write_checkpoint_dir(final_dir: str, pairs, history: dict,
                          epoch: int) -> None:
    tmp_dir = final_dir + ".tmp"
    if os.path.isdir(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    leaves = []
    for i, (path, leaf) in enumerate(pairs):
        if isinstance(leaf, dict):
            leaves.append({"path": list(path), "empty": True})
            continue
        if leaf is None:
            leaves.append({"path": list(path), "none": True})
            continue
        fname = f"leaf_{i:05d}.npy"
        crc = _write_npy(os.path.join(tmp_dir, fname), leaf)
        leaves.append({"path": list(path), "file": fname, "crc32": crc})
    params = [(p, leaf) for p, leaf in pairs if p[:1] == ("params",)]
    manifest = {
        "format": FORMAT,
        "epoch": epoch,
        "history": history,
        "leaves": leaves,
        "mesh": None,
        "weights_fingerprint": (weights_fingerprint(_unflatten(params))
                                if params else None),
    }
    with open(os.path.join(tmp_dir, MANIFEST), "w") as fp:
        json.dump(manifest, fp)
    if os.path.isdir(final_dir):
        shutil.rmtree(final_dir)
    os.replace(tmp_dir, final_dir)
    _apply_ckpt_faults(final_dir, epoch)


def save_checkpoint(ckpt_dir: str, state_tree: Any, history: dict,
                    epoch: int, keep: int = 3, block: bool = True) -> str:
    """Write ``<ckpt_dir>/checkpoint_<epoch>/`` from ``state_tree``
    (nested dicts whose leaves are tensors, numpy arrays, numbers, None
    or empty dicts) and ``history`` (JSON), then keep the newest
    ``keep`` checkpoints (0: all).  Every leaf is copied to the host
    before this returns; with ``block=False`` the disk writes run on the
    writer thread (``wait_for_checkpoints`` joins them)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    pairs = [(path, _host_copy(path, leaf))
             for path, leaf in _flatten(state_tree)]
    # The caller's history lists grow while the writer runs.
    history = copy.deepcopy(history)
    path = os.path.join(ckpt_dir, f"{CHECKPOINT_PREFIX}{epoch}")

    def job():
        _write_checkpoint_dir(path, pairs, history, epoch)
        prune_checkpoints(ckpt_dir, keep)

    if block:
        job()
    else:
        fut = _writer.submit(job)
        with _pending_lock:
            _pending.append(fut)
    return path


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        fp.write(data)
    os.replace(tmp, path)


def save_checkpoint_sharded(ckpt_dir: str, state_tree: Any, history: dict,
                            epoch: int, split: Optional[Split] = None,
                            keep: int = 3, block: bool = True,
                            mesh: Optional[dict] = None) -> str:
    """Write ``<ckpt_dir>/checkpoint_<epoch>/`` in format 3.  ``split``
    names the leaves this process holds as dim-0 blocks of a larger
    leaf: ``{path: (n, local)}``, the live leaf being blocks ``local``
    (in order) of the leaf's ``n`` blocks; each block is one piece.  Any
    other leaf is written whole by process 0.  COLLECTIVE in a
    multi-process run (barriers before and after the pieces), and then
    synchronous whatever ``block`` says; ``mesh`` is the topology the
    manifest records."""
    os.makedirs(ckpt_dir, exist_ok=True)
    proc, nproc = distributed.process_index(), distributed.process_count()
    if nproc > 1:
        block = True
    split = split or {}
    final_dir = os.path.join(ckpt_dir, f"{CHECKPOINT_PREFIX}{epoch}")
    history = copy.deepcopy(history)
    pieces: list = []  # (leaf id, starts, stops, host array)
    leaf_meta: list = []
    for i, (path, leaf) in enumerate(_flatten(state_tree)):
        if isinstance(leaf, dict):
            leaf_meta.append({"path": list(path), "empty": True})
            continue
        if leaf is None:
            leaf_meta.append({"path": list(path), "none": True})
            continue
        # Only what this process writes is copied to the host.
        shape, dtype = _shape_dtype(path, leaf)
        if path in split:
            arr = _host_copy(path, leaf)
            n, local = split[path]
            rows = shape[0] // len(local)
            shape[0] = rows * n
            for k, j in enumerate(local):
                pieces.append((i, [j * rows] + [0] * (arr.ndim - 1),
                               [(j + 1) * rows] + shape[1:],
                               arr[k * rows:(k + 1) * rows]))
        elif proc == 0:
            pieces.append((i, [0] * len(shape), shape,
                           _host_copy(path, leaf)))
        leaf_meta.append({"path": list(path), "shape": shape,
                          "dtype": dtype})

    def write_files():
        os.makedirs(final_dir, exist_ok=True)
        # A stale commit marker goes before any piece is rewritten, and
        # the barrier keeps the other processes' writes behind it.
        if proc == 0:
            try:
                os.unlink(os.path.join(final_dir, MANIFEST))
            except FileNotFoundError:
                pass
        distributed.barrier()
        table, count = [], {}
        for leaf_id, starts, stops, arr in pieces:
            j = count[leaf_id] = count.get(leaf_id, -1) + 1
            fname = f"leaf_{leaf_id:05d}_s{j}_p{proc:05d}.npy"
            crc = _write_npy(os.path.join(final_dir, fname), arr)
            table.append({"leaf": leaf_id, "file": fname, "start": starts,
                          "stop": stops, "crc32": crc})
        _atomic_write(os.path.join(final_dir, f"manifest_p{proc:05d}.json"),
                      json.dumps({"process": proc, "pieces": table}).encode())

    def commit():
        # Every process's pieces and table are on disk before the marker.
        distributed.barrier()
        if proc == 0:
            _atomic_write(os.path.join(final_dir, MANIFEST), json.dumps({
                "format": 3, "epoch": epoch, "history": history,
                "process_count": nproc, "leaves": leaf_meta,
                "mesh": mesh}).encode())
            _apply_ckpt_faults(final_dir, epoch)
            prune_checkpoints(ckpt_dir, keep)

    if block:
        write_files()
        commit()
    else:
        fut = _writer.submit(lambda: (write_files(), commit()))
        with _pending_lock:
            _pending.append(fut)
    return final_dir


def wait_for_checkpoints() -> None:
    """Join every write in flight, raising the first that failed."""
    with _pending_lock:
        pending, _pending[:] = list(_pending), []
    for fut in pending:
        fut.result()


# ----------------------------------------------------------------- scan
def _scan_checkpoints(ckpt_dir: str):
    """Sorted (epoch, name) of the committed checkpoints: ``.tmp``
    directories and any without a manifest are skipped."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, MANIFEST)):
            found.append((int(m.group(1)), name))
    return sorted(found)


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    if not keep:
        return
    for _, name in _scan_checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, name))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    found = _scan_checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, found[-1][1]) if found else None


def _read_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as fp:
        return json.load(fp)


def checkpoint_format(path: str) -> int:
    """The manifest's format: 2 (whole leaves) or 3 (pieces)."""
    return int(_read_manifest(path).get("format", FORMAT))


def _require_known_format(path: str, manifest: dict) -> int:
    fmt = manifest.get("format", FORMAT)
    if fmt not in (2, 3):
        raise ValueError(
            f"{path}: checkpoint format {fmt}; the port reads formats 2 "
            "and 3 (the JAX package's v1 pickles are not ported: see "
            "ROADMAP.md Queue A)")
    return int(fmt)


def _read_piece_tables(path: str, nproc: Optional[int]) -> dict:
    """leaf id -> [(starts, stops, file, crc32)] over the piece tables of
    processes [0, ``nproc``) (the commit manifest's count: a table left
    by an earlier, larger run is never merged)."""
    names = ([n for n in sorted(os.listdir(path))
              if n.startswith("manifest_p") and n.endswith(".json")]
             if nproc is None
             else [f"manifest_p{p:05d}.json" for p in range(nproc)])
    tables: dict = {}
    for name in names:
        with open(os.path.join(path, name)) as fp:
            for e in json.load(fp)["pieces"]:
                tables.setdefault(e["leaf"], []).append(
                    (e["start"], e["stop"], e["file"], e.get("crc32")))
    return tables


# --------------------------------------------------------------- verify
def _verify_file(path: str, crc: Optional[int]) -> None:
    if not os.path.exists(path):
        raise CheckpointCorrupt(f"missing checkpoint file: {path}")
    if crc is None:  # written before CRCs were recorded: the header only
        try:
            np.load(path, allow_pickle=False, mmap_mode="r")
        except (OSError, ValueError) as e:
            raise CheckpointCorrupt(f"unreadable leaf {path}: {e}") from e
        return
    with open(path, "rb") as fp:
        if _crc32(fp.read()) != crc:
            raise CheckpointCorrupt(
                f"CRC32 mismatch for {path} (truncated or bit-rotted)")


def verify_checkpoint(path: str) -> None:
    """Check the manifest and every leaf file against its CRC32; raise
    ``CheckpointCorrupt`` on any failure."""
    try:
        manifest = _read_manifest(path)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(f"unreadable manifest in {path}: {e}") from e
    if _require_known_format(path, manifest) == 3:
        try:
            tables = _read_piece_tables(path, manifest.get("process_count"))
            leaves = manifest["leaves"]
        except (OSError, ValueError, KeyError) as e:
            raise CheckpointCorrupt(
                f"unreadable piece tables in {path}: {e}") from e
        for i, leaf in enumerate(leaves):
            if not (leaf.get("empty") or leaf.get("none")) and i not in tables:
                raise CheckpointCorrupt(f"{path}: no piece of leaf "
                                        f"{'/'.join(leaf['path'])}")
        for pieces in tables.values():
            for _, _, fname, crc in pieces:
                _verify_file(os.path.join(path, fname), crc)
        return
    for leaf in manifest.get("leaves", []):
        if leaf.get("empty") or leaf.get("none"):
            continue
        _verify_file(os.path.join(path, leaf["file"]), leaf.get("crc32"))


def quarantine_checkpoint(path: str) -> str:
    """Move a corrupt checkpoint aside as ``<name>.corrupt`` (outside the
    ``checkpoint_<n>`` names, so no scan sees it again); returns the new
    path.  An earlier quarantine of the same name is replaced."""
    target = path + CORRUPT_SUFFIX
    if os.path.isdir(target):
        shutil.rmtree(target)
    os.replace(path, target)
    return target


def latest_valid_checkpoint(ckpt_dir: str,
                            quarantine: bool = True) -> Optional[str]:
    """The newest checkpoint that passes ``verify_checkpoint``, scanning
    newest to oldest; those that fail are quarantined (or, with
    ``quarantine=False``, left in place) and skipped."""
    for _, name in reversed(_scan_checkpoints(ckpt_dir)):
        full = os.path.join(ckpt_dir, name)
        try:
            verify_checkpoint(full)
            return full
        except CheckpointCorrupt as e:
            if quarantine:
                moved = quarantine_checkpoint(full)
                logger.warning(
                    f"Corrupt checkpoint quarantined: {full} -> {moved} "
                    f"({e}); falling back to the previous checkpoint.")
            else:
                logger.warning(
                    f"Corrupt checkpoint skipped: {full} ({e}); falling "
                    "back to the previous checkpoint.")
    return None


# -------------------------------------------------------------- restore
def _load_leaf(path: str, leaf: dict) -> np.ndarray:
    full = os.path.join(path, leaf["file"])
    with open(full, "rb") as fp:
        data = fp.read()
    crc = leaf.get("crc32")
    if crc is not None and _crc32(data) != crc:
        raise CheckpointCorrupt(
            f"CRC32 mismatch for {full} (truncated or bit-rotted); restore "
            "from an earlier checkpoint (latest_valid_checkpoint "
            "quarantines and falls back)")
    return np.load(io.BytesIO(data), allow_pickle=False)


def _stitch(path: str, pieces, starts, stops, dtype) -> np.ndarray:
    """The box [starts, stops) of a leaf, from the saved pieces that meet
    it (each read whole and checked against its CRC32)."""
    box = np.empty([hi - lo for lo, hi in zip(starts, stops)], dtype=dtype)
    filled = np.zeros(box.shape, dtype=bool)
    for p_starts, p_stops, fname, crc in pieces:
        lo = [max(a, b) for a, b in zip(starts, p_starts)]
        hi = [min(a, b) for a, b in zip(stops, p_stops)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        src = _load_leaf(path, {"file": fname, "crc32": crc})
        box[tuple(slice(a - b, c - b) for a, c, b in zip(lo, hi, starts))] = \
            src[tuple(slice(a - b, c - b) for a, c, b in zip(lo, hi,
                                                             p_starts))]
        filled[tuple(slice(a - b, c - b)
                     for a, c, b in zip(lo, hi, starts))] = True
    if not filled.all():
        raise CheckpointCorrupt(
            f"{path}: the pieces do not cover [{starts}, {stops}) of a leaf")
    return box


Pick = Callable[[Tuple[str, ...], Tuple[int, ...]],
                Optional[Tuple[Sequence[int], Sequence[int]]]]


def restore_checkpoint(path: str, pick: Optional[Pick] = None
                       ) -> Tuple[dict, dict, int]:
    """(state tree, history, epoch) of a checkpoint: the tree as nested
    dicts of numpy arrays (None and empty dicts as saved), each leaf file
    or piece checked against its CRC32.  A format-3 leaf is stitched
    from its pieces: whole, or where ``pick(path, global shape)`` gives
    ``(starts, stops)``, only that box (a process's own block)."""
    manifest = _read_manifest(path)
    if _require_known_format(path, manifest) == 2:
        pairs = [(tuple(leaf["path"]),
                  {} if leaf.get("empty") else None if leaf.get("none")
                  else _load_leaf(path, leaf))
                 for leaf in manifest["leaves"]]
        return _unflatten(pairs), manifest["history"], manifest["epoch"]
    tables = _read_piece_tables(path, manifest.get("process_count"))
    pairs = []
    for i, leaf in enumerate(manifest["leaves"]):
        lpath = tuple(leaf["path"])
        if leaf.get("empty") or leaf.get("none"):
            pairs.append((lpath, {} if leaf.get("empty") else None))
            continue
        shape = tuple(leaf["shape"])
        box = pick(lpath, shape) if pick is not None else None
        starts, stops = box if box is not None else ([0] * len(shape),
                                                     list(shape))
        pairs.append((lpath, _stitch(path, tables.get(i, []), list(starts),
                                     list(stops), np.dtype(leaf["dtype"]))))
    return _unflatten(pairs), manifest["history"], manifest["epoch"]

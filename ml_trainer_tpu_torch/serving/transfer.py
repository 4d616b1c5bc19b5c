"""Page-granular KV migration between engine replicas (the JAX package's
``serving/transfer.py``), in the JAX package's wire format.

Disaggregated serving (``serving/router.py``) prefills a request on one
replica and decodes it on another, so the request's KV cache moves
between two paged engines mid-stream.  This module is that unit:

* **Export** (:func:`export_kv_slot`): one slot's page chain out of every
  layer's K and V pool, in logical order and padded to ``pages_per_slot``
  rows with the trash page, plus the host state the target needs to go
  on sampling bit for bit: the consumed position, the committed tokens,
  the pending input token, the temperature, the sampler's seed and
  counter.  The pages go through host numpy (the JAX package's migration
  fence): the payload is host bytes before the source slot is released.
* **Import** (:func:`import_kv_slot`): the same number of pages
  allocated in the target pool, the chain bound, the exported rows
  written into the pools in place, the slot's position, token and
  sampler state set in place and the page table uploaded, so the
  captured decode graph reads the imported slot without a recapture.
  The migrated prompt's full blocks go to the target's prefix cache.
  Every refusal (geometry, weights, CRC, memory) comes before a page is
  written.
* **Serialization** (:func:`to_bytes` / :func:`from_bytes`): ``np.savez``
  with a JSON ``meta``, one ``layer_i`` array per pool leaf and a CRC32
  per layer: the JAX package's payload, which each package reads.

The wire's leaf order is the JAX package's: ``tree_flatten_with_path``
over the cache dict, whose keys sort as strings (``block0``, ``block1``,
``block10``, ``block11``, ``block2``, ...), ``cached_key`` before
``cached_value`` in each block (:func:`wire_leaf_order`).

Sampling state: the port samples from an int seed with a per-token
counter (``generate._token_seed``), not ``jax.random`` (ROADMAP.md Queue
C 5).  The port writes its seed where the JAX package writes the key
data, ``rng_key = [seed >> 32, seed & 0xffffffff]`` (``PRNGKey(seed)``'s
data), and its counter in ``step_counter``; greedy continuations are the
same across packages, sampled ones within the port.

bf16 pools ride as their ``uint16`` bits with ``"dtype": "bfloat16"`` in
the meta (no ``ml_dtypes`` needed); the JAX package's reader ignores the
key and takes the bits for integers, and its own bf16 pages come back
from ``np.load`` as 2-byte void records, which the port reads as bf16
bits (ROADMAP.md Queue C 15).

Draft-model caches are not migrated: an adopted slot re-drafts from a
cold draft cache (the n-gram drafter needs nothing).
"""

from __future__ import annotations

import dataclasses
import io
import json
import time
import zipfile
import zlib
from typing import List, Optional

import numpy as np
import torch


class MigrationCorrupt(ValueError):
    """A migration payload failed its per-layer CRC32 check (or does not
    decode): the pages in flight are not the pages the source exported.
    The router retries the adoption on its next candidate with a fresh
    serialization instead of adopting garbage."""


class WeightsMismatch(MigrationCorrupt):
    """The export came from an engine serving other weights than the
    adopting one (``weights_fp`` differ).  KV is not portable across
    weights, so the adoption is refused before any page is written; the
    fleet wire reports it as ``weights_mismatch``."""


@dataclasses.dataclass
class KVSlotExport:
    """One slot's migratable state: the pool geometry, the continuation
    state and the pages (one ``[pages_per_slot, H, page, D]`` array per
    K/V leaf in :func:`wire_leaf_order`, trash-padded past ``n_pages``)."""

    page_size: int
    pages_per_slot: int
    max_len: int
    n_pages: int            # live pages in the chain
    pos: int                # consumed positions (the slot's cache index)
    prompt: np.ndarray      # the request's original prompt (int32)
    tokens: List[int]       # committed tokens so far
    last_token: int         # the pending decode input
    temperature: float
    rng_key: np.ndarray     # uint32[2]: the seed's hi and lo words
    step_counter: int       # the sampler's per-token counter
    layers: List[np.ndarray]
    # Per-layer CRC32 of the pages, taken at export; None on hand-built
    # exports.  Import and deserialization verify before any write.
    crc32s: Optional[List[int]] = None
    # The exporting engine's weights fingerprint; None on hand-built
    # exports.
    weights_fp: Optional[str] = None
    # "bfloat16" when ``layers`` carry bf16 pages as their uint16 bits;
    # None for pages in their own dtype.
    dtype: Optional[str] = None

    def nbytes(self) -> int:
        """The pages' bytes (the metered quantity)."""
        return int(sum(a.nbytes for a in self.layers))

    def verify(self) -> None:
        """Recompute every layer's CRC32; raises ``MigrationCorrupt``
        naming the first bad layer (a no-op without checksums)."""
        if self.crc32s is None:
            return
        if len(self.crc32s) != len(self.layers):
            raise MigrationCorrupt(
                f"kv migration payload corrupt: {len(self.layers)} "
                f"layer(s) but {len(self.crc32s)} checksum(s)")
        for i, (arr, want) in enumerate(zip(self.layers, self.crc32s)):
            got = _crc(arr)
            if got != want:
                raise MigrationCorrupt(
                    f"kv migration payload corrupt: layer {i} CRC32 "
                    f"{got:#010x} != exported {want:#010x} "
                    f"({arr.nbytes} bytes); refusing to adopt")


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def wire_leaf_order(depth: int) -> List[tuple]:
    """``(layer, "k" | "v")`` in the wire's ``layer_i`` order: the JAX
    package's flatten order of ``{"block<i>": {..., "cached_key",
    "cached_value"}}``, block names sorted as strings."""
    blocks = sorted((f"block{i}", i) for i in range(depth))
    return [(i, kv) for _, i in blocks for kv in ("k", "v")]


def _pool_leaves(cache) -> List[torch.Tensor]:
    return [(cache.k if kv == "k" else cache.v)[layer]
            for layer, kv in wire_leaf_order(len(cache.k))]


def _check_paged(engine) -> None:
    if not getattr(engine, "paged", False):
        raise ValueError(
            "KV migration needs a paged engine (kv_page_size > 0): the page "
            "chain is the transfer unit")


def _seed_key(seed: int) -> np.ndarray:
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _key_seed(key: np.ndarray) -> int:
    hi, lo = (int(x) for x in np.asarray(key, np.uint32).reshape(-1)[:2])
    return (hi << 32) | lo


def export_kv_slot(engine, slot: int) -> KVSlotExport:
    """Export ``slot``'s pages and continuation state from ``engine``
    (read-only: the caller releases the slot if the request migrates).
    The slot must hold an active request."""
    _check_paged(engine)
    req = engine._active.get(slot)
    if req is None:
        raise ValueError(f"slot {slot} holds no active request")
    pool = engine.pool
    row = torch.from_numpy(engine._page_row(slot)).to(engine.device).long()
    with torch.no_grad():
        pages = torch.stack([leaf[row] for leaf in _pool_leaves(engine.cache)])
        bf16 = pages.dtype == torch.bfloat16
        if bf16:
            pages = pages.view(torch.int16)
        host = pages.cpu().numpy()  # the migration fence
        last_token = int(engine.tok[slot, 0])
    if bf16:
        host = host.view(np.uint16)
    layers = list(host)
    return KVSlotExport(
        page_size=pool.page_size,
        pages_per_slot=pool.pages_per_slot,
        max_len=engine.max_len,
        n_pages=pool.slot_page_count(slot),
        pos=int(engine._pos[slot]),
        prompt=np.asarray(req.prompt, np.int32).reshape(-1).copy(),
        tokens=[int(t) for t in req.tokens],
        last_token=last_token,
        temperature=float(engine._temps[slot]),
        rng_key=_seed_key(engine._seeds[slot]),
        step_counter=int(engine._steps[slot]),
        layers=layers,
        crc32s=[_crc(a) for a in layers],
        weights_fp=engine.weights_fp,
        dtype="bfloat16" if bf16 else None,
    )


def _page_tensor(arr: np.ndarray, exp: KVSlotExport, leaf: torch.Tensor
                 ) -> torch.Tensor:
    """One exported layer as a tensor of ``leaf``'s dtype: bf16 pages
    from their uint16 bits, or from the 2-byte void records ``np.load``
    gives for the JAX package's bf16 pages (``ml_dtypes``' dtype does not
    survive ``np.savez``)."""
    if exp.dtype == "bfloat16" or (arr.dtype.kind == "V"
                                   and arr.dtype.itemsize == 2):
        if leaf.dtype != torch.bfloat16:
            raise ValueError(
                f"page dtype mismatch: export is bfloat16, target pool "
                f"is {leaf.dtype}")
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    if leaf.dtype == torch.bfloat16:
        raise ValueError(
            f"page dtype mismatch: export is {arr.dtype}, target pool is "
            "bfloat16")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(leaf.dtype)


def import_kv_slot(engine, req, slot: int, exp: KVSlotExport) -> str:
    """Write ``exp`` into ``engine``'s pool at ``slot`` and register
    ``req`` (the continuation: the same prompt, ``tokens`` carrying the
    committed stream) as active.  Returns ``"active"``, ``"no_memory"``
    (the pool cannot hold the chain even after evicting cold prefix
    pages; nothing stays bound) or ``"error"`` (the request was finished
    with a structured error, e.g. an adapter this replica cannot serve).
    Raises ``ValueError`` on a geometry mismatch, ``WeightsMismatch`` and
    ``MigrationCorrupt`` before any page is allocated."""
    _check_paged(engine)
    if slot in engine._active or slot in engine._chunked:
        raise ValueError(f"slot {slot} is already occupied")
    pool = engine.pool
    if (pool.page_size != exp.page_size
            or pool.pages_per_slot != exp.pages_per_slot
            or engine.max_len != exp.max_len):
        raise ValueError(
            f"pool geometry mismatch: export is page_size={exp.page_size} "
            f"x {exp.pages_per_slot} (max_len {exp.max_len}), target is "
            f"{pool.page_size} x {pool.pages_per_slot} (max_len "
            f"{engine.max_len})")
    target_fp = engine.weights_fp
    if (exp.weights_fp is not None and target_fp is not None
            and exp.weights_fp != target_fp):
        raise WeightsMismatch(
            f"weights_mismatch: export from weights {exp.weights_fp}, "
            f"adopting engine serves {target_fp}; KV is not portable "
            "across weights, re-prefill on a replica of the same weights")
    exp.verify()
    leaves = _pool_leaves(engine.cache)
    if len(leaves) != len(exp.layers):
        raise ValueError(
            f"layer count mismatch: export has {len(exp.layers)} pool "
            f"leaves, target model has {len(leaves)}")
    for leaf, arr in zip(leaves, exp.layers):
        if tuple(leaf.shape[1:]) != tuple(arr.shape[1:]):
            raise ValueError(
                f"page geometry mismatch: export page rows "
                f"{tuple(arr.shape[1:])}, target pool "
                f"{tuple(leaf.shape[1:])}")
    n = int(exp.n_pages)
    if not (0 < n <= pool.pages_per_slot
            and 0 < exp.pos <= n * pool.page_size):
        raise ValueError(
            f"export geometry mismatch: {n} page(s) for position {exp.pos} "
            f"at page {pool.page_size} x {pool.pages_per_slot}")
    datas = [_page_tensor(arr[:n], exp, leaf)
             for leaf, arr in zip(leaves, exp.layers)]

    pages = pool.allocate(n)
    if pages is None and engine._prefix is not None:
        engine._prefix.evict(n - pool.free_count())
        pages = pool.allocate(n)
    if pages is None:
        return "no_memory"
    pool.bind_slot(slot, pages)
    # The stream keeps its adapter: bind it here (a residency miss
    # uploads it); a full pool degrades to the requeue path, an unknown
    # adapter is a structured terminal.
    if engine.adapters is not None:
        from ml_trainer_tpu_torch.serving.adapter_pool import (
            AdapterPoolExhausted,
            UnknownAdapter,
        )

        try:
            engine._bind_adapter(req, slot)
        except AdapterPoolExhausted:
            pool.reset_slot(slot)
            return "no_memory"
        except UnknownAdapter as e:
            pool.reset_slot(slot)
            req.finish("error", str(e))
            return "error"
    elif req.adapter:
        pool.reset_slot(slot)
        req.finish(
            "error",
            f"request {req.id} decodes with adapter '{req.adapter}' but the "
            "adopting replica has no adapter pool")
        return "error"
    dev = engine.device
    live = torch.as_tensor(pages, dtype=torch.long, device=dev)
    with torch.no_grad():
        # In place: the decode graph reads these tensors at fixed
        # addresses.
        for leaf, data in zip(leaves, datas):
            leaf[live] = data.to(dev)
        engine.cache.index[slot] = int(exp.pos)
        engine.tok[slot, 0] = int(exp.last_token)
    engine._sync_table()
    engine._pos[slot] = exp.pos
    engine._temps[slot] = exp.temperature
    engine._seeds[slot] = _key_seed(exp.rng_key)
    engine._steps[slot] = exp.step_counter
    if engine.spec_k:
        # The verify window's write cap, priced as admit() prices it.
        engine._caps[slot] = min(
            int(exp.prompt.size) + int(req.max_new_tokens) - 1,
            engine.max_len - engine.spec_k - 1)
    req.slot = slot
    req.state = "active"
    engine._active[slot] = req
    if engine._prefix is not None:
        # The migrated full blocks (everything before ``pos`` is
        # written) go to this replica's prefix cache.
        seq = np.concatenate(
            [np.asarray(exp.prompt, np.int32).reshape(-1),
             np.asarray(exp.tokens, np.int32)])[: exp.pos]
        blocks = exp.pos // pool.page_size
        if blocks:
            engine._prefix.insert(seq, pool.slot_pages[slot][:blocks],
                                  namespace=engine._prefix_ns(req))
    engine._push_kv_metrics()
    return "active"


# ------------------------------------------------------- serialization

def to_bytes(exp: KVSlotExport) -> bytes:
    """One self-describing payload (``np.savez`` with a JSON meta): what
    crosses a socket and what the router meters as migrated bytes."""
    meta = {
        "page_size": exp.page_size,
        "pages_per_slot": exp.pages_per_slot,
        "max_len": exp.max_len,
        "n_pages": exp.n_pages,
        "pos": exp.pos,
        "tokens": list(exp.tokens),
        "last_token": exp.last_token,
        "temperature": exp.temperature,
        "step_counter": exp.step_counter,
        "n_layers": len(exp.layers),
        "weights_fp": exp.weights_fp,
        "crc32s": (list(exp.crc32s) if exp.crc32s is not None
                   else [_crc(a) for a in exp.layers]),
    }
    if exp.dtype is not None:
        meta["dtype"] = exp.dtype
    buf = io.BytesIO()
    np.savez(buf,
             meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             prompt=np.asarray(exp.prompt, np.int32),
             rng_key=np.asarray(exp.rng_key, np.uint32),
             **{f"layer_{i}": a for i, a in enumerate(exp.layers)})
    return buf.getvalue()


def from_bytes(payload: bytes, verify: bool = True) -> KVSlotExport:
    """Deserialize (and by default CRC-verify) a payload.  Raises
    ``MigrationCorrupt`` when the container does not decode or a layer's
    bytes do not match the checksum the exporter wrote."""
    try:
        exp = _from_bytes_unchecked(payload)
    except (ValueError, OSError, KeyError, zipfile.BadZipFile,
            zlib.error) as e:  # json.JSONDecodeError is a ValueError
        raise MigrationCorrupt(
            f"kv migration payload corrupt: undecodable container "
            f"({type(e).__name__}: {e})") from e
    if verify:
        exp.verify()
    return exp


def _from_bytes_unchecked(payload: bytes) -> KVSlotExport:
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        return KVSlotExport(
            page_size=int(meta["page_size"]),
            pages_per_slot=int(meta["pages_per_slot"]),
            max_len=int(meta["max_len"]),
            n_pages=int(meta["n_pages"]),
            pos=int(meta["pos"]),
            prompt=np.asarray(z["prompt"], np.int32),
            tokens=[int(t) for t in meta["tokens"]],
            last_token=int(meta["last_token"]),
            temperature=float(meta["temperature"]),
            rng_key=np.asarray(z["rng_key"], np.uint32),
            step_counter=int(meta["step_counter"]),
            layers=[z[f"layer_{i}"] for i in range(int(meta["n_layers"]))],
            crc32s=[int(c) for c in meta.get("crc32s", [])] or None,
            weights_fp=meta.get("weights_fp"),
            dtype=meta.get("dtype"),
        )


# -------------------------------------------------- request wire identity

def request_wire_meta(req) -> dict:
    """The JSON-safe identity of a request for the fleet wire: prompt,
    sampling state, committed tokens, and the deadline as remaining
    seconds (monotonic clocks do not cross processes)."""
    rng = req.rng
    if rng is not None and not isinstance(rng, (int, np.integer)):
        rng = [int(x) for x in np.asarray(rng, np.uint32).reshape(-1)]
    elif rng is not None:
        rng = int(rng)
    deadline = None
    if req.deadline is not None:
        deadline = max(req.deadline_at - time.monotonic(), 0.001)
    return {
        "id": int(req.id),
        "prompt": [int(t) for t in np.asarray(req.prompt).reshape(-1)],
        "max_new_tokens": int(req.max_new_tokens),
        "temperature": float(req.temperature),
        "rng": rng,
        "eos_token_id": (int(req.eos_token_id)
                         if req.eos_token_id is not None else None),
        "deadline": deadline,
        "tenant": req.tenant,
        "priority": int(req.priority),
        "adapter": req.adapter,
        "tokens": [int(t) for t in req.tokens],
    }


def request_from_wire(meta: dict):
    """Rebuild a port ``Request`` from :func:`request_wire_meta` output
    (either package's).  A JAX key ``[hi, lo]`` becomes the seed those
    words spell; the fresh ``submitted_at`` makes the remaining-seconds
    deadline right on this process's clock; committed tokens ride as the
    resumable prefix.  A ``trace`` context is not read (ROADMAP.md Queue
    A 7)."""
    from ml_trainer_tpu_torch.serving.scheduler import Request

    rng = meta.get("rng")
    if isinstance(rng, (list, tuple)):
        rng = _key_seed(np.asarray(rng, np.uint32))
    req = Request(
        prompt=np.asarray(meta["prompt"], np.int32),
        max_new_tokens=int(meta["max_new_tokens"]),
        temperature=float(meta.get("temperature", 0.0)),
        rng=None if rng is None else int(rng),
        eos_token_id=meta.get("eos_token_id"),
        deadline=meta.get("deadline"),
        tenant=meta.get("tenant", "default"),
        priority=int(meta.get("priority", 0)),
        adapter=meta.get("adapter"),
    )
    req.tokens = [int(t) for t in meta.get("tokens", [])]
    return req

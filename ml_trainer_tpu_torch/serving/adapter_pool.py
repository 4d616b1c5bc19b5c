"""Paged, refcounted LoRA adapter pool: the KV pool's design applied to
adapters (the JAX package's ``serving/adapter_pool.py``; host only).

Serving many fine-tuned variants on one base keeps the adapters' weights
on the card beside the base, gathered per batch row inside the one
decode step (a CUDA graph on the card):

* **Fixed-size slots.**  The device side, owned by the engine, is one
  stack per targeted projection per layer: ``A [S, in, rank]`` and
  ``B [S, rank, out]`` buffers of the engine's serve-mode model, ``S =
  slots``.  Slot 0 is the TRASH adapter: all-zero, pinned, what every
  row with no adapter reads; its delta is an exact zero, so base
  traffic through an engine with adapters decodes bitwise like an
  engine without.
* **One rank bucket.**  Every adapter's A/B is zero-padded to the pool's
  ``rank`` at upload (zero rows and columns add nothing) and its
  ``alpha / rank_trained`` is folded into B in float32 before the cast
  to the stacks' dtype, so adapters of mixed ranks share the stacks'
  shapes: a hot-load writes rows in place and never rebuilds the graph.
* **Host-owned index tables.**  Which slot holds which adapter is
  decided here; the decode step reads the per-row ``adapter_idx`` and
  the stacks as tensors at fixed addresses.
* **Refcount / LRU eviction.**  A slot's count is the number of active
  requests decoding with it.  Loading into a full pool evicts the
  least recently used slot whose count is 0; a held slot is never
  evicted.  When every slot is held, :class:`AdapterPoolExhausted`
  names the adapter that could not load.  Registered artifacts keep a
  host copy, so an evicted adapter reloads on demand.

Numpy and the standard library only: the engine does every device
write.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ml_trainer_tpu_torch.lora import load_lora_artifact

# Refcount sentinel pinning the trash slot 0: never allocated, never
# evicted (the KVPagePool idiom).
_TRASH_PIN = 1 << 30


class AdapterPoolExhausted(RuntimeError):
    """Every adapter slot is held by an active request; the named
    adapter cannot load until one releases.  The engine turns this into
    a structured client error (never a hang)."""


class UnknownAdapter(RuntimeError):
    """A request named an adapter nobody registered (hot-load it first
    via ``Server.load_adapter`` or the ``adapters=`` config)."""


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    """``Server(adapters=...)`` — the serving pool's geometry.

    ``slots``: concurrent resident adapters INCLUDING the trash slot 0
    (so ``slots - 1`` loadable adapters).  ``rank``: the pool's rank
    bucket — every adapter pads up to it (an adapter trained at a
    higher rank is refused at registration).  ``targets``: which Dense
    projections the pool stacks cover; adapters may target a subset
    (missing targets upload as zeros).  ``sources`` optionally
    preregisters artifacts (name -> path/bytes) at server construction.
    """

    slots: int = 9
    rank: int = 8
    targets: Tuple[str, ...] = ("qkv", "proj")
    sources: Optional[Dict[str, object]] = None

    def __post_init__(self):
        from ml_trainer_tpu_torch.models.layers import LORA_TARGETS

        if self.slots < 2:
            raise ValueError(
                f"adapter slots must be >= 2 (slot 0 is the trash "
                f"adapter), got {self.slots}"
            )
        if self.rank < 1:
            raise ValueError(f"adapter rank must be >= 1, got {self.rank}")
        targets = tuple(self.targets)
        bad = [t for t in targets if t not in LORA_TARGETS]
        if not targets or bad:
            raise ValueError(
                f"adapter targets must be a non-empty subset of "
                f"{LORA_TARGETS}, got {self.targets!r}"
            )
        object.__setattr__(self, "targets", targets)


class AdapterPool:
    """Host-side slot allocator + adapter registry (thread-safe: the
    engine loop acquires and releases, any thread may register a
    hot-load).
    """

    def __init__(self, config: AdapterConfig):
        self.config = config
        self.slots = int(config.slots)
        self.rank = int(config.rank)
        self.targets = tuple(config.targets)
        self._lock = threading.Lock()
        # Registered artifacts: host copies (meta, {param_path: array}),
        # which make eviction safe (reload on demand).
        self._registry: Dict[str, tuple] = {}
        self._slot_of: Dict[str, int] = {}
        self._name_of: Dict[int, str] = {}
        self.refcount = np.zeros(self.slots, np.int64)
        self.refcount[0] = _TRASH_PIN
        self._free: collections.deque = collections.deque(
            range(1, self.slots)
        )
        self._clock = itertools.count(1)
        self._last_used = np.zeros(self.slots, np.int64)
        # Counters feeding serving_adapter_{hits,loads,evictions}_total.
        self.hits = 0
        self.loads = 0
        self.evictions = 0
        for name, src in sorted((config.sources or {}).items()):
            self.register(name, src)

    # -- registry ---------------------------------------------------------

    def register(self, name: str, source) -> dict:
        """Register an adapter artifact under ``name`` (the hot-load
        surface; thread-safe; a re-register replaces: the NEXT
        acquire of an unheld adapter sees the new weights).  Returns the
        artifact meta.  Raises ``ValueError`` when the artifact's rank
        exceeds the pool bucket or targets fall outside the pool's."""
        if not isinstance(name, str) or not name:
            raise ValueError(f"adapter name must be a non-empty string, "
                             f"got {name!r}")
        meta, leaves = load_lora_artifact(source)
        rank = int(meta["rank"])
        if rank > self.rank:
            raise ValueError(
                f"adapter '{name}' rank {rank} exceeds the pool's rank "
                f"bucket {self.rank} — size the pool for your largest "
                "adapter"
            )
        extra = [t for t in meta.get("targets", []) if t not in self.targets]
        if extra:
            raise ValueError(
                f"adapter '{name}' targets {extra} not covered by the "
                f"pool's targets {self.targets}"
            )
        with self._lock:
            replacing = name in self._slot_of
            self._registry[name] = (meta, leaves)
            if replacing:
                # Re-register of a RESIDENT adapter: drop the stale slot
                # (refused while held — the running stream keeps the
                # weights it started with).
                slot = self._slot_of[name]
                if self.refcount[slot] == 0:
                    self._evict_slot(slot)
        return meta

    def registered(self) -> List[str]:
        with self._lock:
            return sorted(self._registry)

    def resident(self) -> List[str]:
        """Adapters holding a device slot now (``Server.health()``'s
        ``adapters_resident``)."""
        with self._lock:
            return sorted(self._slot_of)

    def artifact(self, name: str) -> Optional[tuple]:
        with self._lock:
            return self._registry.get(name)

    # -- slot lifecycle ---------------------------------------------------

    def _evict_slot(self, slot: int) -> None:
        # Caller holds the lock.
        name = self._name_of.pop(slot)
        del self._slot_of[name]
        self._free.append(slot)

    def acquire(self, name: str) -> Tuple[int, Optional[tuple]]:
        """Pin ``name`` for one request: returns ``(slot, upload)``
        where ``upload`` is None on a residency hit, else the
        ``(meta, leaves)`` the engine must upload into ``slot`` before
        the next dispatch.  Refcounts the slot either way; raises
        :class:`UnknownAdapter` / :class:`AdapterPoolExhausted`
        (naming the adapter) instead of blocking."""
        with self._lock:
            art = self._registry.get(name)
            if art is None:
                raise UnknownAdapter(
                    f"unknown adapter '{name}': not registered on this "
                    f"server (registered: {sorted(self._registry) or '[]'})"
                )
            slot = self._slot_of.get(name)
            if slot is not None:
                self.refcount[slot] += 1
                self._last_used[slot] = next(self._clock)
                self.hits += 1
                return slot, None
            if not self._free:
                # LRU among refcount-0 residents; held slots are never
                # evicted (the running streams own their weights).
                candidates = [
                    s for s in self._name_of if self.refcount[s] == 0
                ]
                if not candidates:
                    raise AdapterPoolExhausted(
                        f"adapter pool exhausted loading '{name}': all "
                        f"{self.slots - 1} slot(s) held by active "
                        "requests; retry when one finishes or size the "
                        "pool up (AdapterConfig.slots)"
                    )
                victim = min(candidates, key=lambda s: self._last_used[s])
                self._evict_slot(victim)
                self.evictions += 1
            slot = self._free.popleft()
            self._slot_of[name] = slot
            self._name_of[slot] = name
            self.refcount[slot] = 1
            self._last_used[slot] = next(self._clock)
            self.loads += 1
            return slot, art

    def release(self, slot: int) -> None:
        """Drop one request's pin on ``slot`` (trash slot 0 is a no-op —
        base-model rows).  The adapter STAYS resident at refcount 0
        (warm for the next request) until eviction needs the slot."""
        if slot == 0:
            return
        with self._lock:
            if self.refcount[slot] <= 0:
                raise ValueError(f"release of unheld adapter slot {slot}")
            self.refcount[slot] -= 1

    def slot_name(self, slot: int) -> Optional[str]:
        with self._lock:
            return self._name_of.get(slot)

    def free_count(self) -> int:
        """Slots holding no adapter at all (evictable refcount-0
        residents are NOT counted free — they are warm cache)."""
        with self._lock:
            return len(self._free)

    def used_count(self) -> int:
        with self._lock:
            return len(self._name_of)

    def counters(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "loads": self.loads,
                "evictions": self.evictions,
            }


def prepare_upload(meta: dict, leaves: Dict[str, np.ndarray],
                   stack_shapes: Dict[str, tuple],
                   rank: int) -> Dict[str, np.ndarray]:
    """Shape one artifact for the pool's rank bucket: for every stack
    leaf path (``block0/attn/qkv_lora_A`` style, stack shape
    ``[S, in, rank]`` / ``[S, rank, out]``) produce the ``[in, rank]``
    / ``[rank, out]`` row to scatter into the slot —

    * A pads ``[in, r_trained] -> [in, rank]`` with zero columns;
    * B pads ``[r_trained, out] -> [rank, out]`` with zero rows AND
      folds the ``alpha/r_trained`` scale in (zero-padding is exact:
      padded rank components contribute 0 to xAB);
    * targets the adapter does not carry upload as zeros (base
      behavior for that projection).

    Host numpy in float32: the engine casts each row to the stacks'
    dtype and copies it into the slot in place."""
    r_trained = int(meta["rank"])
    scale = float(meta["alpha"]) / r_trained
    out: Dict[str, np.ndarray] = {}
    for path, shape in stack_shapes.items():
        want = tuple(shape[1:])                     # drop the slot dim
        src = leaves.get(path)
        if src is None:
            out[path] = np.zeros(want, np.float32)
            continue
        src = np.asarray(src, np.float32)
        if path.endswith("_lora_A"):
            if src.shape[0] != want[0] or src.shape[1] > rank:
                raise ValueError(
                    f"adapter leaf '{path}' shape {src.shape} does not "
                    f"fit stack row {want}"
                )
            row = np.zeros(want, np.float32)
            row[:, : src.shape[1]] = src
        else:
            if src.shape[1] != want[1] or src.shape[0] > rank:
                raise ValueError(
                    f"adapter leaf '{path}' shape {src.shape} does not "
                    f"fit stack row {want}"
                )
            row = np.zeros(want, np.float32)
            row[: src.shape[0], :] = src * scale
        out[path] = row
    return out

"""Slot-based continuous-batching decode engine (the JAX package's
``serving/engine.py``, contiguous and paged).

* **Slots.**  One decode cache at batch ``max_batch``; a request owns one
  row (slot) for its lifetime and every row sits at its own position.
* **Prefill.**  A new request prefills at batch 1: its prompt is
  right-padded to the next power-of-two bucket, one causal forward fills
  a batch-1 contiguous cache (the flash kernel's route from bucket 128
  up), the true-length logits sample token 0, and the K/V rows are
  inserted into the slot (paged mode: scattered into its pages).  The
  padded tail's K/V is never attended and later tokens overwrite it.
* **Decode.**  All slots advance through one forward on ``[max_batch,
  1]`` tokens with per-row sampling; requests join and leave at token
  boundaries.  In paged mode with ``paged_kernel`` the S == 1 attention
  is the paged-attention kernel.
* **The decode program.**  On the card the forward is one CUDA graph
  (``step_graph.StepGraph``), the counterpart of the JAX engine's
  ``jax.jit`` decode program with the cache and tokens donated: the first
  step runs for real on the capture's side stream (the warm-up), the
  second captures the forward, and it and every later step are one
  replay.  The graph reads and writes fixed tensors only: the tokens
  ``tok``, the ``select`` rows, the cache's pools, positions and page
  table, and the int8 collection; the logits are the graph's own tensor,
  which the next replay overwrites.  One graph covers every batch of
  live slots, since free slots decode masked rows nobody reads.
  Sampling, the host read, page growth, preemption and the table upload
  run outside it, on the same stream.  On the CPU the forward runs
  eagerly.  A failed capture raises; nothing falls back to eager.
* **Int8 decode** (``quant_int8``): the "quant" collection
  (``ops/kernels/int8_matmul.quantize_tree``) is built once from the
  model's weights, and only the S == 1 decode step reads it: its four
  projections per block are int8 matmuls (the K7 kernel on the card).
  Both prefills stay fp32, as in the reference, so the prompt's K/V are
  the fp32 model's.
* **Paged mode** (``kv_page_size > 0``): K/V live in one page pool behind
  host-owned page tables (``kv_pool.py``); a radix prefix cache
  (``prefix_cache.py``, namespaced by tenant by default) lets a request
  whose prompt shares full blocks with a cached one skip their prefill:
  only the suffix runs, as a continuation window at the slot's offset.
  Under page pressure the engine evicts cold prefix pages first, then
  preempts a victim, which re-queues with its generated tokens as a
  resumable prefix.

* **LoRA adapters** (``adapters=AdapterConfig(...)``, the GPT-2
  family): the engine serves a clone of the model in serve mode
  (``GPT2.clone(lora_slots=S, ...)``, over the same base tensors) whose
  stack buffers ``A [S, in, r]``/``B [S, r, out]`` per targeted
  projection are allocated once, with one ``[max_batch]`` int64
  ``adapter_idx``.  ``serving/adapter_pool.py`` decides which slot holds
  which adapter; an admission pins the request's adapter (a miss
  copies the prepared rows into its slot, ``copy_`` in place) and the
  prefill gathers it at batch 1; each decode step's rows gather theirs
  from ``adapter_idx``, filled with ``copy_`` before the replay after a
  change.  So a hot-load or an eviction after the capture rebuilds
  nothing and the next replay serves the new weights.  Slot 0 is zero:
  rows with no adapter decode bitwise like an engine without adapters.
  An unknown adapter or a full pool fails the request with a structured
  error.  The prefix cache's namespace always carries the adapter.

* **Speculative decoding** (``spec_k > 0``, ``speculative.py``): each
  step drafts ``spec_k`` tokens per slot (the n-gram lookup over the
  request's prompt and tokens, or a draft model decoding greedily in its
  own contiguous slot cache), scores the ``[max_batch, spec_k + 1]``
  window in ONE target forward (the contiguous cache's windowed mode, or
  the paged window write; plain masked attention, eagerly, never the
  decode graph) and commits each slot's accepted prefix plus one token.
  The host's ``pos`` sets the cache's index before the verify and after
  it (the rollback).  Greedy slots commit the vanilla stream.
* **Chunked prefill** (``prefill_chunk``, paged only): a prompt longer
  than ``prefill_chunk`` prefills in page-aligned windows, one per
  serving-loop iteration (``advance_chunks``), each the paged
  continuation at the slot's offset; decode steps run between them.
  The slot is held (``free_capacity`` counts it) but not active; its
  row still rides every decode step, whose S == 1 write lands at the
  next window's first position (the window overwrites it).  The
  sampler's counter does not consume, so the last window draws the
  unchunked first token.
* **The front end's hooks** (``serving/api.py``): each admission marks
  the request's lifecycle (``prefill_start``, ``prefill_chunk``,
  ``prefill_done`` with its milliseconds, ``preempt``,
  ``adapter_loaded``) and records TTFT and the queue wait by tenant at
  its first token; ``prefill_secs`` is taken at the host read of the
  prefill's token, so it spans the device work.  ``degradation_level``
  3 sheds a fresh prefix-cache miss (state ``"shed"``, ``retry_after``
  ``shed_retry_after``), and ``spec_enabled`` off (rung 2) runs vanilla
  steps.  ``step`` first drops the cancelled requests, then advances the
  decode-step clock ``_step_seq`` and runs the ``decode_wedge`` fault's
  hook (``resilience/faults.py``) before the step's forward is issued.

* **KV migration** (``serving/transfer.py``; the router's disaggregated
  serving): ``export_slot`` reads a slot's pages and sampler state out,
  ``import_slot`` writes them into a free slot in place (pools, tokens,
  positions, the page table), so the decode graph serves the imported
  slot without a recapture (``graph_captures`` stays 1).  ``weights_fp``
  is the JAX engine's fingerprint of the same weights: an export
  imports only where they match.

Sampling follows ``generate.sample_rows``: greedy argmax, or per request
a generator seeded from ``(rng, t)`` per token, so a served request
reproduces the port's ``generate()`` for it.  A model without a
slot-indexed cache (Llama: no ``new_paged_cache``) is refused.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ml_trainer_tpu_torch.convert import flax_path
from ml_trainer_tpu_torch.device import check_model_device
from ml_trainer_tpu_torch.generate import sample_rows
from ml_trainer_tpu_torch.ops.kernels.int8_matmul import quantize_tree
from ml_trainer_tpu_torch.resilience.faults import active_plan
from ml_trainer_tpu_torch.serving.adapter_pool import (
    AdapterConfig,
    AdapterPool,
    AdapterPoolExhausted,
    UnknownAdapter,
    prepare_upload,
)
from ml_trainer_tpu_torch.serving.kv_pool import KVPagePool
from ml_trainer_tpu_torch.serving.metrics import ServingMetrics
from ml_trainer_tpu_torch.serving.prefix_cache import PrefixCache
from ml_trainer_tpu_torch.serving.scheduler import Request
from ml_trainer_tpu_torch.speculative import (
    DraftModelDrafter,
    NgramDrafter,
    draft_scan,
    verify,
)
from ml_trainer_tpu_torch.step_graph import (
    StepGraph,
    give_back_stream,
    synchronize,
)


def weights_fp(model) -> str:
    """``checkpoint.weights_fingerprint`` over the model's parameters in
    the flax names and layouts, which equals the JAX engine's
    ``weights_fp`` for the same weights.  Kept on the model while its
    parameters are the same tensors at the same versions (an in-place
    update bumps a tensor's version), so the replicas of one model pay
    for one host copy."""
    from ml_trainer_tpu_torch.checkpoint import weights_fingerprint
    from ml_trainer_tpu_torch.convert import variables_to_jax

    key = tuple((id(p), p._version) for p in model.parameters())
    cached = getattr(model, "_weights_fp", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        fp = weights_fingerprint(
            {"params": variables_to_jax(model)["params"]})
    model._weights_fp = (key, fp)
    return fp


class SlotDecodeEngine:
    """The slot cache and the admit/step logic.  Single-threaded: one
    worker (``serving/api.py``'s loop) calls ``admit`` and ``step``."""

    # Continuation windows bucket to powers of two, floored at 8.
    _MIN_SUFFIX_BUCKET = 8
    # The decode step as a CUDA graph on the card; False runs it eagerly
    # there too (the baseline that chip_smoke.py and the tests compare).
    _decode_graph = True

    def __init__(self, model, max_batch: int = 8,
                 metrics: Optional[ServingMetrics] = None,
                 kv_page_size: int = 0, kv_pages: int = 0,
                 paged_kernel: bool = False, prefix_cache: bool = True,
                 prefix_scope: str = "tenant", max_preemptions: int = 8,
                 spec_k: int = 0, drafter="ngram", ngram_n: int = 3,
                 adapters=None, quant_int8: bool = False,
                 prefill_chunk: int = 0, device=None):
        if spec_k < 0 or spec_k >= int(model.max_len):
            raise ValueError(
                f"spec_k must be in [0, max_len={model.max_len}), "
                f"got {spec_k}")
        if quant_int8 and spec_k:
            raise ValueError(
                "quant_int8 with spec_k > 0 is not supported: the verify "
                "window runs the fp32 program, so acceptance would compare "
                "int8 drafts against fp32 verify (serve quantized with "
                "spec_k=0)")
        if quant_int8 and adapters is not None:
            raise ValueError(
                "quant_int8 with adapters is not supported: LoRA deltas "
                "attach to the fp32 projections the quantized program does "
                "not read (serve quantized without adapters)")
        if adapters is not None and spec_k:
            raise ValueError(
                "adapters with spec_k > 0 is not supported yet: the "
                "speculative verify window does not thread the adapter "
                "gather (serve adapters with spec_k=0)")
        if not hasattr(model, "new_paged_cache"):
            # The engine writes each slot's cache row at its own position;
            # in the JAX package only MultiHeadAttention has that mode, so
            # its Server cannot serve a Llama (GQAttention) either.
            raise NotImplementedError(
                f"serving {type(model).__name__} is not ported: it has no "
                "slot-indexed decode cache (the JAX engine's lacks one "
                "too); see ROADMAP.md Queue A")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if prefix_scope not in ("tenant", "global"):
            raise ValueError(f"prefix_scope must be 'tenant' or 'global', "
                             f"got {prefix_scope!r}")
        self.device = check_model_device(model, device)
        self.model = model
        # The identity of the weights served (the JAX engine's, over the
        # flax tree): KV migrates only between engines that share it
        # (``transfer.import_kv_slot`` raises ``WeightsMismatch``).
        self.weights_fp = weights_fp(model)
        self.max_batch = max_batch
        self.max_len = int(model.max_len)
        self.vocab_size = int(model.vocab_size)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.prefix_scope = prefix_scope
        self.max_preemptions = int(max_preemptions)
        self.kv_page_size = int(kv_page_size)
        self.paged = self.kv_page_size > 0
        self.paged_kernel = bool(paged_kernel)
        self.pool: Optional[KVPagePool] = None
        self._prefix: Optional[PrefixCache] = None
        self._preempted: List[Request] = []
        if self.paged_kernel and not self.paged:
            raise ValueError(
                "paged_kernel needs paged KV (kv_page_size > 0): the kernel "
                "fuses the page-table gather into the decode attention step"
            )
        if self.paged:
            if self.max_len % self.kv_page_size:
                raise ValueError(f"kv_page_size ({kv_page_size}) must divide "
                                 f"max_len ({self.max_len})")
            pages_per_slot = self.max_len // self.kv_page_size
            # Default pool: full contiguous capacity plus the trash page.
            self.kv_pages = int(kv_pages) or max_batch * pages_per_slot + 1
            self.pool = KVPagePool(self.kv_pages, self.kv_page_size,
                                   self.max_len, max_batch)
            if prefix_cache:
                self._prefix = PrefixCache(self.pool)
            self.cache = model.new_paged_cache(
                max_batch, self.kv_pages, self.kv_page_size,
                paged_kernel=self.paged_kernel)
            # Device bytes of one page over every layer's K and V.
            self._page_bytes = sum(
                t.numel() * t.element_size()
                for t in self.cache.k + self.cache.v) // self.kv_pages
        else:
            if kv_pages:
                raise ValueError("kv_pages needs kv_page_size > 0")
            self.kv_pages = 0
            self.cache = model.new_cache(max_batch)
            # With spec_k, S > 1 calls on the slot cache are verify
            # windows.
            self.cache.windowed = bool(spec_k)
        # Chunked prefill: page-aligned windows through the paged
        # continuation, so it needs the paged cache.
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk:
            if not self.paged:
                raise ValueError(
                    "prefill_chunk needs paged KV (kv_page_size > 0): "
                    "chunk windows are continuation-window prefills at "
                    "the slot's page-aligned offset")
            if self.prefill_chunk % self.kv_page_size:
                raise ValueError(
                    f"prefill_chunk ({prefill_chunk}) must be a multiple "
                    f"of kv_page_size ({kv_page_size}): every window "
                    "boundary must land on a page boundary")
            if spec_k:
                raise ValueError(
                    "prefill_chunk with spec_k > 0 is not supported yet: "
                    "the draft cache has no continuation-window prefill "
                    "(serve chunked prefill with spec_k=0)")
        # Chunk-in-progress slots: slot -> dispatch state.  They hold
        # their slot but are not in ``_active`` until the last window.
        self._chunked: Dict[int, dict] = {}
        # The decode step's int8 weights, or None for the fp32 program.
        self.quant = None
        if quant_int8:
            self.quant = quantize_tree(model)
            if not self.quant:
                raise ValueError(
                    "quant_int8 found no quantizable projections in the "
                    "model (expected qkv/proj/fc_in/fc_out nn.Linear "
                    "layers)")
        # The decode step's inputs, at fixed addresses for its graph: the
        # tokens (written in place by admissions and by each step's
        # sampling) and the rows whose logits it returns (all S == 1).
        self.tok = torch.zeros((max_batch, 1), dtype=torch.long,
                               device=self.device)
        self._select = torch.zeros(max_batch, dtype=torch.long,
                                   device=self.device)
        # The adapter pool and the serve-mode model over the same base.
        self.adapters: Optional[AdapterPool] = None
        self._serve_model = model
        self._adapter_rows = np.zeros((max_batch,), np.int64)
        self._adapter_idx = None
        self._rows_dirty = False
        if adapters is not None:
            self._init_adapters(adapters)
        self._graphed = self._decode_graph and self.device.type == "cuda"
        self._graph: Optional[StepGraph] = None
        # Decode-graph captures over the engine's life (one, whatever
        # is imported or hot-loaded, unless ``close`` dropped the graph).
        self.graph_captures = 0
        self._temps = np.zeros((max_batch,), np.float32)
        self._seeds = np.zeros((max_batch,), np.int64)
        self._steps = np.zeros((max_batch,), np.int64)
        # Host mirror of each slot's consumed-token count.
        self._pos = np.zeros((max_batch,), np.int64)
        self._active: Dict[int, Request] = {}
        self._init_spec(int(spec_k), drafter, int(ngram_n))
        # Decode steps run: the decode_wedge fault's clock.
        self._step_seq = 0
        # The fault plan whose decode_wedge holds the loop right now
        # (``Server.close`` releases it).
        self._holding = None
        # Overload control (serving/overload.py): the ladder's rung and
        # the backoff a shed request is told.
        self.degradation_level = 0
        self.shed_retry_after = 2.0

    # -- speculative decoding (speculative.py) ---------------------------

    def _init_spec(self, spec_k: int, drafter, ngram_n: int) -> None:
        """The drafter, the write caps and the draft model's contiguous
        slot cache.  ``spec_enabled`` turns speculation off without a
        new engine (vanilla decode steps over the same slots)."""
        self.spec_k = spec_k
        self.spec_enabled = True
        self._ngram: Optional[NgramDrafter] = None
        self._draft: Optional[DraftModelDrafter] = None
        if not spec_k:
            return
        if isinstance(drafter, str) and drafter == "ngram":
            self._ngram = NgramDrafter(k=spec_k, n=ngram_n)
        elif isinstance(drafter, DraftModelDrafter):
            self._draft = drafter
        elif isinstance(drafter, torch.nn.Module) and hasattr(drafter,
                                                              "max_len"):
            self._draft = DraftModelDrafter(drafter)
        else:
            raise ValueError(
                "drafter must be 'ngram', a DraftModelDrafter or a model, "
                f"got {drafter!r}")
        # The verify window writes spec_k + 1 positions from pos, so pos
        # is capped to keep every write inside max_len.
        self._caps = np.full((self.max_batch,), self.max_len - spec_k - 1,
                             np.int64)
        if self._draft is not None:
            d_model = self._draft.model
            self._draft.check_compatible(self.model)
            check_model_device(d_model, self.device)
            if int(d_model.max_len) < self.max_len:
                raise ValueError(
                    f"draft model max_len ({d_model.max_len}) must cover "
                    f"the target's ({self.max_len})")
            # The draft model keeps a contiguous slot cache: it is small
            # by design, so paging its K/V buys nothing.
            self._draft_cache = d_model.new_cache(self.max_batch)

    # -- LoRA adapters (serving/adapter_pool.py) -------------------------

    def _init_adapters(self, adapters) -> None:
        if isinstance(adapters, dict):
            adapters = AdapterConfig(**adapters)
        if not isinstance(adapters, AdapterConfig):
            raise ValueError(
                "adapters must be an AdapterConfig (or its kwargs dict), "
                f"got {type(adapters).__name__}")
        if not (hasattr(self.model, "lora_rank")
                and hasattr(self.model, "clone")):
            raise ValueError(
                f"{type(self.model).__name__} does not carry the lora_* "
                "knobs (only the GPT-2 family serves adapters)")
        self._serve_model = self.model.clone(
            lora_rank=int(adapters.rank), lora_slots=int(adapters.slots),
            lora_targets=tuple(adapters.targets))
        self.adapters = AdapterPool(adapters)  # registers the sources
        # Stack buffers by the flax path prepare_upload keys them with
        # (``blocks.0.attn.qkv_lora_A`` -> ``block0/attn/qkv_lora_A``).
        self._stacks = {
            "/".join(flax_path(name.rpartition(".")[0])
                     + [name.rpartition(".")[2]]): buf
            for name, buf in self._serve_model.named_buffers()
            if "_lora_" in name}
        self._stack_shapes = {k: tuple(v.shape)
                              for k, v in self._stacks.items()}
        self._adapter_idx = torch.zeros(self.max_batch, dtype=torch.long,
                                        device=self.device)

    def _upload(self, rows: Dict[str, np.ndarray], slot: int) -> None:
        """Write one adapter's prepared rows into ``slot`` of every stack
        in place (cast on the host to the stacks' dtype)."""
        for path, buf in self._stacks.items():
            buf[slot].copy_(torch.from_numpy(rows[path]).to(buf.dtype))

    def _bind_adapter(self, req: Request, slot: int) -> None:
        """Pin ``req``'s adapter for its slot's lifetime: a resident one
        repoints the row, a miss uploads the registered artifact into a
        (possibly evicted) slot.  Raises ``UnknownAdapter`` /
        ``AdapterPoolExhausted``."""
        if not req.adapter:
            self._set_row(slot, 0)
            return
        aslot, upload = self.adapters.acquire(req.adapter)
        if upload is not None:
            meta, leaves = upload
            self._upload(prepare_upload(meta, leaves, self._stack_shapes,
                                        self.adapters.rank), aslot)
            req.mark("adapter_loaded", adapter=req.adapter, slot=aslot)
        self._set_row(slot, aslot)
        self._push_adapter_metrics()

    def _set_row(self, slot: int, aslot: int) -> None:
        if self._adapter_rows[slot] != aslot:
            self._adapter_rows[slot] = aslot
            self._rows_dirty = True

    def _release_adapter(self, slot: int) -> None:
        """Drop the slot's adapter pin (idempotent: the row returns to
        the unpinned slot 0)."""
        if self.adapters is None:
            return
        idx = int(self._adapter_rows[slot])
        if idx:
            self._set_row(slot, 0)
            self.adapters.release(idx)
            self._push_adapter_metrics()

    def _adapter_bytes_per_slot(self) -> int:
        """Device bytes one adapter slot takes over every stack."""
        total = sum(b.numel() * b.element_size()
                    for b in self._stacks.values())
        return total // max(self.adapters.slots, 1)

    def _push_adapter_metrics(self) -> None:
        if self.adapters is None:
            return
        pool = self.adapters
        counters = pool.counters()
        self.metrics.record_adapters(
            free=pool.free_count(), used=pool.used_count(),
            total=pool.slots - 1, resident=pool.resident(),
            hits=counters["hits"], loads=counters["loads"],
            evictions=counters["evictions"],
            bytes_per_slot=self._adapter_bytes_per_slot())

    def _row_idx(self, slot: int):
        """The batch-1 prefill's ``adapter_idx`` for ``slot`` (None
        without adapters)."""
        if self.adapters is None:
            return None
        return torch.tensor([int(self._adapter_rows[slot])],
                            dtype=torch.long, device=self.device)

    # -- paged memory management ----------------------------------------

    def _sync_table(self) -> None:
        """Upload the host page table when it changed, so that a step
        never writes through a stale table into a recycled page."""
        if not self.paged or not self.pool.dirty:
            return
        self.cache.table.copy_(torch.from_numpy(self.pool.page_table))
        self.pool.dirty = False

    def _prefix_ns(self, req: Request) -> str:
        """The prefix cache's namespace: the tenant (``prefix_scope=
        "global"``: one shared trie), and with adapters ALWAYS also the
        request's adapter, since cached K/V depend on the adapter that
        prefilled them."""
        ns = req.tenant if self.prefix_scope == "tenant" else ""
        if self.adapters is not None:
            ns = f"{ns}\x1fadapter={req.adapter or ''}"
        return ns

    def _page_row(self, slot: int) -> np.ndarray:
        row = np.zeros((self.pool.pages_per_slot,), np.int32)
        chain = self.pool.slot_pages[slot]
        row[: len(chain)] = chain
        return row

    def _release_slot_pages(self, slot: int, req: Optional[Request] = None,
                            donate: bool = True) -> None:
        """Return a slot's pages (idempotent); with ``donate``, its
        written full blocks go to the prefix cache first.  Drops the
        slot's adapter pin too (every path that frees a slot comes here,
        paged or not)."""
        self._release_adapter(slot)
        if not self.paged:
            return
        chain = self.pool.slot_pages[slot]
        if chain and donate and self._prefix is not None and req is not None:
            blocks = int(self._pos[slot]) // self.kv_page_size
            if blocks:
                seq = np.concatenate([
                    np.asarray(req.prompt, np.int32).reshape(-1),
                    np.asarray(req.tokens, np.int32),
                ])
                self._prefix.insert(seq, chain[:blocks],
                                    namespace=self._prefix_ns(req))
        self.pool.reset_slot(slot)
        self._push_kv_metrics()

    def _push_kv_metrics(self) -> None:
        if not self.paged:
            return
        self.metrics.record_kv(
            self.pool.free_count(), self.pool.used_count(),
            self.kv_pages - 1,
            len(self._prefix) if self._prefix is not None else 0,
            bytes_per_page=self._page_bytes,
        )
        if self._prefix is not None:
            self.metrics.record_prefix_stats(
                self._prefix.hits, self._prefix.misses,
                self._prefix.hit_tokens, self._prefix.lookup_tokens,
            )

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """The lowest priority first, and within it the youngest
        admission (it loses the least work)."""
        candidates = [(req.priority, -(req.admitted_at or 0.0), slot)
                      for slot, req in self._active.items() if slot != exclude]
        return min(candidates)[2] if candidates else None

    def _preempt(self, slot: int, cause: str) -> None:
        """Evict ``slot`` under page pressure: donate its written blocks,
        free the rest, and queue it for resumption (or fail it after
        ``max_preemptions``)."""
        req = self._active.pop(slot)
        req.preemptions += 1
        req.mark("preempt", slot=slot, cause=cause)
        self.metrics.record_preemption(req.tenant)
        self._release_slot_pages(slot, req, donate=True)
        if req.preemptions > self.max_preemptions:
            req.finish(
                "error",
                f"request {req.id} (tenant '{req.tenant}') preempted "
                f"{req.preemptions}x under page pressure ({cause}); "
                f"giving up after max_preemptions={self.max_preemptions}",
            )
        else:
            self._preempted.append(req)

    def drain_preempted(self) -> List[Request]:
        out, self._preempted = self._preempted, []
        return out

    def _ensure_pages(self, window: int) -> List[int]:
        """Grow every active slot's chain to cover its next ``window``
        writes; evict prefix pages, then preempt, under pressure.
        Returns the slots freed by preemption."""
        freed: List[int] = []
        pool = self.pool
        for slot in sorted(self._active):
            if slot not in self._active:
                continue
            need_tokens = min(int(self._pos[slot]) + window, self.max_len)
            need = min(pool.pages_for(need_tokens), pool.pages_per_slot)
            short = need - pool.slot_page_count(slot)
            if short <= 0:
                continue
            pages = None
            while slot in self._active:
                pages = pool.allocate(short)
                if pages is not None:
                    break
                want = short - pool.free_count()
                cause = (f"page_pressure: slot {slot} needs {short} page(s), "
                         f"{pool.free_count()} free of {self.kv_pages - 1}")
                if self._prefix is not None and self._prefix.evict(want) > 0:
                    continue
                victim = self._pick_victim(exclude=slot)
                if victim is None:
                    self._preempt(slot, cause)
                    freed.append(slot)
                    break
                self._preempt(victim, cause)
                freed.append(victim)
            if pages is not None and slot in self._active:
                pool.extend_slot(slot, pages)
        if freed:
            self._push_kv_metrics()
        return freed

    # -- KV migration (serving/transfer.py) -------------------------------

    def export_slot(self, slot: int):
        """``slot``'s page chain and continuation state (the unit the
        router ships to a decode replica); read-only."""
        from ml_trainer_tpu_torch.serving.transfer import export_kv_slot

        return export_kv_slot(self, slot)

    def import_slot(self, req: Request, slot: int, export) -> str:
        """Write an exported chain into ``slot`` and register ``req`` as
        active: ``"active"``, ``"no_memory"`` (the caller requeues ``req``,
        which resumes by a prefill of its committed tokens) or
        ``"error"``."""
        from ml_trainer_tpu_torch.serving.transfer import import_kv_slot

        return import_kv_slot(self, req, slot, export)

    # -- serving ---------------------------------------------------------

    def free_capacity(self) -> int:
        return self.max_batch - len(self._active) - len(self._chunked)

    def active_count(self) -> int:
        return len(self._active)

    def chunking_count(self) -> int:
        return len(self._chunked)

    def admit(self, req: Request, slot: int) -> str:
        """Prefill ``req`` into ``slot`` and emit its first token.
        Returns ``"active"``, ``"finished"`` (EOS or budget on token 0,
        or a structured error), ``"no_memory"`` (paged: the pool cannot
        hold the prompt now; the caller re-queues it), or ``"chunking"``
        (``prefill_chunk``: the first window ran and the slot is held;
        ``advance_chunks`` runs the rest)."""
        if slot in self._active or slot in self._chunked:
            raise ValueError(f"slot {slot} is already occupied")
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        done_tokens = len(req.tokens)
        if done_tokens:  # preempt-resume: committed tokens join the prompt
            prompt = np.concatenate([prompt, np.asarray(req.tokens, np.int32)])
        p = prompt.shape[0]
        shared: List[int] = []
        c = 0
        if self.paged:
            if self._prefix is not None:
                shared, c = self._prefix.lookup(
                    prompt, (p - 1) // self.kv_page_size,
                    namespace=self._prefix_ns(req),
                    record=not req.kv_blocked,
                )
                req.prefix_hit_tokens = c
            if (self.degradation_level >= 3 and c == 0 and done_tokens == 0
                    and self._prefix is not None):
                # Rung 3 (hits_only): a fresh prefix-cache miss is shed
                # with a structured 503 instead of a full prefill; a
                # resume (committed tokens) is never shed.
                if shared:
                    self.pool.release(shared)
                req.retry_after = self.shed_retry_after
                req.finish(
                    "shed",
                    f"request {req.id} (tenant '{req.tenant}') shed: "
                    "degradation rung hits_only admits prefix-cache "
                    f"hits only; retry after {self.shed_retry_after}s")
                self.metrics.record_shed(req.tenant)
                return "finished"
            # Cover the prompt plus the first decode window, so that a
            # fresh admission cannot trigger a preemption at once.
            n_new = self.pool.pages_for(
                min(p + 1 + self.spec_k, self.max_len)) - len(shared)
            pages = self.pool.allocate(n_new)
            if pages is None and self._prefix is not None:
                self._prefix.evict(n_new - self.pool.free_count())
                pages = self.pool.allocate(n_new)
            if pages is None:
                if shared:
                    self.pool.release(shared)
                if not self._active:
                    req.finish(
                        "error",
                        f"kv pool exhausted: request {req.id} (tenant "
                        f"'{req.tenant}') needs {n_new} page(s) beyond its "
                        f"prefix hit, pool has {self.pool.free_count()} of "
                        f"{self.kv_pages - 1}",
                    )
                    return "finished"
                self.metrics.record_admission_blocked()
                req.kv_blocked = True
                return "no_memory"
            self.pool.bind_slot(slot, shared + pages)
            req.kv_blocked = False

        if self.adapters is not None:
            try:
                self._bind_adapter(req, slot)
            except (UnknownAdapter, AdapterPoolExhausted) as e:
                # A structured error naming the adapter, never a hang;
                # the pages bound above go back with the slot.
                if self.paged:
                    self.pool.reset_slot(slot)
                    self._push_kv_metrics()
                req.finish("error", str(e))
                return "finished"

        req.slot = slot
        req.state = "active"
        seed = int(req.rng or 0)
        if self.prefill_chunk and (p - c) > self.prefill_chunk:
            return self._admit_chunked(req, slot, prompt, c, seed,
                                       done_tokens)
        req.mark("prefill_start", slot=slot,
                 kind="continuation" if (self.paged and c > 0) else "full",
                 prefix_hit_tokens=c, resumed_tokens=done_tokens)
        t0 = time.perf_counter()
        with torch.no_grad():
            if self.paged and c > 0:
                tok0 = self._admit_paged_continuation(req, slot, prompt, c,
                                                      seed, done_tokens)
            else:
                tok0 = self._admit_full_prefill(req, slot, prompt, seed,
                                                done_tokens)
            if self.spec_k:
                self._caps[slot] = min(
                    p + (req.max_new_tokens - done_tokens) - 1,
                    self.max_len - self.spec_k - 1)
                if self._draft is not None:
                    self._admit_draft(prompt, slot)
            token = int(tok0)  # host read: the prefill has landed
        prefill_dt = time.perf_counter() - t0
        req.prefill_secs += prefill_dt
        req.mark("prefill_done", ms=round(prefill_dt * 1e3, 3))
        self.metrics.record_prefill(prefill_dt)
        return self._activate(req, slot, prompt, seed, done_tokens, token)

    def _activate(self, req: Request, slot: int, prompt: np.ndarray,
                  seed: int, done_tokens: int, token: int) -> str:
        """The admission's tail once the prompt's K/V landed: position,
        sampler state, prefix registration, first token, TTFT and the
        queue wait (by tenant)."""
        p = prompt.shape[0]
        self._pos[slot] = p
        self._temps[slot] = req.temperature
        self._seeds[slot] = seed
        self._steps[slot] = done_tokens + 1
        if self.paged:
            if self._prefix is not None:
                # Register the prompt's full blocks now, so that the next
                # same-prefix request (even in this batch) hits.
                self._prefix.insert(
                    prompt,
                    self.pool.slot_pages[slot][: p // self.kv_page_size],
                    namespace=self._prefix_ns(req),
                )
            self._push_kv_metrics()
        req.push_token(token)
        if done_tokens == 0:
            self.metrics.record_ttft(time.monotonic() - req.submitted_at,
                                     tenant=req.tenant)
            if req.first_admitted_at is not None:
                # The queueing half of TTFT (the other is the prefill).
                self.metrics.record_queue_wait(
                    req.first_admitted_at - req.submitted_at,
                    tenant=req.tenant)
        self._active[slot] = req
        if self._finished(req, token):
            return "finished"
        return "active"

    def _admit_full_prefill(self, req, slot, prompt, seed, done_tokens):
        """Batch-1 prefill into a contiguous cache of the bucket's length,
        then insert its K/V into the slot (paged: into its pages)."""
        p = prompt.shape[0]
        bucket = min(1 << (p - 1).bit_length(), self.max_len)
        padded = torch.zeros((1, bucket), dtype=torch.long, device=self.device)
        padded[0, :p] = torch.from_numpy(prompt.astype(np.int64))
        c1 = self.model.new_cache(1, max_len=bucket)
        last = self._serve_model(
            padded, c1, select=torch.tensor([p - 1], device=self.device),
            adapter_idx=self._row_idx(slot))
        tok0 = sample_rows(last, [req.temperature], [seed], [done_tokens])
        cache = self.cache
        if self.paged:
            ps = self.kv_page_size
            row = torch.from_numpy(self._page_row(slot)).to(self.device).long()
            page_of_pos = row.repeat_interleave(ps)[:bucket]
            offs = torch.arange(bucket, device=self.device) % ps
            for layer in range(len(cache.k)):
                # [1, H, bucket, D] -> rows [bucket, H, D]
                cache.k[layer][page_of_pos, :, offs] = c1.k[layer][0].transpose(0, 1)
                cache.v[layer][page_of_pos, :, offs] = c1.v[layer][0].transpose(0, 1)
        else:
            for layer in range(len(cache.k)):
                cache.k[layer][slot, :, :bucket] = c1.k[layer][0]
                cache.v[layer][slot, :, :bucket] = c1.v[layer][0]
        cache.index[slot] = p
        self.tok[slot, 0] = tok0[0]
        return tok0[0]

    def _admit_paged_continuation(self, req, slot, prompt, c, seed,
                                  done_tokens):
        """Prefix hit: skip the shared ``c`` tokens; run only the suffix
        window through the paged cache at the slot's offset ``c``."""
        p = prompt.shape[0]
        su = p - c
        bucket = min(max(self._MIN_SUFFIX_BUCKET, 1 << (su - 1).bit_length()),
                     self.max_len)
        window = torch.zeros((1, bucket), dtype=torch.long, device=self.device)
        window[0, :su] = torch.from_numpy(prompt[c:].astype(np.int64))
        row = torch.from_numpy(self._page_row(slot)).to(self.device)
        view = self.cache.view(
            row[None, :], torch.tensor([c], dtype=torch.long,
                                       device=self.device))
        last = self._serve_model(
            window, view, select=torch.tensor([su - 1], device=self.device),
            adapter_idx=self._row_idx(slot))
        tok0 = sample_rows(last, [req.temperature], [seed], [done_tokens])
        self.cache.index[slot] = p
        self.tok[slot, 0] = tok0[0]
        return tok0[0]

    def _admit_draft(self, prompt: np.ndarray, slot: int) -> None:
        """Prefill the draft model's slot cache with the same effective
        prompt (batch 1, the bucket's length) and insert its K/V into
        the slot; its logits are not used."""
        p = prompt.shape[0]
        d_model = self._draft.model
        bucket = min(1 << (p - 1).bit_length(), self.max_len)
        padded = torch.zeros((1, bucket), dtype=torch.long, device=self.device)
        padded[0, :p] = torch.from_numpy(prompt.astype(np.int64))
        c1 = d_model.new_cache(1, max_len=bucket)
        d_model(padded, c1, select=torch.tensor([p - 1], device=self.device))
        cache = self._draft_cache
        for layer in range(len(cache.k)):
            cache.k[layer][slot, :, :bucket] = c1.k[layer][0]
            cache.v[layer][slot, :, :bucket] = c1.v[layer][0]
        cache.index[slot] = p

    # -- chunked prefill (prefill_chunk) ---------------------------------

    def _admit_chunked(self, req: Request, slot: int, prompt: np.ndarray,
                       c: int, seed: int, done_tokens: int) -> str:
        """Admit a long prompt through page-aligned windows: run the
        first now and park the slot in ``_chunked``; ``advance_chunks``
        runs one window per serving-loop iteration."""
        req.mark("prefill_start", slot=slot, kind="chunked",
                 prefix_hit_tokens=c, resumed_tokens=done_tokens,
                 window=self.prefill_chunk)
        self.metrics.record_chunked_admission()
        self._chunked[slot] = {
            "req": req, "prompt": prompt, "p": prompt.shape[0],
            "seed": seed, "done_tokens": done_tokens, "next": c,
            "secs": 0.0,
        }
        self._dispatch_chunk(slot)
        return "chunking"

    def _dispatch_chunk(self, slot: int) -> Optional[int]:
        """Run ONE prefill window of a chunking slot at its page-aligned
        offset (prefix hits are whole blocks and ``prefill_chunk`` is a
        page multiple).  A window before the last samples nothing and
        reads nothing back; the last samples the first token at the
        request's own counter and returns it."""
        st = self._chunked[slot]
        req, prompt, p = st["req"], st["prompt"], st["p"]
        start = st["next"]
        w = min(self.prefill_chunk, p - start)
        final = start + w >= p
        t0 = time.perf_counter()
        bucket = min(max(self._MIN_SUFFIX_BUCKET, 1 << (w - 1).bit_length()),
                     self.max_len)
        window = torch.zeros((1, bucket), dtype=torch.long, device=self.device)
        window[0, :w] = torch.from_numpy(prompt[start:start + w].astype(np.int64))
        row = torch.from_numpy(self._page_row(slot)).to(self.device)
        view = self.cache.view(
            row[None, :], torch.tensor([start], dtype=torch.long,
                                       device=self.device))
        token = None
        with torch.no_grad():
            last = self._serve_model(
                window, view, select=torch.tensor([w - 1], device=self.device),
                adapter_idx=self._row_idx(slot))
            # The row rides the decode steps until the next window: its
            # S == 1 write lands at ``start + w``, which that window
            # overwrites.
            self.cache.index[slot] = start + w
            if final:
                tok0 = sample_rows(last, [req.temperature], [st["seed"]],
                                   [st["done_tokens"]])
                self.tok[slot, 0] = tok0[0]
                token = int(tok0[0])  # host read: the last window landed
        st["next"] = start + w
        st["secs"] += time.perf_counter() - t0
        req.prefill_chunks += 1
        self.metrics.record_prefill_chunk()
        if not final:
            req.mark("prefill_chunk", start=start, window=w)
        return token

    def advance_chunks(self) -> List[tuple]:
        """Advance every chunking slot by ONE window (the serving loop
        calls this once per iteration, after admissions and before the
        decode step).  Returns ``(slot, req, status)``: ``"chunking"``
        (windows left), ``"active"`` (the last window landed and the
        request decodes) or ``"finished"`` (expired, or done on its
        first token: the caller frees the slot)."""
        out: List[tuple] = []
        now = time.monotonic()
        for slot in sorted(self._chunked):
            st = self._chunked[slot]
            req = st["req"]
            if req.cancel_requested:
                del self._chunked[slot]
                req.finish("error", "cancelled: hedge superseded")
                self.metrics.record_cancellation()
                self._release_slot_pages(slot, None, donate=False)
                out.append((slot, req, "finished"))
                continue
            if req.expired(now):
                del self._chunked[slot]
                req.finish("expired",
                           f"deadline ({req.deadline}s) passed during its "
                           "chunked prefill")
                self.metrics.record_expiry()
                self._release_slot_pages(slot, None, donate=False)
                out.append((slot, req, "finished"))
                continue
            token = self._dispatch_chunk(slot)
            if token is None:
                out.append((slot, req, "chunking"))
                continue
            out.append((slot, req, self._finalize_chunked(slot, token)))
        return out

    def _finalize_chunked(self, slot: int, token: int) -> str:
        """The last window landed: the slot activates exactly as an
        unchunked admission would."""
        st = self._chunked.pop(slot)
        req = st["req"]
        req.prefill_secs += st["secs"]
        req.mark("prefill_done", ms=round(st["secs"] * 1e3, 3),
                 chunks=req.prefill_chunks)
        self.metrics.record_prefill(st["secs"])
        return self._activate(req, slot, st["prompt"], st["seed"],
                              st["done_tokens"], token)

    def abort_chunked(self, msg: str) -> List[int]:
        """Fail every chunking request with a structured error (their
        page chains are partly written, so the pages go back without
        prefix donation).  Returns the freed slots."""
        freed: List[int] = []
        for slot in list(self._chunked):
            st = self._chunked.pop(slot)
            st["req"].finish("error", msg)
            self._release_slot_pages(slot, None, donate=False)
            freed.append(slot)
        return freed

    def _finished(self, req: Request, token: int) -> bool:
        """Finish and unbind ``req`` if it just completed."""
        done = (
            req.eos_token_id is not None and token == req.eos_token_id
        ) or len(req.tokens) >= req.max_new_tokens
        if done:
            req.finish("done")
            self.metrics.record_completion()
            self._release_slot_pages(req.slot, req, donate=True)
            del self._active[req.slot]
        return done

    def _decode(self) -> torch.Tensor:
        """The decode step's forward: every slot's next-token logits
        [max_batch, V] float32.  It writes its K/V into the cache and
        advances the positions in place, and reads nothing else that
        moves, so that a CUDA graph of it stays valid across steps (with
        adapters: the stacks and ``adapter_idx``, written in place)."""
        return self._serve_model(self.tok, self.cache, select=self._select,
                                 quant=self.quant,
                                 adapter_idx=self._adapter_idx)

    def _decode_logits(self) -> torch.Tensor:
        """``_decode()``: eager on the CPU (or with ``_decode_graph``
        off); on the card the first call is the warm-up on the capture's
        stream, the second captures, and every call from there is one
        replay, whose logits stay valid until the next."""
        if not self._graphed:
            return self._decode()
        if self._graph is None:
            self._graph = StepGraph(self.device)
            return self._graph.warm_up(self._decode)
        if self._graph.capture_s is None:
            self._graph.capture(self._decode)
            self.graph_captures += 1
        return self._graph.replay()

    def kernel_sources(self) -> List[str]:
        """The kernel libraries (``csrc/<name>.cu``) this engine's path
        launches on the card: K1 for the prefills, K6 with
        ``paged_kernel``, K7 with ``quant_int8``; none on the CPU."""
        if self.device.type != "cuda":
            return []
        return (["flash_fwd"] + ["paged_attention"] * self.paged_kernel
                + ["int8_matmul"] * (self.quant is not None))

    def close(self) -> None:
        """Drop the decode graph, and with it its memory pool (a later
        step would warm up and capture again), and hand its side stream
        on to the next engine (``step_graph.take_stream``)."""
        if self._graph is not None and self.device.type == "cuda":
            synchronize(self.device)  # no replay in flight
            give_back_stream(self.device, self._graph.stream)
        self._graph = None

    def _sweep_cancelled(self) -> List[int]:
        """Free the slots whose request was cancelled (``Server.cancel``
        cleared its SLO observer): pages donated (the prefill stays
        useful in the prefix cache), slot freed before the step."""
        freed: List[int] = []
        for slot in [s for s, r in self._active.items()
                     if r.cancel_requested]:
            req = self._active.pop(slot)
            req.finish("error", "cancelled: hedge superseded")
            self.metrics.record_cancellation()
            self._release_slot_pages(slot, req, donate=True)
            freed.append(slot)
        return freed

    def _wedge_hook(self) -> None:
        """The ``decode_wedge`` fault: a matching ``_step_seq`` holds the
        loop here, before the step's forward (the graph's replay) is
        issued, until the plan's release or the fault's ``secs``."""
        plan = active_plan()
        if plan is None:
            return
        fault = plan.fire("decode_wedge", step=self._step_seq)
        if fault is not None:
            self._holding = plan
            try:
                plan.hold_wedge(fault)
            finally:
                self._holding = None

    def step(self) -> List[int]:
        """One decode step over all slots; returns the slots freed
        (finished, expired, cancelled or preempted)."""
        if not self._active:
            return []
        freed = self._sweep_cancelled()
        if not self._active:
            return freed
        self._step_seq += 1
        self._wedge_hook()
        spec_now = bool(self.spec_k and self.spec_enabled)
        if self.paged:
            freed += self._ensure_pages(self.spec_k + 1 if spec_now else 1)
            self._sync_table()
            if not self._active:
                return freed
        if spec_now:
            return freed + self._step_spec()
        if self._rows_dirty:
            self._adapter_idx.copy_(torch.from_numpy(self._adapter_rows))
            self._rows_dirty = False
        t0 = time.perf_counter()
        with torch.no_grad():
            last = self._decode_logits()
            # Free slots decode masked garbage nobody reads: greedy there.
            live = np.zeros(self.max_batch, bool)
            live[list(self._active)] = True
            temps = np.where(live, self._temps, 0.0)
            nxt = sample_rows(last, temps, self._seeds, self._steps)
            self.tok.copy_(nxt[:, None])
            toks = nxt.cpu().numpy()  # the step's one host read
        dt = time.perf_counter() - t0
        self._pos = np.minimum(self._pos + 1, self.max_len)
        active = len(self._active)
        commits = {slot: [int(toks[slot])] for slot in self._live(freed)}
        return freed + self._hand_out(commits, dt, active)

    def _step_spec(self) -> List[int]:
        """One speculative verify step over all slots: draft ``spec_k``
        tokens per slot, score the ``[max_batch, spec_k + 1]`` window in
        ONE target forward (eagerly), and commit each slot's accepted
        prefix plus one token.  Free slots draft zeros and decode masked
        rows nobody reads."""
        k = self.spec_k
        active = len(self._active)
        t0 = time.perf_counter()
        with torch.no_grad():
            if self._draft is not None:
                drafts = draft_scan(self._draft.model, self._draft_cache,
                                    self.tok, self._pos, k)
            else:
                drafts = np.zeros((self.max_batch, k), np.int32)
                for slot, req in self._active.items():
                    drafts[slot] = self._ngram.draft_one(np.concatenate([
                        np.asarray(req.prompt, np.int32).reshape(-1),
                        np.asarray(req.tokens, np.int32)]))
            window = torch.cat(
                [self.tok, torch.from_numpy(drafts.astype(np.int64)).to(
                    self.device)], dim=1)
            self.cache.index.copy_(torch.from_numpy(self._pos))
            live = np.zeros(self.max_batch, bool)
            live[list(self._active)] = True
            acc, toks = verify(self._serve_model(window, self.cache), window,
                               np.where(live, self._temps, 0.0), self._seeds,
                               self._steps)
            # The rollback: every row's index is its new consumed count.
            self._pos = np.minimum(self._pos + acc + 1, self._caps)
            self.cache.index.copy_(torch.from_numpy(self._pos))
            self.tok.copy_(torch.from_numpy(toks[:, None]))
        dt = time.perf_counter() - t0
        freed: List[int] = []
        commits = {}
        for slot in self._live(freed):
            req, n_acc = self._active[slot], int(acc[slot])
            req.spec_steps += 1
            req.spec_accepted_tokens += n_acc
            commits[slot] = [int(t) for t in drafts[slot][:n_acc]] + [
                int(toks[slot])]
        self.metrics.record_spec([int(acc[slot]) for slot in commits], k)
        return freed + self._hand_out(commits, dt, active)

    def _live(self, freed: List[int]) -> List[int]:
        """The active slots after the step, in order; the requests whose
        deadline passed are finished and their slots added to ``freed``."""
        now = time.monotonic()
        live = []
        for slot in sorted(self._active):
            req = self._active[slot]
            if not req.expired(now):
                live.append(slot)
                continue
            req.finish("expired",
                       f"deadline ({req.deadline}s) passed mid-decode after "
                       f"{len(req.tokens)} token(s)")
            self.metrics.record_expiry()
            self._release_slot_pages(slot, req, donate=True)
            del self._active[slot]
            freed.append(slot)
        return live

    def _hand_out(self, commits: Dict[int, List[int]], dt: float,
                  active: int) -> List[int]:
        """Record the step (``active`` slots of ``max_batch`` rode it),
        then push each slot's committed tokens, up to its request's end
        (budget or EOS).  Recording first means that a client woken by
        its last token reads metrics that count this step.  Returns the
        slots that finished."""
        for slot, tokens in commits.items():
            req = self._active[slot]
            tokens[:] = tokens[:req.max_new_tokens - len(req.tokens)]
            if req.eos_token_id in tokens:
                del tokens[tokens.index(req.eos_token_id) + 1:]
        self.metrics.record_step(dt, active, self.max_batch,
                                 sum(len(t) for t in commits.values()))
        freed = []
        for slot, tokens in commits.items():
            req = self._active[slot]
            for token in tokens:
                self._steps[slot] += 1
                req.push_token(token)
                if self._finished(req, token):
                    freed.append(slot)
        return freed

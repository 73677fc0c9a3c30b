"""Paged-KV continuous batching: block-table K/V for the INT8 LM.

Counterpart of ``resnet_accel_tpu/runtime/paged.py``.  The fixed-slot engine
(``runtime.serving.ContinuousBatcher``) gives every slot a contiguous
``[max_len, d_model]`` cache; this one pages the KV, vLLM-style:

- One K and one V **page pool** an engine, ``[n_layers, pool_pages, page,
  d_model]``; page 0 is a dummy that takes idle slots' writes and is never
  allocated.  Each slot has a **block table** row of page ids, and its K/V
  view is ``pool[table[slot]]`` reshaped to ``[table_pages * page,
  d_model]``: positions past the slot's length are masked, as on the
  contiguous path.  The scatter and gather are PyTorch indexing, as the JAX
  engine's are XLA's (no kernel of the port runs here).
- The host keeps a **free-page list**: a request is admitted only when its
  pages are free (``reserve="full"``), or grows page by page and preempts
  newer requests by recompute when the pool runs dry
  (``reserve="ondemand"``).  The pool may hold far fewer pages than
  ``slots x table_pages``.
- **int8 KV pages** (``kv_dtype="int8"``): per-position symmetric int8
  values and one float32 scale per (layer, page, position), dequantized
  after the gather.  Lossy by design: the one knob whose streams are not
  bit-equal to ``generate``'s.
- **Prefix cache** (``prefix_cache=True``): retired requests' pure-prompt
  pages stay cached under their exact token chain, shared read-only
  (refcounted) by later prompts that start with it, which skip those
  prefill micro-steps; unreferenced cached pages are reclaimed LRU-first.
- **Speculation** (``spec_draft > 0``): each step verifies ``spec_draft +
  1`` tokens a slot in one pass (known prompt tokens, then prompt-lookup
  drafts), accepted on the device; ``spec_adaptive`` switches to chunked
  steps while the acceptance does not pay.
- **Tensor parallelism** (``tp_mesh``, a mesh with a ``"tp"`` axis; one
  engine a rank of a world that ``parallel.launch.run_world`` spawned):
  the pools sliced by head, the device program ``runtime/paged_tp.py``'s,
  the host scheduler replicated in every rank.

The decode arithmetic is the contiguous path's (``qkv_project``,
``attend_mlp_multi``, ``models.sampling``), so streams equal
``generate``'s, ``sample``'s and the fixed-slot engine's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from resnet_accel_tpu_torch.models.sampling import (adjust_logits,
                                                    greedy_accept, prng_key,
                                                    spec_accept_sampled)
from resnet_accel_tpu_torch.runtime.serving import (_IterationScheduler,
                                                    _Request)


class PagedKVBatcher(_IterationScheduler):
    """Continuous batcher over a paged KV pool.

    Args:
        model: ``models.lm.TransformerLMInt8`` (its position table bounds
            the longest sequence).
        scales: static activation scales (``model.calibrate`` output).
        slots: lockstep decode lanes.
        page: positions a KV page.
        pool_pages: pages in the pool, the dummy page 0 included.
        max_pages: block-table width, the longest admissible request in
            pages; not a memory commitment (that is ``pool_pages``).
        chunk: micro-steps an engine step.
        temperature, top_k: engine-level sampling (0: greedy).
        reserve: ``"full"`` or ``"ondemand"``.
        prefix_cache: share cached prompt pages.
        kv_dtype: ``"fp32"`` or ``"int8"``.
        spec_draft, spec_ngram: speculative window and lookup length.
        spec_adaptive, spec_min_take, spec_reprobe, spec_probe: fall back
            to chunked steps while the tokens consumed a verify (an EWMA)
            stay under ``spec_min_take`` (default ``chunk``), probing again
            every ``spec_reprobe`` steps; greedy only.
        tp_mesh: a ``DeviceMesh`` with a ``"tp"`` axis: this rank's share
            of an engine sharded over it (``runtime/paged_tp.py``).
        device: ``"cuda"`` (default) or ``"cpu"``.
    """

    def __init__(self, model, scales, slots: int = 4, page: int = 16,
                 pool_pages: int = 64, max_pages: Optional[int] = None,
                 chunk: int = 8, temperature: float = 0.0,
                 top_k: Optional[int] = None, reserve: str = "full",
                 prefix_cache: bool = False, kv_dtype: str = "fp32",
                 spec_draft: int = 0, spec_ngram: int = 3,
                 spec_adaptive: bool = False,
                 spec_min_take: Optional[float] = None,
                 spec_reprobe: int = 50, spec_probe: int = 3,
                 tp_mesh=None, device="cuda"):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if page < 1:
            raise ValueError("page must be >= 1")
        if reserve not in ("full", "ondemand"):
            raise ValueError(
                f"reserve must be 'full' or 'ondemand', got {reserve!r}")
        if spec_draft < 0:
            raise ValueError("spec_draft must be >= 0")
        if spec_draft and spec_ngram < 1:
            raise ValueError("spec_ngram must be >= 1")
        self.model = model
        self.slots = int(slots)
        self.page = int(page)
        self.reserve = reserve
        self.pool_pages = int(pool_pages)
        if max_pages is None:
            max_pages = model.max_len // self.page
        self.max_pages = int(max_pages)
        self.max_len = min(self.max_pages * self.page, model.max_len)
        self.chunk = int(chunk)
        # A verify window writes K/V up to S - 1 positions past a request's
        # final length, so admission reserves those pages too and the block
        # table is widened by them: the overhang lands in pages the request
        # owns, never in its last valid page.
        self.spec_draft = int(spec_draft)
        self.spec_ngram = int(spec_ngram)
        spec = self.spec_draft > 0
        S = self.spec_draft + 1
        # Adaptive speculation: chunked steps consume ``chunk`` tokens a
        # step, so a verify must consume more to pay; greedy only, since
        # both programs emit the argmax chain and a switch cannot change a
        # stream, while sampled streams spend randomness differently.
        self.spec_adaptive = bool(spec_adaptive)
        if self.spec_adaptive:
            if not spec:
                raise ValueError("spec_adaptive requires spec_draft > 0")
            if temperature > 0:
                raise ValueError(
                    "spec_adaptive is greedy-only (sampled streams "
                    "consume randomness differently per mode, so "
                    "switching would change them)")
            if spec_probe < 1 or spec_reprobe < 1:
                raise ValueError("spec_probe and spec_reprobe must "
                                 "be >= 1")
        self.spec_min_take = (float(spec_min_take)
                              if spec_min_take is not None
                              else float(chunk))
        self.spec_reprobe = int(spec_reprobe)
        self.spec_probe = int(spec_probe)
        self._spec_mode = True        # adaptive: currently speculating?
        self._spec_ewma: Optional[float] = None
        self._spec_samples = 0
        self._chunk_left = 0
        self._last_take: Optional[float] = None
        self.spec_switches = 0        # mode flips
        self._overhang = S - 1 if spec else 0
        self._win = S if spec else self.chunk
        self._table_pages = self.max_pages + (
            -(-self._overhang // self.page) if spec else 0)
        self.temperature = float(temperature)
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        self.top_k = top_k
        if pool_pages < 2:
            raise ValueError("pool needs at least 2 pages (page 0 is "
                             "the reserved dummy)")
        if kv_dtype not in ("fp32", "int8"):
            raise ValueError(
                f"kv_dtype must be 'fp32' or 'int8', got {kv_dtype!r}")
        self.kv_dtype = kv_dtype

        self._tp = None
        if tp_mesh is None:
            self.module = model.module(device)
            self.device = self.module.device
            self.scales = self.module.prepare_scales(scales)
            width = model.d_model
        else:
            from resnet_accel_tpu_torch.runtime.paged_tp import \
                build_tp_paged_programs
            self._tp = build_tp_paged_programs(model, scales, tp_mesh,
                                               device)
            self.device = self._tp.device
            width = self._tp.d_loc            # this rank's heads' slice
        shape = (len(model.blocks), self.pool_pages, self.page, width)

        def pool():
            if kv_dtype == "int8":
                return {"q": torch.zeros(shape, dtype=torch.int8,
                                         device=self.device),
                        "s": torch.zeros(shape[:-1], device=self.device)}
            return torch.zeros(shape, device=self.device)
        self._pool_k, self._pool_v = pool(), pool()
        self._tables = torch.zeros((self.slots, self._table_pages),
                                   dtype=torch.int64, device=self.device)
        self._lens = torch.zeros(self.slots, dtype=torch.int64,
                                 device=self.device)
        self._free: List[int] = list(range(1, self.pool_pages))
        self._slot_pages: Dict[int, List[int]] = {}
        self._slot_len: Dict[int, int] = {}   # host mirror of device lens
        self.preemptions = 0                  # recompute evictions

        # Prefix cache: K/V at position i depends only on tokens[0..i] and
        # the position, so equal token prefixes have equal K/V.  A slot
        # writes only at its own positions, which start past the shared
        # range, so sharing is write-safe.
        self.prefix_cache = bool(prefix_cache)
        self._cache: Dict[bytes, int] = {}      # chain key -> page id
        self._page_ref: Dict[int, int] = {}     # page id -> live refs
        self._lru: Dict[bytes, None] = {}       # insertion-ordered LRU
        self._slot_req: Dict[int, _Request] = {}
        self._slot_shared: Dict[int, int] = {}  # leading shared pages
        self._slot_cache_bound: Dict[int, int] = {}  # preempt-time fed
        self.cache_hits = 0                     # shared pages reused
        self.cache_tokens_skipped = 0           # prefill steps skipped

        self._queue: List[_Request] = []
        self._active: Dict[int, _Request] = {}
        self._results: Dict[int, List[int]] = {}
        self._prev = np.zeros(self.slots, np.int64)
        self._keys = torch.zeros((self.slots, 2), dtype=torch.int64,
                                 device=self.device)
        self._next_rid = 0
        self.steps = 0
        self.micro_steps = 0

    # ------------------------------------------------- device programs
    def _store(self, pool, li: int, pids, offs, val) -> None:
        """Scatter K or V rows into the pool: val [B, D] at [B] page ids
        and offsets, or [B, S, D] at [B, S] (a verify window a slot).  int8
        pools store each row's symmetric int8 values and float32 scale."""
        if self.kv_dtype == "fp32":
            pool[li][pids, offs] = val
            return
        amax = (val.abs().amax(dim=-1) if self._tp is None
                else self._tp.row_absmax(val))
        s = amax.clamp_min(1e-8) / 127.0
        pool["q"][li][pids, offs] = torch.round(
            val / s[..., None]).clamp(-128, 127).to(torch.int8)
        pool["s"][li][pids, offs] = s

    def _view(self, pool, li: int) -> torch.Tensor:
        """Each slot's page view [B, table_pages * page, D] (int8 pools
        dequantize after the gather)."""
        B = self.slots
        if self.kv_dtype == "fp32":
            return pool[li][self._tables].reshape(B, -1, pool.shape[-1])
        q = pool["q"][li][self._tables].reshape(B, -1, pool["q"].shape[-1])
        s = pool["s"][li][self._tables].reshape(B, -1)
        return q.to(torch.float32) * s[..., None]

    def _forward(self, toks, pos_idx, lens):
        """Tokens [B, S] at positions ``pos_idx`` [B, S] through every
        block over the paged views (row i of a slot attends its positions up
        to ``lens + i``): logits [B, S, V].  Positions past the position
        table clamp to its last row, page rows past the table to its last
        column: such rows belong to finished requests or the final
        overhang, and their outputs are discarded.  A tp engine runs its
        rank's heads (``runtime/paged_tp.py``)."""
        if self._tp is not None:
            return self._tp.forward(self, toks, pos_idx, lens)
        m = self.module
        x = m.embed[toks] + m.pos[pos_idx.clamp(max=m.max_len - 1)]
        prow = (pos_idx // self.page).clamp(max=self._table_pages - 1)
        pids = self._tables.gather(1, prow)
        offs = pos_idx % self.page
        for li, (blk, s) in enumerate(zip(m.blocks, self.scales)):
            q, k, v = blk.qkv_project(x, s, rows=True)
            self._store(self._pool_k, li, pids, offs, k)
            self._store(self._pool_v, li, pids, offs, v)
            x = blk.attend_mlp_multi(x, q, self._view(self._pool_k, li),
                                     self._view(self._pool_v, li), lens, s)
        return m._logits(x, rows=True)

    def _micro_step(self, toks, lens):
        """One lockstep token for every slot: toks [B] -> (logits [B, V],
        lens + 1)."""
        return self._forward(toks[:, None], lens[:, None], lens)[:, 0], \
            lens + 1

    def _spec_step(self, fed, n_known, emits, idle):
        """One speculative step for every slot: verify S tokens a slot
        (known tokens, then drafts) in one pass over the paged K/V, accept
        on the device, advance each slot by its accepted count.  Rejected
        rows stay in the pool, masked by position and overwritten by the
        next window.  Returns (emit [B, S], tokens consumed [B]) on the
        host, in one copy."""
        S = fed.shape[1]
        lens = self._lens
        logits = self._forward(
            fed, lens[:, None] + torch.arange(S, device=self.device), lens)
        if self.temperature <= 0.0:
            n_acc, emit = greedy_accept(logits, fed, n_known)
        else:
            n_acc, emit, k2 = spec_accept_sampled(
                adjust_logits(logits, self.temperature, self.top_k), fed,
                self._keys, n_known)
            # a slot's key advances only where its window can emit, so a
            # stream does not depend on how many prefill windows came first
            self._keys = torch.where(emits[:, None], k2, self._keys)
        n_cons = n_acc + 1
        self._lens = torch.where(idle, 0, lens + n_cons)
        host = torch.cat([emit, n_cons[:, None]], dim=1).cpu().numpy()
        return host[:, :-1], host[:, -1]

    # ------------------------------------------------------------- api
    def submit(self, prompt: Sequence[int], n_new: int,
               seed: int = 0, eos: Optional[int] = None) -> int:
        """Enqueue a request; admitted when enough KV pages are free."""
        prompt = self._validated_prompt(prompt, n_new,
                                        "the block-table capacity")
        need = -(-(len(prompt) + n_new + self._overhang) // self.page)
        if need > self.pool_pages - 1:
            raise ValueError(
                f"request needs {need} KV pages (incl. the speculative "
                f"verify overhang) but the pool only has "
                f"{self.pool_pages - 1} allocatable — it could never "
                "be admitted")
        return self._enqueue(prompt, n_new, seed, eos)

    @torch.inference_mode()
    def score(self, seqs: Sequence[Sequence[int]]) -> List[np.ndarray]:
        """Teacher-forced per-token log-probs through the paged path: for
        each sequence, tokens[:-1] fed through the engine's own micro-steps
        (paged scatter and gather, ``kv_dtype``, chunks), returning the
        float32 log-prob of tokens[1:] (empty for fewer than 2 tokens).
        Needs an idle engine; pages come from the pool and go back."""
        if self._active or self._queue:
            raise RuntimeError("score() requires an idle engine")
        results: List[Optional[np.ndarray]] = [None] * len(seqs)
        pending = [(i, list(map(int, s))) for i, s in enumerate(seqs)]
        for i, s in pending:
            if len(s) > self.max_len:
                raise ValueError(
                    f"sequence {i} has {len(s)} tokens; the engine "
                    f"tables cap at {self.max_len}")
        for i, s in pending:
            if len(s) < 2:
                results[i] = np.zeros(0, np.float32)
        pending = [(i, s) for i, s in pending if len(s) >= 2]
        while pending:
            batch, pending = pending[:self.slots], pending[self.slots:]
            tables = np.zeros((self.slots, self._table_pages), np.int64)
            allocs: List[List[int]] = []
            for s_i, (_, seq) in enumerate(batch):
                need = -(-(len(seq) - 1) // self.page)
                if need > len(self._free) + len(self._cache):
                    raise RuntimeError(
                        f"scoring needs {need} free KV pages, have "
                        f"{len(self._free)}")
                pages = self._alloc_pages(need)
                allocs.append(pages)
                tables[s_i, :need] = pages
            longest = max(len(seq) - 1 for _, seq in batch)
            B, C = self.slots, self.chunk
            self._tables[:] = torch.as_tensor(tables, device=self.device)
            lens = torch.zeros(B, dtype=torch.int64, device=self.device)
            acc = [[] for _ in batch]
            for off in range(0, longest, C):
                toks = np.zeros((C, B), np.int64)
                tgts = np.zeros((C, B), np.int64)
                valid = np.zeros((C, B), bool)
                for s_i, (_, seq) in enumerate(batch):
                    n = max(min(len(seq) - 1 - off, C), 0)
                    if n:
                        toks[:n, s_i] = seq[off:off + n]
                        tgts[:n, s_i] = seq[off + 1:off + 1 + n]
                        valid[:n, s_i] = True
                toks, tgts, valid = self._upload(toks, tgts, valid)
                lps = []
                for i in range(C):
                    logits, lens = self._micro_step(toks[i], lens)
                    lp = torch.log_softmax(logits, dim=-1).gather(
                        1, tgts[i][:, None])[:, 0]
                    lps.append(torch.where(valid[i], lp, 0.0))
                lps = torch.stack(lps).cpu().numpy()      # [C, B]
                for s_i in range(len(batch)):
                    acc[s_i].append(lps[:, s_i])
                self.steps += 1
                self.micro_steps += C
            for s_i, (idx, seq) in enumerate(batch):
                results[idx] = np.concatenate(acc[s_i])[:len(seq) - 1] \
                    .astype(np.float32)
                self._free.extend(allocs[s_i])
            self._tables.zero_()
        return results

    def free_pages(self) -> int:
        return len(self._free)

    def kv_pool_bytes(self) -> int:
        """Device bytes committed to the K and V page pools, over every
        rank of a tp engine (its head slices, and the int8 pools' scales
        once: each rank holds the same)."""
        tp = 1 if self._tp is None else self._tp.tp
        total = 0
        for pool in (self._pool_k, self._pool_v):
            if isinstance(pool, dict):
                total += (pool["q"].numel() * tp
                          + pool["s"].numel() * pool["s"].element_size())
            else:
                total += pool.numel() * pool.element_size() * tp
        return total

    # ------------------------------------------------ prefix cache ops
    def _chain_key(self, prompt: Sequence[int], k: int) -> bytes:
        """Cache key of page k: the exact token sequence it closes."""
        return np.asarray(prompt[:(k + 1) * self.page],
                          np.int32).tobytes()

    def _reclaimable(self) -> int:
        return sum(1 for key in self._lru
                   if self._page_ref.get(self._cache[key], 0) == 0)

    def _available(self) -> int:
        """Pages allocatable now: free and reclaimable cached."""
        return len(self._free) + self._reclaimable()

    def _evict_cached(self) -> None:
        """Reclaim the least recently used unreferenced cached page."""
        for key in self._lru:
            pid = self._cache[key]
            if self._page_ref.get(pid, 0) == 0:
                del self._cache[key]
                del self._lru[key]
                self._page_ref.pop(pid, None)
                self._free.append(pid)
                return
        raise RuntimeError(
            "no free or reclaimable KV pages (callers must check "
            "_available() before allocating)")

    def _alloc_pages(self, n: int) -> List[int]:
        out = []
        for _ in range(n):
            if not self._free:
                self._evict_cached()
            out.append(self._free.pop())
        return out

    def _set_table(self, slot: int, pages: List[int]) -> None:
        row = np.zeros(self._table_pages, np.int64)
        row[:len(pages)] = pages
        self._tables[slot] = torch.as_tensor(row, device=self.device)

    def _cached_prefix(self, req: _Request) -> List[int]:
        """Longest run of cached pages matching the prompt head.  At least
        one prompt token is always left to feed (its logits start
        generation)."""
        if not self.prefix_cache:
            return []
        hits: List[int] = []
        for k in range((len(req.prompt) - 1) // self.page):
            pid = self._cache.get(self._chain_key(req.prompt, k))
            if pid is None:
                break
            hits.append(pid)
        return hits

    def _admit(self) -> None:
        for slot in range(self.slots):
            if slot in self._active or not self._queue:
                continue
            req = self._queue[0]
            shared = self._cached_prefix(req)
            fed0 = len(shared) * self.page
            total = len(req.prompt) + req.n_new + self._overhang
            if self.reserve == "full":
                need = -(-total // self.page) - len(shared)
            else:
                need = (-(-min(total, fed0 + self._win) // self.page)
                        - len(shared))
            need = max(need, 0)
            if need > self._available():
                break                     # FIFO: wait for pages
            self._queue.pop(0)
            for k, pid in enumerate(shared):
                self._page_ref[pid] = self._page_ref.get(pid, 0) + 1
                key = self._chain_key(req.prompt, k)
                self._lru.pop(key, None)
                self._lru[key] = None     # LRU touch
            pages = shared + self._alloc_pages(need)
            self.cache_hits += len(shared)
            self.cache_tokens_skipped += fed0
            req.fed = fed0                # shared KV: skip its prefill
            self._slot_pages[slot] = pages
            self._slot_shared[slot] = len(shared)
            self._slot_req[slot] = req
            self._slot_len[slot] = fed0
            self._set_table(slot, pages)
            self._lens[slot] = fed0
            self._active[slot] = req
            self._prev[slot] = 0
            # a preempted request resumes its key mid-stream, so that the
            # recomputed continuation draws the tokens the uninterrupted
            # run would have
            self._keys[slot] = (req.saved_key if req.saved_key is not None
                                else prng_key(req.seed, self.device))
            req.saved_key = None

    def _preempt(self, slot: int) -> None:
        """Evict a running request by recompute: fold its generated tokens
        into the prompt, save its key, release its pages and requeue it at
        its FIFO place (by rid).  Re-admitted, it refeeds prompt and
        generated tokens and continues token for token."""
        req = self._active.pop(slot)
        self.preemptions += 1
        # positions < fed hold valid prompt K/V now: remember the bound
        # before the fold rewrites fed, so _on_slot_free can cache those
        # pages and the resumed request reuses them
        self._slot_cache_bound[slot] = req.fed
        req.saved_key = self._keys[slot].clone()
        req.emitted.extend(req.out)
        req.prompt = req.prompt + req.out
        total = req.total_new if req.total_new is not None else req.n_new
        req.n_new = total - len(req.emitted)
        req.out = []
        req.fed = 0
        self._on_slot_free(slot)
        self._slot_len.pop(slot, None)
        self._lens[slot] = 0
        pos = 0
        while pos < len(self._queue) and self._queue[pos].rid < req.rid:
            pos += 1
        self._queue.insert(pos, req)

    def _ensure_pages(self) -> None:
        """Ondemand mode: grow each active slot's pages to cover the next
        step, preempting newer requests (largest rid first) when the pool
        runs dry.  The oldest request can always progress (``submit``
        bounds a request's need by the pool); a slot that cannot be served
        even after evicting every newer one parks itself on the queue."""
        for slot in sorted(self._active,
                           key=lambda s: self._active[s].rid):
            if slot not in self._active:
                continue          # preempted by an earlier iteration
            req = self._active[slot]
            total = len(req.prompt) + req.n_new + self._overhang
            target = min(total, self._slot_len[slot] + self._win)
            grow = -(-target // self.page) - len(self._slot_pages[slot])
            while grow > self._available():
                victims = [s for s in self._active
                           if self._active[s].rid > req.rid]
                if not victims:
                    self._preempt(slot)   # park self; retry later
                    break
                self._preempt(max(
                    victims, key=lambda s: self._active[s].rid))
            if slot not in self._active or grow <= 0:
                continue
            self._slot_pages[slot].extend(self._alloc_pages(grow))
            self._set_table(slot, self._slot_pages[slot])

    def _on_slot_free(self, slot: int) -> None:
        """Release a leaving request's pages.  Shared pages drop a
        reference and stay cached.  With the prefix cache on, its own
        pure-prompt pages, inside both the prompt and the positions written
        (``fed``, or the bound a preemption recorded), join the cache;
        everything else returns to the free list."""
        pages = self._slot_pages.pop(slot, [])
        req = self._slot_req.pop(slot, None)
        bound = self._slot_cache_bound.pop(slot, None)
        shared = self._slot_shared.pop(slot, 0)
        for pid in pages[:shared]:
            self._page_ref[pid] = max(self._page_ref.get(pid, 1) - 1, 0)
        own = pages[shared:]
        keep = 0
        if self.prefix_cache and req is not None:
            if bound is None:
                bound = req.fed
            cacheable = min(bound, len(req.prompt)) // self.page
            for k in range(shared, min(cacheable, shared + len(own))):
                pid = own[k - shared]
                key = self._chain_key(req.prompt, k)
                if key in self._cache:
                    self._free.append(pid)   # duplicate: keep the old
                else:
                    self._cache[key] = pid
                    self._page_ref[pid] = 0
                    self._lru[key] = None
                keep += 1
        self._free.extend(own[keep:])
        self._slot_len.pop(slot, None)
        self._tables[slot] = 0

    # ------------------------------------------------ speculative mode
    def _draft(self, ctx: List[int], need: int) -> List[int]:
        """Prompt-lookup drafts on the host: the continuation of the most
        recent strictly earlier occurrence of the last ``spec_ngram`` tokens
        of ``ctx``, padded by repeating the last token."""
        if need <= 0:
            return []
        n, g = len(ctx), self.spec_ngram
        if n > g:
            a = np.asarray(ctx, np.int64)
            # windows starting at 0..n-g-1 (strictly before the suffix)
            wins = np.stack([a[j:j + n - g] for j in range(g)], axis=1)
            hits = np.flatnonzero(np.all(wins == a[None, -g:], axis=1))
            if hits.size:
                p = int(hits[-1])
                cont = ctx[p + g:p + g + need]
                return cont + [ctx[-1]] * (need - len(cont))
        return [ctx[-1]] * need

    def _step_spec(self) -> bool:
        """One speculative step: each active slot's S-token window (its
        unfed known tokens, then drafts continuing the chain) in one
        verify pass; each slot consumes its accepted count.
        ``_slot_len`` mirrors the device ``lens`` (tokens with valid K/V);
        emitted tokens are the rows predicting positions at or past the
        prompt's end, cut at the budget or EOS."""
        self._admit()
        if self.reserve == "ondemand":
            self._ensure_pages()
        if not self._active:
            return bool(self._queue)

        S = self.spec_draft + 1
        fed = np.zeros((self.slots, S), np.int64)
        n_known = np.zeros(self.slots, np.int64)
        emits = np.zeros(self.slots, bool)
        consumed0: Dict[int, int] = {}
        for slot, req in self._active.items():
            ctx = req.prompt + req.out
            consumed = self._slot_len[slot]
            consumed0[slot] = consumed
            known = ctx[consumed:consumed + S]
            fed[slot] = known + self._draft(ctx, S - len(known))
            n_known[slot] = len(known)
            # some row predicts a position at or past the prompt's end:
            # this window can emit, and spends randomness
            emits[slot] = consumed + S >= len(req.prompt)
        idle = np.array([s not in self._active
                         for s in range(self.slots)])
        emit, n_cons = self._spec_step(
            *self._upload(fed, n_known, emits, idle))
        self.steps += 1
        self.micro_steps += S
        self._last_take = (float(np.mean([n_cons[s] for s in consumed0]))
                           if consumed0 else None)

        for slot in list(self._active):
            req = self._active[slot]
            consumed = consumed0[slot]
            take = int(n_cons[slot])
            # fed first: req.done checks prefilling against this window's
            # prompt consumption before any append
            req.fed = min(len(req.prompt), consumed + take)
            for p in range(take):
                # chain position consumed + 1 + p: a prompt token, or a new
                # one (appended until the request is done)
                if consumed + 1 + p >= len(req.prompt) and not req.done:
                    req.out.append(int(emit[slot, p]))
            self._slot_len[slot] = consumed + take
            if req.done:
                self._retire(slot)
        return bool(self._active or self._queue)

    @torch.inference_mode()
    def step_engine(self) -> bool:
        """One engine step.  Returns False when idle.  With ``spec_draft >
        0`` a speculative verify window in place of ``chunk`` micro-steps;
        ``spec_adaptive`` switches between the two on the acceptance
        EWMA."""
        if self.spec_draft and not self.spec_adaptive:
            return self._step_spec()
        if self.spec_draft:
            return self._step_adaptive()
        return self._step_chunked()

    def _step_adaptive(self) -> bool:
        """Speculate while the acceptance EWMA says it pays, else run
        chunked steps and probe again later.  Greedy streams are the same
        either way."""
        if not self._spec_mode:
            alive = self._step_chunked()
            self._chunk_left -= 1
            if self._chunk_left <= 0:
                self._spec_mode = True
                self._spec_ewma, self._spec_samples = None, 0
                self.spec_switches += 1
            return alive

        alive = self._step_spec()
        take = self._last_take
        if take is not None:
            self._spec_ewma = (take if self._spec_ewma is None
                               else 0.6 * self._spec_ewma + 0.4 * take)
            self._spec_samples += 1
            if (self._spec_samples >= self.spec_probe
                    and self._spec_ewma < self.spec_min_take):
                # hand the chains to the chunked program (it resumes from
                # _prev for slots past their prompt)
                for slot, req in self._active.items():
                    if self._slot_len.get(slot, 0) >= len(req.prompt):
                        self._prev[slot] = req.out[-1]
                self._spec_mode = False
                self._chunk_left = self.spec_reprobe
                self.spec_switches += 1
        return alive

    def _step_chunked(self) -> bool:
        self._admit()
        if self.reserve == "ondemand":
            self._ensure_pages()
        if not self._active:
            return bool(self._queue)
        self._keys, outs = self._chunk_step(self._micro_step, self._prev,
                                            self._keys)
        self.steps += 1
        self.micro_steps += self.chunk
        for slot in self._active:
            self._slot_len[slot] = self._slot_len.get(slot, 0) + self.chunk
        self._account_outputs(outs)
        return bool(self._active or self._queue)

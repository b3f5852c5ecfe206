"""Draft-token proposers for speculative decoding, in PyTorch (the
reference is ``repro/serving/draft.py``).

* ``NGramDraft`` — model-free prompt lookup: match the request's trailing
  n-gram against its own context (prompt + everything emitted so far) and
  propose the continuation of the latest earlier occurrence. Pure Python,
  a copy of the reference's.
* ``ModelDraft`` — a small paged-KV model greedily decodes K tokens per
  request over a SECOND page pool: chunked prefill to sync a new request,
  a multi-query catch-up pass (``decode_verify_paged``, the
  ``spec_verify_attention`` kernel on the card) to absorb tokens the
  target committed since the last block, and the fused decode loop to
  propose. Proposed-token KV is written under an all-or-nothing
  reservation and rolled back after every propose.

Both expose ``propose_all(items) -> {rid: [tokens]}`` (items: ``(Request,
k)`` pairs, k >= 0 the per-request max draft length) and ``drop(rid)``
for retirement. Proposals are deterministic given the request state —
the one-hot-draft assumption the leftover/rejection sampler relies on.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import (RuntimeOptions, decode_steps_paged,
                                decode_verify_paged, init_paged_cache,
                                init_params, paged_supported,
                                prefill_paged_chunk, resolve_device)
from repro_torch.serving.kv_manager import (PageAllocationError,
                                            PagedKVManager)
from repro_torch.serving.scheduler import Request


def _next_pow2(n: int) -> int:
    p = 1
    while p < max(n, 1):
        p *= 2
    return p


def _trace_proposals(drafter, items: List[Tuple[Request, int]],
                     out: Dict[int, List[int]]) -> Dict[int, List[int]]:
    """Stamp one ``spec_propose`` instant per drafted request (SS15). The
    engine wires ``drafter.tracer``/``drafter.clock`` per serve; both stay
    None when tracing is off."""
    if drafter.tracer is not None and drafter.clock is not None:
        t = drafter.clock()
        for req, k in items:
            drafter.tracer.instant(
                "spec_propose", t, rid=req.rid,
                args={"k": k, "n": len(out.get(req.rid, []))})
    return out


class NGramDraft:
    """Prompt-lookup draft: propose the continuation of the latest earlier
    occurrence of the request's trailing n-gram (longest n first).

    Keeps a per-request incremental index ``{n: {ngram: latest_start}}``
    over the request's full context, extended only over tokens that
    arrived since the last call — O(tokens * n_orders) total, never an
    O(L^2) rescan. Only starts with at least one continuation token are
    indexed, so a hit always yields a non-empty proposal."""

    def __init__(self, *, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.tracer = None                    # SS15: set by the engine
        self.clock = None
        self._idx: Dict[int, Dict[int, Dict[tuple, int]]] = {}
        self._seen: Dict[int, int] = {}       # rid -> tokens indexed

    def _extend(self, rid: int, toks: List[int]) -> None:
        idx = self._idx.setdefault(
            rid, {n: {} for n in range(self.min_ngram, self.max_ngram + 1)})
        old = self._seen.get(rid, 0)
        L = len(toks)
        for n in range(self.min_ngram, self.max_ngram + 1):
            # new valid starts: s <= L - n - 1 (continuation must exist),
            # including ones straddling the old/new boundary
            for s in range(max(0, old - n), L - n):
                idx[n][tuple(toks[s:s + n])] = s   # later s wins (latest)
        self._seen[rid] = L

    def propose(self, req: Request, k: int) -> List[int]:
        if k <= 0:
            return []
        toks = req.prefill_tokens
        self._extend(req.rid, toks)
        idx = self._idx[req.rid]
        # iterated rollout: after taking a continuation, re-match the NEW
        # trailing n-gram (context + proposal so far) against the index.
        # A single lookup truncates at the end of context — the latest
        # occurrence of a decode loop's tail sits right before L, leaving
        # under a period's worth of continuation — while re-matching
        # unrolls the cycle out to the full draft length.
        prop: List[int] = []
        while len(prop) < k:
            tail = toks + prop
            hit = None
            for n in range(min(self.max_ngram, len(tail)),
                           self.min_ngram - 1, -1):
                s = idx[n].get(tuple(tail[len(tail) - n:]))
                if s is not None:
                    hit = (s, n)
                    break
            if hit is None:
                break
            s, n = hit
            cont = toks[s + n:s + n + k - len(prop)]
            if not cont:
                break
            prop.extend(cont)
        return prop

    def propose_all(self, items: List[Tuple[Request, int]]
                    ) -> Dict[int, List[int]]:
        out = {req.rid: self.propose(req, k) for req, k in items}
        return _trace_proposals(self, items, out)

    def drop(self, rid: int) -> None:
        self._idx.pop(rid, None)
        self._seen.pop(rid, None)

    def take_host_syncs(self) -> int:
        """Prompt lookup never touches the device."""
        return 0


class ModelDraft:
    """Small-model draft over a second paged KV pool.

    Per block, for each drafted request: (1) *sync* — a new request gets
    chunked-prefilled up to the target's landed extent; (2) *catch-up* —
    one batched multi-query pass (``decode_verify_paged``) feeds the
    tokens the target committed since the last block, writing their draft
    KV; (3) *propose* — the fused greedy loop decodes up to k tokens under
    a page reservation that is rolled back immediately (only what the
    target accepts ever becomes landed draft KV, via the next catch-up).

    The draft pool is sized for ``max_batch`` full-length sequences. On
    pool exhaustion the draft drops sequences not in the current batch and
    re-syncs them when they next run. ``device`` is where its weights and
    pool live (the card unless the caller asks for the CPU); ``params``
    default to the port's seeded init of ``cfg``."""

    def __init__(self, cfg, params=None,
                 opts: Optional[RuntimeOptions] = None, *, page_size: int,
                 max_batch: int, max_len: int, seed: int = 1,
                 device="cuda"):
        reason = paged_supported(cfg)
        if reason:
            raise ValueError(f"draft config lacks the paged KV path: {reason}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.opts = opts if opts is not None else RuntimeOptions(
            dtype="float32")
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, self.opts.dtype, self.device)
        self.params = params
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_len = max_len
        self.n_pp = -(-max_len // page_size)
        self.chunk = -(-32 // page_size) * page_size
        n_pages = 1 + max_batch * self.n_pp
        self.kv = PagedKVManager(n_pages, page_size)
        self.cache = init_paged_cache(cfg, n_pages, page_size, self.opts,
                                      self.device)
        self.tracer = None                    # set by the engine
        self.clock = None
        self._synced: Dict[int, bool] = {}    # rid -> has draft KV
        self.host_syncs = 0                   # drained by the engine
        # the passes this draft has run: prefill chunks, catch-up passes
        # and fused decode steps, each one launch of its attention entry a
        # layer on the card
        self.passes = dict(chunks=0, catchups=0, steps=0)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------------ #
    def _admit(self, req: Request) -> None:
        """Allocate + chunked-prefill a request's draft KV up to the
        target's landed extent (= context length - 1; the last token is
        fed by propose/catch-up, same protocol as the target engine)."""
        pf = req.prefill_tokens
        landed = len(pf) - 1
        padded = -(-max(landed, 1) // self.page_size) * self.page_size
        try:
            self.kv.allocate(req.rid, landed, reserve_tokens=padded)
        except PageAllocationError:
            # preempted waiters keep draft KV opportunistically; reclaim
            # theirs before giving up (they re-sync when they next run)
            for rid in [r for r in self._synced if r != req.rid]:
                self.drop(rid)
            self.kv.allocate(req.rid, landed, reserve_tokens=padded)
        C = self.chunk
        pt = self._dev(self.kv.table_row(req.rid, self.n_pp)[None])
        for start in range(0, landed, C):
            n_real = min(C, landed - start)
            toks = np.zeros((1, C), np.int32)
            toks[0, :n_real] = pf[start:start + n_real]
            _, self.cache = prefill_paged_chunk(
                self.cfg, self.params, self._dev(toks), self.cache, pt,
                start, self._dev(np.asarray([start + n_real], np.int32)),
                self.opts)
            self.passes["chunks"] += 1
        self._synced[req.rid] = True

    def propose_all(self, items: List[Tuple[Request, int]]
                    ) -> Dict[int, List[int]]:
        if not items:
            return {}
        B = self.max_batch
        assert len(items) <= B, "more drafted requests than draft slots"

        # ---- sync + catch-up bookkeeping (host) ---- #
        catchup: List[Tuple[int, Request, int, int]] = []  # slot, req, have, m
        for i, (req, _) in enumerate(items):
            if req.rid not in self._synced:
                self._admit(req)
            have = self.kv.seq_len(req.rid)
            landed = len(req.prefill_tokens) - 1
            m = landed - have
            if m > 0:
                catchup.append((i, req, have, m))

        # ---- one batched catch-up pass over everyone behind ---- #
        if catchup:
            Cc = _next_pow2(max(m for _, _, _, m in catchup))
            toks = np.zeros((B, Cc), np.int32)
            lens = np.zeros((B,), np.int32)
            fed = np.ones((B,), np.int32)     # inactive rows feed 1 pad
            tables = np.zeros((B, self.n_pp), np.int32)
            for i, req, have, m in catchup:
                pf = req.prefill_tokens
                toks[i, :m] = pf[have:have + m]
                lens[i] = have
                fed[i] = m
                self.kv.reserve_ahead(req.rid, m)
                tables[i] = self.kv.table_row(req.rid, self.n_pp)
            _, self.cache = decode_verify_paged(
                self.cfg, self.params, self._dev(toks), self._dev(lens),
                self._dev(fed), self._dev(tables), self.cache, self.opts)
            self.passes["catchups"] += 1
            for i, req, have, m in catchup:
                self.kv.commit_tokens(req.rid, m)

        # ---- batched propose under a rolled-back reservation ---- #
        ks = [max(0, k) for _, k in items]
        k_top = max(ks)
        if k_top == 0:
            return _trace_proposals(self, items,
                                    {req.rid: [] for req, _ in items})
        tokens = np.zeros((B,), np.int32)
        lens = np.zeros((B,), np.int32)
        tables = np.zeros((B, self.n_pp), np.int32)
        quota = np.zeros((B,), np.int32)
        inactive = np.ones((B,), bool)
        for i, (req, k) in enumerate(items):
            if k <= 0:
                continue
            self.kv.reserve_ahead(req.rid, k)
            tokens[i] = req.prefill_tokens[-1]
            lens[i] = self.kv.seq_len(req.rid)
            tables[i] = self.kv.table_row(req.rid, self.n_pp)
            quota[i] = k
            inactive[i] = False
        n_steps = _next_pow2(k_top)
        blk, self.cache = decode_steps_paged(
            self.cfg, self.params, self._dev(tokens), self._dev(lens),
            self._dev(tables), self.cache, n_steps, self.opts, eos_id=None,
            done=self._dev(inactive), quota=self._dev(quota))
        self.passes["steps"] += n_steps
        blk_np = blk.cpu().numpy()
        self.host_syncs += 1       # the propose block's device->host pull
        out: Dict[int, List[int]] = {}
        for i, (req, k) in enumerate(items):
            out[req.rid] = [int(t) for t in blk_np[i, :k]] if k > 0 else []
            if k > 0:
                self.kv.release_reserved(req.rid)   # propose KV rolls back
        return _trace_proposals(self, items, out)

    def drop(self, rid: int) -> None:
        if self._synced.pop(rid, None):
            self.kv.free_seq(rid)

    def take_host_syncs(self) -> int:
        """Return and reset the syncs taken since the last drain; the
        engine folds them into ``ServeStats.host_syncs`` per spec block."""
        n = self.host_syncs
        self.host_syncs = 0
        return n

"""Continuous-batching request scheduler with chunked prefill
(DESIGN.md SS10/SS11).

Iteration-level scheduling over a fixed set of batch *slots*: requests join
the running batch the moment a slot and enough KV pages are free, and
retire individually (EOS / token budget), so short requests never wait for
the longest member of a wave — the failure mode of the static bucketed
engine under the paper's concurrent-inference pressure.

Prefill is *chunked*: an admitted request does not monopolize the engine
for its whole prompt. It enters a PREFILLING state and advances by
fixed-size chunks inside the decode loop, limited by a per-step prefill
token budget, so in-flight decodes keep emitting while a long prompt
streams in (the prefill/decode-interference fix; LIMINAL,
arXiv:2507.14397). Fixed chunk shapes also mean the jitted prefill
compiles once instead of once per padded prompt length.

When the page pool is exhausted mid-decode the scheduler preempts the
most-recently admitted running request (LIFO, vLLM-style recompute
preemption): its pages are freed and its prompt *plus the tokens it already
emitted* are requeued as a new prefill, which makes preemption invisible in
the final output (greedy decode is deterministic). With the prefix cache
enabled, a victim's full pages are registered before the free, so its
re-admission — and any request sharing its prefix — hits the cache instead
of recomputing.

Admission is against the pool's TOTAL capacity — every tier of the
``TierBudget``, fast tiers plus the HBS offload tier — not the fast tiers
alone (DESIGN.md SS13). A long-context request whose KV exceeds the fast
budget is admitted and runs with its cold pages spilled to the offload
tier; the engine's per-block prefetch/fetch-wait barrier charges the
migration time as decode stall instead of this scheduler preempting it.
Preemption remains the response to *total* exhaustion only.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.serving.kv_manager import PageAllocationError, PagedKVManager

WAITING, PREFILLING, RUNNING, DONE = ("waiting", "prefilling", "running",
                                      "done")


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    out: List[int] = field(default_factory=list)
    state: str = WAITING
    n_preemptions: int = 0
    admit_order: int = -1      # monotone stamp of the LAST admission
    n_prefilled: int = 0       # prompt tokens whose KV is cached (chunked)
    t_submit: float = 0.0      # engine timestamps (TTFT / inter-token)
    t_last: float = 0.0
    stall_s: float = 0.0       # HBS residency stall attributed to THIS
                               # request's pages (SS13/SS14)
    draft_proposed: int = 0    # speculative decoding counters (SS14)
    draft_accepted: int = 0
    accept_ema: float = 1.0    # EMA of per-verify-pass acceptance rate

    @property
    def prefill_tokens(self) -> List[int]:
        """What a (re)prefill must feed: prompt + already-emitted tokens."""
        return self.prompt + self.out

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.out)


class AdaptiveSpecK:
    """Acceptance-rate-adaptive draft length (DESIGN.md SS14).

    Each verify pass costs one full weight + KV streaming round whatever
    K is, but rejected draft positions waste verify-window compute and
    reserved pages. Track a per-request EMA of the acceptance *rate*
    (accepted / proposed per pass) and size the next window as
    ``clamp(round(ema * k_max), k_min, k_max)`` — a request whose context
    predicts well (shared-document QA) keeps the full window, one that
    keeps rejecting shrinks toward ``k_min`` and degrades gracefully to
    near-plain decode."""

    def __init__(self, k_max: int, *, k_min: int = 1, beta: float = 0.5):
        if k_max < 1:
            raise ValueError("k_max must be >= 1")
        self.k_max = k_max
        self.k_min = max(1, min(k_min, k_max))
        self.beta = beta

    def k_for(self, req: Request) -> int:
        k = int(round(req.accept_ema * self.k_max))
        return max(self.k_min, min(self.k_max, k))

    def update(self, req: Request, proposed: int, accepted: int) -> None:
        if proposed <= 0:
            return
        rate = accepted / proposed
        req.accept_ema = ((1.0 - self.beta) * req.accept_ema
                          + self.beta * rate)


class ContinuousScheduler:
    """Owns the waiting queue, the slot table, prefill chunking state, and
    the preemption policy."""

    def __init__(self, kv: PagedKVManager, max_batch: int, *,
                 prefill_chunk: Optional[int] = None,
                 prefill_budget: Optional[int] = None,
                 tracer=None, clock=None):
        """``prefill_chunk``: tokens per prefill chunk (None: the engine
        prefills whole prompts in one shot — legacy mode). ``prefill_budget``
        caps prefill tokens per engine step (default: one chunk).
        ``tracer``/``clock``: optional TraceRecorder + virtual-clock callable
        (SS15); admissions and preemptions stamp instant events."""
        self.kv = kv
        self.max_batch = max_batch
        self.tracer = tracer
        self.clock = clock
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_budget or prefill_chunk or 0
        if prefill_chunk and self.prefill_budget < prefill_chunk:
            raise ValueError("prefill_budget must cover at least one chunk")
        self.waiting: Deque[Request] = deque()
        self.slots: Dict[int, Request] = {}      # slot index -> request
        self.done: List[Request] = []
        self._admit_stamp = 0

    # ------------------------------ queries ---------------------------- #
    @property
    def n_running(self) -> int:
        return len(self.slots)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.slots)

    def free_slots(self) -> List[int]:
        return [i for i in range(self.max_batch) if i not in self.slots]

    def prefilling(self) -> List[Tuple[int, Request]]:
        """PREFILLING slots, FCFS by admission order."""
        return sorted(((s, r) for s, r in self.slots.items()
                       if r.state == PREFILLING),
                      key=lambda sr: sr[1].admit_order)

    def running(self) -> List[Tuple[int, Request]]:
        return sorted((s, r) for s, r in self.slots.items()
                      if r.state == RUNNING)

    # ------------------------------ submit ----------------------------- #
    def submit(self, req: Request) -> None:
        # sized against TOTAL capacity (fast tiers + offload tier): a
        # request bigger than the fast budget runs spilled, not rejected
        total = len(req.prompt) + req.max_new_tokens
        if not self.kv.fits_at_all(total):
            raise ValueError(
                f"request {req.rid} needs {self.kv.pages_needed(total)} pages"
                f" but the pool only has {self.kv.n_pages - 1} across all "
                f"tiers")
        self.waiting.append(req)

    def _should_defer(self, req: Request) -> bool:
        """Hold a request back while an in-flight prefill is still computing
        a prefix the request could reuse: admitting it now would recompute
        (and re-store) pages that are about to appear in the cache."""
        pf = req.prefill_tokens
        ps = self.kv.page_size
        cap = (len(pf) - 1) // ps * ps      # reusable extent (full pages)
        avail = self.kv.lookup_prefix(pf)
        for other in self.slots.values():
            if other.state != PREFILLING:
                continue
            common = 0
            for a, b in zip(pf, other.prefill_tokens):
                if a != b:
                    break
                common += 1
            if min(common // ps * ps, cap) > avail:
                return True
        return False

    # ------------------------------ admit ------------------------------ #
    def admit(self) -> List[Tuple[int, Request]]:
        """Admit waiting requests while a slot + pages are available.

        Reserves pages for the worst-case prefill extent plus one headroom
        page so an admission cannot immediately deadlock the next decode
        step. With the prefix cache, matched prefix pages are shared by
        reference and ``req.n_prefilled`` starts past them."""
        admitted: List[Tuple[int, Request]] = []
        free = self.free_slots()
        while free and self.waiting:
            req = self.waiting[0]
            pf_len = len(req.prefill_tokens)
            padded = -(-pf_len // self.kv.page_size) * self.kv.page_size
            # a solo admission may take the whole pool (``submit`` proved the
            # request fits it end-to-end); otherwise keep one headroom page
            # so the next decode write cannot instantly deadlock. Chunk
            # right-padding needs no extra pages: positions past the reserve
            # spill into the null page.
            solo = not self.slots and not admitted
            if not self.kv.can_admit(padded, headroom_pages=0 if solo else 1):
                break                      # FCFS: don't starve the head
            if (self.kv.enable_prefix_cache and self.prefill_chunk
                    and self._should_defer(req)):
                break                      # its prefix is being prefilled
            self.waiting.popleft()
            slot = free.pop(0)
            if self.kv.enable_prefix_cache:
                alloc = self.kv.allocate_shared(req.rid, req.prefill_tokens,
                                                reserve_tokens=padded)
                req.n_prefilled = alloc.n_cached
            else:
                self.kv.allocate(req.rid, pf_len, reserve_tokens=padded)
                req.n_prefilled = 0
            if self.prefill_chunk:
                # chunked mode: only the cached prefix holds KV so far —
                # un-prefilled prompt pages must not be priced as traffic
                self.kv.mark_written(req.rid, req.n_prefilled)
            req.state = PREFILLING if self.prefill_chunk else RUNNING
            req.admit_order = self._admit_stamp
            self._admit_stamp += 1
            self.slots[slot] = req
            admitted.append((slot, req))
            if self.tracer is not None:
                self.tracer.admit(req.rid, self.clock(),
                                  cached_tokens=req.n_prefilled, slot=slot)
        return admitted

    def finish_prefill(self, slot: int) -> None:
        self.slots[slot].state = RUNNING

    # ----------------------------- retire ------------------------------ #
    def retire(self, slot: int) -> Request:
        req = self.slots.pop(slot)
        req.state = DONE
        # leave the finished sequence's full pages in the prefix cache
        # (refcount 0, evictable) for later shared-prefix requests
        self.kv.register_prefix(req.rid, req.prefill_tokens,
                                n_valid=self.kv.seq_len(req.rid))
        self.kv.free_seq(req.rid)
        self.done.append(req)
        return req

    # ---------------------------- preemption --------------------------- #
    def preempt_one(self, protect: Optional[int] = None) -> Optional[int]:
        """Evict the most recently admitted request (except the ``protect``
        slot); its pages return to the pool and it rejoins the FRONT of the
        waiting queue for recompute. Valid full pages are registered first
        so the re-admission hits the prefix cache. Returns the slot freed."""
        candidates = [(req.admit_order, slot) for slot, req in
                      self.slots.items() if slot != protect]
        if not candidates:
            return None
        _, slot = max(candidates)
        req = self.slots.pop(slot)
        # valid KV extent: mid-prefill it is the chunk progress; mid-decode
        # every token but the last emitted one has its KV landed (the last
        # one's write happens in the next decode block). register_prefix
        # additionally caps this by the manager's landed length, which
        # covers the legacy grow-then-write accounting too.
        n_valid = (req.n_prefilled if req.state == PREFILLING
                   else max(len(req.prefill_tokens) - 1, 0))
        if self.tracer is not None:
            # n_valid raises the recorder's computed high-water mark so the
            # victim's re-prefill is attributed as recompute, not prefill
            self.tracer.preempt(req.rid, self.clock(), n_valid=n_valid)
        self.kv.register_prefix(req.rid, req.prefill_tokens, n_valid=n_valid)
        self.kv.free_seq(req.rid)
        req.state = WAITING
        req.n_preemptions += 1
        req.admit_order = -1
        req.n_prefilled = 0
        self.waiting.appendleft(req)
        return slot

    def grow_seq(self, slot: int) -> None:
        """Account one appended token for the request in ``slot``, preempting
        others (LIFO) until the page pool can take the write."""
        req = self.slots[slot]
        while True:
            try:
                self.kv.append_token(req.rid)
                return
            except PageAllocationError:
                if self.preempt_one(protect=slot) is None:
                    raise

    def reserve_lookahead(self, slot: int, k: int) -> None:
        """Reserve ``k`` decode KV writes for ``slot`` before a fused
        decode block (DESIGN.md SS12), preempting others (LIFO) until the
        all-or-nothing reservation fits. A solo request always fits: its
        lookahead window never extends past the prompt+budget extent that
        ``submit`` proved the pool holds."""
        req = self.slots[slot]
        while True:
            try:
                self.kv.reserve_ahead(req.rid, k)
                return
            except PageAllocationError:
                if self.preempt_one(protect=slot) is None:
                    raise

"""Continuous batching — admission, decode slots, shedding.

Counterpart of the core of ``apex_tpu/serve/scheduler.py``.  A decode
iteration costs nearly the same whether 1 or ``max_batch`` sequences
ride it, so :class:`ContinuousBatchingScheduler` admits new sequences
into the running batch at page granularity: a prefill slots in between
decode iterations, the new sequence joins the very next decode, and a
finished sequence frees its pages to the pool at once.

- a request is admitted when a decode slot is free AND the page pool
  covers its whole prompt (``PagePool.alloc`` is all-or-nothing);
  otherwise it waits at the queue head;
- a running sequence takes one growth page at a time; when the pool is
  empty, the youngest running request is shed (``growth_victim``) so the
  older ones keep making progress;
- a non-finite logits row sheds only its own request (``poisoned``);
- with ``prefix_cache=True`` each admitted prompt probes a
  :class:`~apex_tpu_torch.serve.cache.PrefixCache` once and borrows the
  longest cached run of its pages; its prompt's pages are committed
  after its prefill; a shared page is forked (copy-on-write) before a
  request appends into it; an exhausted pool first evicts idle cached
  runs;
- with the prefix cache or ``prefill_chunk_tokens`` a prefill advances
  one page-multiple chunk per step (a hit re-runs only its last chunk),
  between decode iterations;
- each request samples at its own ``temperature`` (<= 0 is greedy),
  its noise keyed by its stream seed and generation index.

:meth:`leak_check` (``PagePool.leak_check`` against the live ownership
ledger and the cache's pages) runs after every retirement.  Retries,
deadlines, the overload ladder, drain, speculative decoding, metrics
and spans are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
import zlib
from typing import Deque, List, Optional

import numpy as np

from apex_tpu_torch.serve.cache import NULL_PAGE, PrefixCache

__all__ = [
    "Request",
    "ContinuousBatchingScheduler",
    "SHED_REASONS",
]

_ids = itertools.count()

QUEUED = "queued"
PREFILLING = "prefilling"
RUNNING = "running"
DONE = "done"
SHED = "shed"

#: shed reasons: ``growth_victim`` (youngest running request shed to
#: free a growth page), ``pool_exhausted`` (a running request could not
#: grow even after a victim shed), ``oversize`` (prompt exceeds the max
#: context), ``poisoned`` (non-finite logits row)
SHED_GROWTH_VICTIM = "growth_victim"
SHED_POOL_EXHAUSTED = "pool_exhausted"
SHED_OVERSIZE = "oversize"
SHED_POISONED = "poisoned"
SHED_REASONS = (
    SHED_GROWTH_VICTIM, SHED_POOL_EXHAUSTED, SHED_OVERSIZE, SHED_POISONED,
)


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle ledger."""

    prompt: List[int]
    max_new_tokens: int = 16
    eos_token: Optional[int] = None
    #: sampling temperature of the fused sampler; <= 0 is greedy argmax
    temperature: float = 0.0
    #: the sampling stream's seed: every draw of this request is keyed by
    #: it and the draw's generation index, never by engine call counters.
    #: None derives one from :attr:`rid`; pass a seed to reproduce a
    #: stream across schedulers
    stream_seed: Optional[int] = None
    rid: int = dataclasses.field(default_factory=lambda: next(_ids))

    # -- runtime ledger (scheduler-owned) --------------------------------
    status: str = QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    #: KV positions written (prompt + generated-and-fed tokens)
    ctx_len: int = 0
    #: submission time (the growth-victim order: youngest is shed first)
    submitted_at: Optional[float] = None
    #: why this request was shed (one of :data:`SHED_REASONS`), else None
    shed_reason: Optional[str] = None
    # -- prefix cache / chunked prefill (scheduler-owned) ----------------
    #: prompt tokens already covered by KV pages (cache hit + completed
    #: prefill chunks); equals ``len(prompt)`` once prefill is done
    prefill_pos: int = 0
    #: prompt tokens the prefix cache covered at admission (0 = miss)
    cache_hit_tokens: int = 0
    #: leading pages of :attr:`pages` borrowed from the cache (chunk
    #: writes to them go to the null page)
    cache_hit_pages: int = 0
    #: the cache was already probed for this request (match + borrow
    #: run once, even when admission then waits on the pool)
    cache_probed: bool = False


class ContinuousBatchingScheduler:
    """Drive an :class:`~apex_tpu_torch.serve.engine.InferenceEngine`
    with continuous batching.

    >>> sched = ContinuousBatchingScheduler(engine, prefix_cache=True)
    >>> sched.submit(Request(prompt=[...], max_new_tokens=32))
    >>> sched.run()

    ``prefix_cache=True`` shares committed prompt pages across requests;
    ``prefill_chunk_tokens`` (a positive page multiple) runs prefill in
    chunks of that many tokens, one chunk a step.  With either, prefill
    goes through the engine's chunked prefill.
    """

    def __init__(self, engine, *, clock=time.monotonic,
                 prefix_cache: bool = False,
                 prefill_chunk_tokens: Optional[int] = None):
        self.engine = engine
        self.pool = engine.pool
        self.serve = engine.serve
        self.clock = clock
        self.prefix = PrefixCache(self.pool) if prefix_cache else None
        if prefill_chunk_tokens is not None and (
            prefill_chunk_tokens <= 0
            or prefill_chunk_tokens % self.serve.page_size
        ):
            raise ValueError(
                "prefill_chunk_tokens must be a positive multiple of "
                f"page_size={self.serve.page_size}, got "
                f"{prefill_chunk_tokens}"
            )
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.leak_checks_run = 0
        #: copy-on-write forks of shared pages
        self.forks = 0
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * self.serve.max_batch
        self.completed: List[Request] = []
        self.shed: List[Request] = []

    # -- bookkeeping ------------------------------------------------------
    @property
    def running(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def pending(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def submit(self, req: Request) -> Request:
        req.status = QUEUED
        if req.submitted_at is None:
            req.submitted_at = self.clock()
        self.queue.append(req)
        return req

    def _page_table_row(self, req: Request) -> np.ndarray:
        row = np.full((self.serve.max_pages_per_seq,), NULL_PAGE, np.int32)
        row[: len(req.pages)] = req.pages
        return row

    def _retire(self, req: Request, status: str,
                reason: Optional[str] = None) -> None:
        if req.pages:
            # one reference each: a borrowed page survives its co-holders
            self.pool.free(req.pages)
            req.pages = []
        req.status = status
        req.shed_reason = reason if status == SHED else None
        (self.completed if status == DONE else self.shed).append(req)
        # every free path funnels through here: page accounting is
        # re-proven exact on each of them
        self.leak_check()

    def _shed_request(self, req: Request, reason: str) -> None:
        self._retire(req, SHED, reason)

    # -- page accounting ---------------------------------------------------
    def owned_pages(self) -> List[List[int]]:
        """The live ownership ledger: per-request page lists of the
        slots and of queued requests that already borrowed cached
        pages."""
        owned = [r.pages for r in self.slots if r is not None and r.pages]
        owned.extend(r.pages for r in self.queue if r.pages)
        return owned

    def leak_check(self) -> None:
        """Assert ``PagePool`` accounting is exact against
        :meth:`owned_pages` and the prefix cache's pages (raises
        ``ValueError`` naming the pages)."""
        self.pool.leak_check(
            self.owned_pages(),
            cached=self.prefix.cached_pages() if self.prefix else (),
        )
        self.leak_checks_run += 1

    def _alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages, all or nothing.  An exhausted pool first evicts
        idle prefix-cache runs (LRU, never a borrowed page): cached
        history yields to live work."""
        got = self.pool.alloc(n)
        if got is None and self.prefix is not None:
            if self.prefix.evict(need=n):
                self.leak_check()
                got = self.pool.alloc(n)
        return got

    def _stream(self, req: Request) -> int:
        """The request's sampling-stream id: its seed, or a hash of its
        id."""
        if req.stream_seed is not None:
            return req.stream_seed
        return zlib.crc32(str(req.rid).encode()) & 0x7FFFFFFF

    # -- admission --------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _admit_one(self) -> bool:
        """Try to move the queue head into a free slot and prefill it (or
        start its chunked prefill).  Returns True when a request was
        admitted or shed (progress)."""
        if not self.queue:
            return False
        slot = self._free_slot()
        if slot is None:
            return False
        req = self.queue[0]
        if len(req.prompt) > self.serve.max_context:
            self.queue.popleft()
            self._shed_request(req, SHED_OVERSIZE)
            return True
        need = self.pool.pages_for(len(req.prompt))
        if self.prefix is not None and not req.cache_probed:
            # ONE probe per request: match + borrow pin the hit run
            # before any allocation, so the eviction the allocation may
            # trigger never reclaims the pages this request will ride;
            # the borrowed pages are on req.pages (the ledger) from here
            req.cache_probed = True
            hit_pages, hit_tokens = self.prefix.match(req.prompt)
            if hit_tokens:
                self.prefix.borrow(hit_pages)
                req.pages = list(hit_pages)
                req.cache_hit_pages = len(hit_pages)
                req.cache_hit_tokens = hit_tokens
        if len(req.pages) < need:
            grown = self._alloc(need - len(req.pages))
            if grown is None:
                return False  # pool exhausted: the head waits
            req.pages = req.pages + grown
        self.queue.popleft()
        if self.prefix is not None or self.prefill_chunk_tokens is not None:
            return self._start_chunked_prefill(req, slot)
        _, first = self.engine.prefill(
            req.prompt, req.pages, temperature=req.temperature,
            stream=self._stream(req),
        )
        if not self.engine.last_prefill_finite:
            self._shed_request(req, SHED_POISONED)
            return True
        return self._finish_prefill(req, slot, first)

    def _start_chunked_prefill(self, req: Request, slot: int) -> bool:
        """Park the request in its slot with the prefill cursor past the
        cache hit, floored to the chunk grain (so a hit re-runs the same
        final chunk as the cold run, and its first token is the cold
        run's); :meth:`_advance_prefills` runs one chunk a step."""
        n = len(req.prompt)
        grain = self.prefill_chunk_tokens or self.serve.page_size
        # never skip the last position: its logits make the first token
        req.prefill_pos = (min(req.cache_hit_tokens, n - 1) // grain) * grain
        req.status = PREFILLING
        self.slots[slot] = req
        return True

    def _advance_prefill(self, req: Request, slot: int) -> None:
        """Run one prefill chunk of a prefilling slot.  The chunk starts
        page-aligned, so its KV blocks map 1:1 onto the request's pages;
        blocks on borrowed cache pages go to the null page — a hit never
        rewrites a page another request may read."""
        n = len(req.prompt)
        ps = self.serve.page_size
        start = req.prefill_pos
        end = min(start + (self.prefill_chunk_tokens or n), n)
        chunk_pages = [
            NULL_PAGE if pi < req.cache_hit_pages else req.pages[pi]
            for pi in range(start // ps, (end - 1) // ps + 1)
        ]
        _, first = self.engine.chunk_prefill(
            req.prompt[start:end], start, req.pages, chunk_pages,
            temperature=req.temperature, stream=self._stream(req),
        )
        if not self.engine.last_prefill_finite:
            self.slots[slot] = None
            self._shed_request(req, SHED_POISONED)
            return
        req.prefill_pos = end
        if end == n:
            self._finish_prefill(req, slot, first)

    def _advance_prefills(self) -> None:
        for i, req in enumerate(self.slots):
            if req is not None and req.status == PREFILLING:
                self._advance_prefill(req, i)

    def _finish_prefill(self, req: Request, slot: int, first: int) -> bool:
        """First-token bookkeeping of both prefill paths; with the cache,
        also commit the prompt's pages."""
        req.ctx_len = len(req.prompt)
        req.prefill_pos = len(req.prompt)
        req.tokens.append(first)
        req.status = RUNNING
        self.slots[slot] = req
        if self.prefix is not None:
            self.prefix.commit(
                req.prompt, req.pages[: self.pool.pages_for(len(req.prompt))]
            )
        if self._finished(req):
            self.slots[slot] = None
            self._retire(req, DONE)
        return True

    def _finished(self, req: Request) -> bool:
        if len(req.tokens) >= req.max_new_tokens:
            return True
        if req.eos_token is not None and req.tokens and (
            req.tokens[-1] == req.eos_token
        ):
            return True
        # context capacity: the NEXT fed token would not fit
        return req.ctx_len + 1 > self.serve.max_context

    # -- decode -----------------------------------------------------------
    def _ensure_target_page(self, req: Request, idx: int) -> bool:
        """Make page ``idx`` of the request writable: allocate it if the
        request has not reached it, and fork it first when it is shared
        (a borrowed cache run's tail, or the request's own pages after
        it committed them): a fresh page gets a device copy, the shared
        reference is dropped, and the appends go to the private copy."""
        if idx < len(req.pages):
            page = req.pages[idx]
            if self.pool.refcount(page) > 1:
                got = self._alloc(1)
                if got is None:
                    return False
                self.engine.fork_page(page, got[0])
                self.pool.free([page])
                req.pages[idx] = got[0]
                if req.cache_hit_pages > idx:
                    req.cache_hit_pages = idx
                self.forks += 1
            return True
        while len(req.pages) <= idx:
            got = self._alloc(1)
            if got is None:
                return False
            req.pages.extend(got)
        return True

    def _ensure_growth_page(self, req: Request) -> bool:
        """The next append lands at position ``ctx_len``; allocate (or
        fork) its page if needed."""
        return self._ensure_target_page(
            req, req.ctx_len // self.serve.page_size
        )

    def _plain_decode_once(self) -> None:
        """One single-token decode iteration over every running slot
        (prefilling slots advance by chunks instead)."""
        b = len(self.slots)
        tokens = np.zeros((b,), np.int64)
        lengths = np.zeros((b,), np.int32)
        temps = np.zeros((b,), np.float32)
        streams = np.zeros((b,), np.int64)
        gens = np.zeros((b,), np.int64)
        tables = np.full(
            (b, self.serve.max_pages_per_seq), NULL_PAGE, np.int32
        )
        for i, req in enumerate(self.slots):
            if req is None or req.status == PREFILLING:
                continue
            if not self._ensure_growth_page(req):
                # pool exhausted mid-decode: shed the youngest running
                # request (least sunk cost) and retry this one
                victim = sorted(
                    self.running, key=lambda r: r.submitted_at
                )[-1]
                v_slot = self.slots.index(victim)
                self.slots[v_slot] = None
                self._shed_request(victim, SHED_GROWTH_VICTIM)
                # the victim's row may already be staged for this
                # iteration — clear it so the decode never touches its
                # (now freed) pages
                tokens[v_slot] = 0
                lengths[v_slot] = 0
                tables[v_slot] = NULL_PAGE
                if victim is req or not self._ensure_growth_page(req):
                    if self.slots[i] is req:
                        self.slots[i] = None
                        self._shed_request(req, SHED_POOL_EXHAUSTED)
                    continue
            tokens[i] = req.tokens[-1]
            lengths[i] = req.ctx_len + 1  # context incl. the fed token
            temps[i] = req.temperature
            streams[i] = self._stream(req)
            gens[i] = len(req.tokens) - 1
            tables[i] = self._page_table_row(req)
        if not lengths.any():
            return
        _, next_tokens = self.engine.decode(tokens, lengths, tables, temps,
                                            streams=streams, gens=gens)
        finite = self.engine.last_decode_finite
        for i, req in enumerate(self.slots):
            if req is None or req.status == PREFILLING:
                continue
            if not bool(finite[i]):
                # quarantine: a non-finite logits row evicts ONLY the
                # offending slot; the rest keep this iteration's tokens
                self.slots[i] = None
                self._shed_request(req, SHED_POISONED)
                continue
            req.ctx_len += 1
            req.tokens.append(int(next_tokens[i]))
            if self._finished(req):
                self.slots[i] = None
                self._retire(req, DONE)

    # -- the iteration ----------------------------------------------------
    def step(self) -> None:
        """One continuous-batching iteration: admit into free slots
        (prefilling a request, or starting its chunked prefill), advance
        each chunked prefill by one chunk, then one decode pass over the
        running batch."""
        while self._admit_one():
            pass
        self._advance_prefills()
        self._plain_decode_once()

    def run(self, max_steps: int = 10_000) -> None:
        """Step until every submitted request completed or was shed."""
        for _ in range(max_steps):
            if not self.pending:
                return
            self.step()
        raise RuntimeError(
            f"scheduler did not drain within {max_steps} iterations"
        )

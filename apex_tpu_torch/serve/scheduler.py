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

- with an engine that carries a
  :class:`~apex_tpu_torch.serve.spec.SpecConfig`, each running request
  rides a speculative round a step (the draft proposes ``k`` tokens from
  its own KV pages, allocated in the ``"draft"`` namespace and never
  shared into the prefix cache; the target verifies them; the rejected
  tail is rolled back).  The whole span a round may write is forked
  (copy-on-write) before the round; a request whose span cannot be
  provisioned, or that is near the context ceiling, decodes plain that
  step; once the acceptance rate over the last ``window`` rounds falls
  below ``min_accept_rate``, every request decodes plain.

:meth:`leak_check` (``PagePool.leak_check`` against the live ownership
ledger, draft pages included, and the cache's pages) runs after every
retirement.  Not ported yet: retries, deadlines, the overload ladder,
drain and ``resume()`` (which re-arms the acceptance fallback), and the
draft's chaos site (ROADMAP item 4); the metrics board and spans (item
8): the spec counters are plain attributes.
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
    # -- speculative decoding (scheduler-owned) --------------------------
    #: the draft's KV pages (``"draft"`` pool namespace), mirroring
    #: :attr:`pages` position for position; freed on every retire path
    draft_pages: List[int] = dataclasses.field(default_factory=list)
    #: False once this request's draft state is unusable (its draft
    #: prefill failed): the stream decodes plain from then on
    spec_ok: bool = True


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
        spec = engine.spec
        #: speculative decoding's counters: rounds, proposals drafted and
        #: accepted, rollbacks (slots with a rejected tail), fallbacks to
        #: plain decode, failed draft prefills
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_rollbacks = 0
        self.spec_fallbacks = 0
        self.draft_faults = 0
        #: per-round (drafted, accepted, emitted, slot_steps) over the last
        #: ``spec.window`` rounds: the acceptance fallback's evidence
        self._spec_window: Optional[Deque] = (
            collections.deque(maxlen=spec.window) if spec is not None
            else None)
        #: the acceptance fallback tripped: every request decodes plain
        self._spec_fallback = False

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
        if req.draft_pages:
            self.pool.free(req.draft_pages)
            req.draft_pages = []
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
        """The live ownership ledger: per-request page lists (target and
        draft) of the slots and of queued requests that already hold
        pages."""
        live = [r for r in self.slots if r is not None] + list(self.queue)
        owned = [r.pages for r in live if r.pages]
        owned.extend(r.draft_pages for r in live if r.draft_pages)
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

    def _alloc(self, n: int, ns: str = "kv") -> Optional[List[int]]:
        """``n`` pages in namespace ``ns`` (``"draft"`` for the draft's
        KV), all or nothing.  An exhausted pool first evicts idle
        prefix-cache runs (LRU, never a borrowed page): cached history
        yields to live work."""
        got = self.pool.alloc(n, ns=ns)
        if got is None and self.prefix is not None:
            if self.prefix.evict(need=n):
                self.leak_check()
                got = self.pool.alloc(n, ns=ns)
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
        if self.engine.spec is not None and req.spec_ok:
            # the draft mirrors the prompt's page span in its own
            # namespace, all or nothing: a request never admits with a
            # half-provisioned draft cache (its target pages stay on the
            # ledger while it waits)
            dneed = need - len(req.draft_pages)
            if dneed > 0:
                dgot = self._alloc(dneed, ns="draft")
                if dgot is None:
                    return False
                req.draft_pages.extend(dgot)
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
        if self.engine.spec is not None and req.spec_ok:
            # the draft's KV over the prompt, so proposals start from the
            # context the target sees.  A failed draft prefill demotes the
            # request to plain decode: the draft is an accelerator, never
            # a dependency of the stream
            try:
                self.engine.draft_prefill(req.prompt, req.draft_pages)
            except Exception:  # noqa: BLE001 — counted, stream goes plain
                self.draft_faults += 1
                req.spec_ok = False
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

    def _ensure_spec_span(self, req: Request) -> bool:
        """Provision the whole span a spec round may write BEFORE the
        round: target KV at positions ``ctx_len`` through ``ctx_len +
        k``, so every page the span touches is made private and writable
        now (rejected positions are overwritten in place, which is only
        safe because no shared page is ever written), and the draft span
        grows alongside in the ``"draft"`` namespace.  False when a page
        cannot be had (the request decodes plain this step)."""
        ps = self.serve.page_size
        k = self.engine.spec.k
        for idx in range(req.ctx_len // ps, (req.ctx_len + k) // ps + 1):
            if idx >= self.serve.max_pages_per_seq:
                return False
            if not self._ensure_target_page(req, idx):
                return False
            while len(req.draft_pages) <= idx:
                got = self._alloc(1, ns="draft")
                if got is None:
                    return False
                req.draft_pages.extend(got)
        return True

    def _decode_once(self) -> None:
        """One decode pass over the running batch: spec rounds for the
        requests with a healthy draft (unless the acceptance fallback
        tripped), plain single-token decode for the rest."""
        if self.engine.spec is not None and not self._spec_fallback:
            self._spec_decode_once()
        else:
            self._plain_decode_once()

    def _plain_decode_once(self, only: Optional[set] = None) -> None:
        """One single-token decode iteration over every running slot, or
        over the slot indices in ``only`` (the plain side of a mixed
        batch); prefilling slots advance by chunks instead."""
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
            if only is not None and i not in only:
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
            if only is not None and i not in only:
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

    # -- speculative decoding ---------------------------------------------
    def _spec_decode_once(self) -> None:
        """Partition the running batch: requests with a healthy draft
        ride a spec round; requests demoted from their draft, whose span
        cannot be provisioned or that are near the context ceiling ride
        plain decode.  Mixed batches are the steady state."""
        k = self.engine.spec.k
        spec_idx: List[int] = []
        plain_idx: List[int] = []
        for i, req in enumerate(self.slots):
            if req is None or req.status == PREFILLING:
                continue
            if (req.spec_ok and req.draft_pages
                    and req.ctx_len + 1 + k <= self.serve.max_context):
                spec_idx.append(i)
            else:
                plain_idx.append(i)
        for i in list(spec_idx):
            if not self._ensure_spec_span(self.slots[i]):
                # the whole span cannot be had: plain for this step only
                spec_idx.remove(i)
                plain_idx.append(i)
        if spec_idx:
            self._spec_round(spec_idx, k)
        if plain_idx:
            self._plain_decode_once(set(plain_idx))

    def _spec_round(self, idx: List[int], k: int) -> None:
        """One propose, verify, accept and roll back round for the slots
        ``idx``.  The verify runs the plain decode step's function, so an
        accepted token is the token plain decode would have produced; the
        rejected tail's KV (target and draft) is zeroed afterwards."""
        b = len(self.slots)
        np_ = self.serve.max_pages_per_seq
        tokens = np.zeros((b,), np.int64)
        lengths = np.zeros((b,), np.int32)
        temps = np.zeros((b,), np.float32)
        streams = np.zeros((b,), np.int64)
        gens = np.zeros((b,), np.int64)
        tables = np.full((b, np_), NULL_PAGE, np.int32)
        dtables = np.full((b, np_), NULL_PAGE, np.int32)
        for i in idx:
            req = self.slots[i]
            tokens[i] = req.tokens[-1]
            lengths[i] = req.ctx_len + 1  # context incl. the fed token
            temps[i] = req.temperature
            streams[i] = self._stream(req)
            gens[i] = len(req.tokens) - 1
            tables[i] = self._page_table_row(req)
            dtables[i, : len(req.draft_pages)] = req.draft_pages
        out, acc, finite = self.engine.spec_step(
            tokens, lengths, tables, dtables, temps, streams, gens)
        self.spec_rounds += 1
        rb_starts = np.zeros((b,), np.int32)
        rb_counts = np.zeros((b,), np.int32)
        drafted = accepted = emitted = slot_steps = 0
        for i in idx:
            req = self.slots[i]
            slot_steps += 1
            if not bool(finite[i]):
                # the target's own logits are not finite: the same
                # quarantine as a poisoned plain step
                self.slots[i] = None
                self._shed_request(req, SHED_POISONED)
                continue
            a = int(acc[i])
            drafted += k
            accepted += a
            start_ctx = req.ctx_len
            for t in out[i, : a + 1]:
                req.ctx_len += 1
                req.tokens.append(int(t))
                emitted += 1
                if self._finished(req):
                    break
            if self._finished(req):
                self.slots[i] = None
                self._retire(req, DONE)
            else:
                # the round wrote KV at [start_ctx, start_ctx + k]: what
                # lies past the new context is a rejected proposal's
                stale = start_ctx + k + 1 - req.ctx_len
                if stale > 0:
                    rb_starts[i] = req.ctx_len
                    rb_counts[i] = stale
        if rb_counts.any():
            self.engine.rollback(rb_starts, rb_counts, tables)
            self.engine.draft_rollback(rb_starts, rb_counts, dtables)
            self.spec_rollbacks += int((rb_counts > 0).sum())
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self._spec_window.append((drafted, accepted, emitted, slot_steps))
        if self._acceptance_collapsed():
            self._spec_fallback = True
            self.spec_fallbacks += 1

    def _acceptance_collapsed(self) -> bool:
        """True once the window is full and its acceptance rate (accepted
        over drafted proposals) is below the config's
        ``min_accept_rate``: speculation then costs more than it saves."""
        w = self._spec_window
        if len(w) < w.maxlen:
            return False
        drafted = sum(r[0] for r in w)
        accepted = sum(r[1] for r in w)
        return bool(drafted) and (
            accepted / drafted < self.engine.spec.min_accept_rate)

    # -- the iteration ----------------------------------------------------
    def step(self) -> None:
        """One continuous-batching iteration: admit into free slots
        (prefilling a request, or starting its chunked prefill), advance
        each chunked prefill by one chunk, then one decode pass over the
        running batch (spec rounds with a speculative engine)."""
        while self._admit_one():
            pass
        self._advance_prefills()
        self._decode_once()

    def run(self, max_steps: int = 10_000) -> None:
        """Step until every submitted request completed or was shed."""
        for _ in range(max_steps):
            if not self.pending:
                return
            self.step()
        raise RuntimeError(
            f"scheduler did not drain within {max_steps} iterations"
        )

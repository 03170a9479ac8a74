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
- a non-finite logits row sheds only its own request (``poisoned``).

:meth:`leak_check` (``PagePool.leak_check`` against the live ownership
ledger) runs after every retirement.  Retries, deadlines, the overload
ladder, drain, prefix caching, chunked prefill, speculative decoding,
metrics and spans are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Deque, List, Optional

import numpy as np

from apex_tpu_torch.serve.cache import NULL_PAGE

__all__ = [
    "Request",
    "ContinuousBatchingScheduler",
    "SHED_REASONS",
]

_ids = itertools.count()

QUEUED = "queued"
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
    """One greedy generation request and its lifecycle ledger."""

    prompt: List[int]
    max_new_tokens: int = 16
    eos_token: Optional[int] = None
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


class ContinuousBatchingScheduler:
    """Drive an :class:`~apex_tpu_torch.serve.engine.InferenceEngine`
    with continuous batching.

    >>> sched = ContinuousBatchingScheduler(engine)
    >>> sched.submit(Request(prompt=[...], max_new_tokens=32))
    >>> sched.run()
    """

    def __init__(self, engine, *, clock=time.monotonic):
        self.engine = engine
        self.pool = engine.pool
        self.serve = engine.serve
        self.clock = clock
        self.leak_checks_run = 0
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
        running slots."""
        return [r.pages for r in self.slots if r is not None and r.pages]

    def leak_check(self) -> None:
        """Assert ``PagePool`` accounting is exact against
        :meth:`owned_pages` (raises ``ValueError`` naming the pages)."""
        self.pool.leak_check(self.owned_pages())
        self.leak_checks_run += 1

    # -- admission --------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _admit_one(self) -> bool:
        """Try to move the queue head into a free slot and prefill it.
        Returns True when a request was admitted or shed (progress)."""
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
        pages = self.pool.alloc(self.pool.pages_for(len(req.prompt)))
        if pages is None:
            return False  # pool exhausted: the head waits
        self.queue.popleft()
        req.pages = pages
        _, first = self.engine.prefill(req.prompt, pages)
        if not self.engine.last_prefill_finite:
            self._shed_request(req, SHED_POISONED)
            return True
        return self._finish_prefill(req, slot, first)

    def _finish_prefill(self, req: Request, slot: int, first: int) -> bool:
        req.ctx_len = len(req.prompt)
        req.tokens.append(first)
        req.status = RUNNING
        self.slots[slot] = req
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
    def _ensure_growth_page(self, req: Request) -> bool:
        """The next append lands at position ``ctx_len``; allocate its
        page (one at a time) if the request does not hold it yet."""
        idx = req.ctx_len // self.serve.page_size
        while len(req.pages) <= idx:
            got = self.pool.alloc(1)
            if got is None:
                return False
            req.pages.extend(got)
        return True

    def _plain_decode_once(self) -> None:
        """One single-token decode iteration over every running slot."""
        b = len(self.slots)
        tokens = np.zeros((b,), np.int64)
        lengths = np.zeros((b,), np.int32)
        tables = np.full(
            (b, self.serve.max_pages_per_seq), NULL_PAGE, np.int32
        )
        for i, req in enumerate(self.slots):
            if req is None:
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
            tables[i] = self._page_table_row(req)
        if not lengths.any():
            return
        _, next_tokens = self.engine.decode(tokens, lengths, tables)
        finite = self.engine.last_decode_finite
        for i, req in enumerate(self.slots):
            if req is None:
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
        """One continuous-batching iteration: admit (prefill) into free
        slots, then one decode pass over the running batch."""
        while self._admit_one():
            pass
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

"""Continuous batching — admission, decode slots, SLOs, shedding, recovery.

Counterpart of ``apex_tpu/serve/scheduler.py``.  A decode iteration
costs nearly the same whether 1 or ``max_batch`` sequences ride it, so
:class:`ContinuousBatchingScheduler` admits new sequences into the
running batch at page granularity: a prefill slots in between decode
iterations, the new sequence joins the very next decode, and a finished
sequence frees its pages to the pool at once.

- a request is admitted when a decode slot is free AND the page pool
  covers its whole prompt (``PagePool.alloc`` is all-or-nothing);
  otherwise it waits at the queue head, and is shed (``deadline``) once
  its TTFT SLO has passed;
- a running sequence takes one growth page at a time; when the pool is
  empty, the youngest running request is shed (``growth_victim``) so the
  older ones keep making progress;
- with ``prefix_cache=True`` each admitted prompt probes a
  :class:`~apex_tpu_torch.serve.cache.PrefixCache` once and borrows the
  longest cached run of its pages; a shared page is forked
  (copy-on-write) before a request appends into it; an exhausted pool
  first evicts idle cached runs; with the cache or
  ``prefill_chunk_tokens`` a prefill advances one page-multiple chunk a
  step (a hit re-runs only its last chunk);
- each request samples at its own ``temperature`` (<= 0 is greedy), its
  noise keyed by its stream seed and generation index;
- with an engine that carries a
  :class:`~apex_tpu_torch.serve.spec.SpecConfig`, each request with a
  healthy draft rides a speculative round a step (the draft's pages in
  the ``"draft"`` namespace, never cached; the whole span a round may
  write forked before it); a faulted draft round (the ``serve.draft``
  chaos site) falls back to plain decode, and once the acceptance rate
  over the last ``window`` rounds falls below ``min_accept_rate`` every
  request decodes plain until :meth:`resume`.

**Failure is a scheduling input.**  Every shed carries a reason
(:data:`SHED_REASONS`, each with its ``serve/shed_<reason>`` counter):

- **bounded retries** — a prefill or decode fault, or a blown
  per-request decode timeout, sends the request to ``retrying`` with its
  pages and generated prefix kept; re-admission resumes decode from the
  last completed iteration (no re-prefill once the first token exists),
  at most ``max_retries`` times, then ``shed(retries_exhausted)``;
- **quarantine** — a non-finite logits row sheds only its own request
  (``poisoned``);
- **engine supervision** — a crashed decode step sends every running
  request to ``retrying`` (re-admitted the very next iteration on the
  incumbent graphs) and owes the engine a :meth:`~apex_tpu_torch.serve.
  engine.InferenceEngine.rebuild` (re-capture of its CUDA graphs) at the
  next idle point; a second fault before it ran rebuilds at once; past
  ``rebuild_limit`` the fault is raised;
- **the overload ladder** — (1) a bounded queue (``max_queue_depth``)
  rejects at submit, ``shed(queue_full)``; (2) past ``clamp_occupancy``
  pool pressure (or a queue past ``clamp_queue_depth``) admissions are
  clamped to ``clamp_max_new_tokens``; (3) the deadline rung;
- **graceful drain** (:meth:`drain`) — stop admitting, finish running
  and retrying decodes, shed the never-admitted queue as
  ``shed(draining)`` (or hand it to ``handoff``), and report the pool
  empty; :meth:`resume` leaves the drained state.

:meth:`leak_check` (``PagePool.leak_check`` against the live ownership
ledger, draft pages included, and the cache's pages) runs after every
shed and free path when ``leak_checks`` is on (the default).

Every iteration publishes the serving gauges and counters
(:func:`declare_serve_metrics`) through a
:class:`~apex_tpu_torch.observability.metrics.MetricRegistry` whose state
lives on the host: publishing adds no kernel launch and no copy to the
decode step.  Each completed request's TTFT splits into four components
that sum to it by construction (:data:`TTFT_COMPONENTS`): ``queue_wait``
(queued while admission was resource-blocked), ``cached_prefill`` (the
prefix cache's share after admission; 0.0 without the cache),
``prefill`` and ``contention`` (admissible but waiting for the decode
iterations of the running batch).  With a
:class:`~apex_tpu_torch.observability.spans.SpanRecorder` (``spans=``)
each request records its span chain ``queued → admitted → prefill →
decode[i] → retrying → done | shed(reason)``, and the engine its
prefill and decode spans.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
import zlib
from typing import Deque, Dict, List, Optional

import numpy as np

from apex_tpu_torch.observability.meter import percentile as _percentile
from apex_tpu_torch.observability.ometrics import (
    DEFAULT_LATENCY_BUCKETS_MS,
    Histogram,
)
from apex_tpu_torch.resilience import chaos
from apex_tpu_torch.serve.cache import NULL_PAGE, PrefixCache

__all__ = [
    "Request",
    "ContinuousBatchingScheduler",
    "declare_serve_metrics",
    "ttft_attribution",
    "SHED_REASONS",
    "SHED_REROUTED",
    "TTFT_COMPONENTS",
]

_ids = itertools.count()

QUEUED = "queued"
RUNNING = "running"
#: chunked prefill in flight: the request holds a decode slot (its pages
#: and position pinned) but rides no decode iteration until its last
#: chunk produced the first token
PREFILLING = "prefilling"
#: fault recovery: the request left the batch (or never reached it) and
#: waits at the queue front for bounded re-admission, its pages and
#: generated prefix kept
RETRYING = "retrying"
DONE = "done"
SHED = "shed"

#: shed reasons, each with its own ``serve/shed_<reason>`` counter:
#: ``deadline`` (queued past its TTFT SLO while the pool stayed
#: exhausted), ``growth_victim`` (youngest running request shed to free
#: a growth page), ``pool_exhausted`` (a running request could not grow
#: even after a victim shed), ``oversize`` (prompt exceeds the max
#: context), ``poisoned`` (non-finite logits row), ``queue_full``
#: (rejected at the bounded queue), ``retries_exhausted`` (a faulting
#: request used up its retries), ``draining`` (never-admitted work
#: rejected by a drain), ``rerouted`` (never-admitted work a drain's
#: ``handoff`` accepted — not terminal: it continues elsewhere)
SHED_DEADLINE = "deadline"
SHED_GROWTH_VICTIM = "growth_victim"
SHED_POOL_EXHAUSTED = "pool_exhausted"
SHED_OVERSIZE = "oversize"
SHED_POISONED = "poisoned"
SHED_QUEUE_FULL = "queue_full"
SHED_RETRIES_EXHAUSTED = "retries_exhausted"
SHED_DRAINING = "draining"
SHED_REROUTED = "rerouted"
SHED_REASONS = (
    SHED_DEADLINE, SHED_GROWTH_VICTIM, SHED_POOL_EXHAUSTED, SHED_OVERSIZE,
    SHED_POISONED, SHED_QUEUE_FULL, SHED_RETRIES_EXHAUSTED, SHED_DRAINING,
    SHED_REROUTED,
)

#: TTFT components (ms); they sum to the measured TTFT by construction.
#: ``cached_prefill`` is exactly 0.0 without the prefix cache.
TTFT_COMPONENTS = ("queue_wait", "cached_prefill", "prefill", "contention")


def ttft_attribution(comps) -> Dict[str, object]:
    """Aggregate per-request TTFT components (:meth:`Request.
    ttft_components` dicts) into per-component p50/p95/p99 and the
    queue-wait fraction: the one aggregation behind the scheduler's
    ``serve/ttft_*`` gauges and the drills' artifacts."""
    out: Dict[str, object] = {}
    for comp in TTFT_COMPONENTS:
        vals = sorted(c[f"{comp}_ms"] for c in comps)
        out[f"{comp}_ms"] = {
            tag: _percentile(vals, q)
            for q, tag in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99"))
        }
    total_ttft = sum(c["ttft_ms"] for c in comps)
    out["queue_wait_fraction"] = (
        sum(c["queue_wait_ms"] for c in comps) / total_ttft
        if total_ttft > 0 else 0.0
    )
    out["samples"] = len(comps)
    return out


#: default of ``ContinuousBatchingScheduler(registry=...)``: inherit the
#: engine's registry.  ``registry=None`` runs with no telemetry.
ENGINE_REGISTRY = object()


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle ledger."""

    prompt: List[int]
    max_new_tokens: int = 16
    #: TTFT SLO in milliseconds; None = best effort (never shed by
    #: deadline, only as a growth-page victim)
    slo_ttft_ms: Optional[float] = None
    eos_token: Optional[int] = None
    #: per-request decode timeout: a decode iteration this request rode
    #: that took longer discards the iteration's token for this request
    #: and sends it through bounded retry (prefix kept).  None inherits
    #: the scheduler's default
    decode_timeout_ms: Optional[float] = None
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
    submitted_at: Optional[float] = None
    #: popped from the queue with pages granted (prefill dispatch)
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    #: why this request was shed (one of :data:`SHED_REASONS`), else None
    shed_reason: Optional[str] = None
    #: seconds queued while admission was resource-blocked (the
    #: ``queue_wait`` TTFT component)
    queue_blocked_s: float = 0.0
    #: start of the current resource-blocked interval
    blocked_since: Optional[float] = None
    #: engine decode iterations this request rode (correlation ids into
    #: the ``serve/engine`` span track)
    first_decode_iter: Optional[int] = None
    last_decode_iter: Optional[int] = None
    #: retries used (bounded by the scheduler's ``max_retries``)
    retries: int = 0
    #: the original ``max_new_tokens`` when the overload ladder clamped
    #: it (None = never clamped)
    clamped_from: Optional[int] = None
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
    #: first engine prefill call of this request: splits the time after
    #: admission into ``cached_prefill`` and ``prefill`` (None without
    #: the cache: the component is 0.0)
    prefill_started_at: Optional[float] = None
    # -- speculative decoding (scheduler-owned) --------------------------
    #: the draft's KV pages (``"draft"`` pool namespace), mirroring
    #: :attr:`pages` position for position; freed on every retire path
    draft_pages: List[int] = dataclasses.field(default_factory=list)
    #: False once this request's draft state is unusable (its draft
    #: prefill failed): the stream decodes plain from then on
    spec_ok: bool = True

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.submitted_at is None or self.first_token_at is None:
            return None
        return 1e3 * (self.first_token_at - self.submitted_at)

    def ttft_components(self) -> Optional[Dict[str, float]]:
        """``{ttft_ms, queue_wait_ms, cached_prefill_ms, prefill_ms,
        contention_ms}``; the four components sum to ``ttft_ms`` by
        construction (contention is the remainder of the wait before
        admission)."""
        if (self.submitted_at is None or self.admitted_at is None
                or self.first_token_at is None):
            return None
        queue_wait = 1e3 * self.queue_blocked_s
        started = (self.prefill_started_at
                   if self.prefill_started_at is not None
                   else self.admitted_at)
        cached = (1e3 * (self.prefill_started_at - self.admitted_at)
                  if self.prefill_started_at is not None else 0.0)
        return {
            "ttft_ms": self.ttft_ms,
            "queue_wait_ms": queue_wait,
            "cached_prefill_ms": cached,
            "prefill_ms": 1e3 * (self.first_token_at - started),
            "contention_ms": (1e3 * (self.admitted_at - self.submitted_at)
                              - queue_wait),
        }


def declare_serve_metrics(registry) -> None:
    """Declare the serving metric set on a registry (idempotent)."""
    for g in ("serve/queue_depth", "serve/batch_fill",
              "serve/page_occupancy", "serve/tokens_per_s",
              "serve/ttft_ms", "serve/draining"):
        registry.gauge(g)
    for c in ("serve/admitted", "serve/completed", "serve/shed",
              "serve/tokens_out", "serve/prefills", "serve/decode_steps",
              # the failure and degradation ledger
              "serve/retries", "serve/readmitted", "serve/clamped",
              "serve/decode_timeouts", "serve/engine_faults",
              "serve/engine_rebuilds", "serve/admission_faults",
              "serve/kv_alloc_faults", "serve/drains",
              # the prefix cache's ledger
              "serve/prefix_hits", "serve/prefix_misses",
              "serve/prefix_hit_tokens", "serve/prefix_forks",
              "serve/prefix_commits", "serve/prefix_evictions",
              "serve/prefix_evict_faults",
              # speculative decoding's ledger
              "serve/spec_rounds", "serve/spec_drafted",
              "serve/spec_accepted", "serve/spec_rejected",
              "serve/spec_rollbacks", "serve/spec_fallbacks",
              "serve/draft_faults"):
        registry.counter(c)
    registry.gauge("serve/prefix_cached_pages")
    # windowed acceptance rate and emitted tokens per slot and round
    registry.gauge("serve/spec_accept_rate")
    registry.gauge("serve/spec_tokens_per_step")
    # per-reason shed breakdown (sums to serve/shed)
    for reason in SHED_REASONS:
        registry.counter(f"serve/shed_{reason}")
    # TTFT attribution over the recent completion window
    for comp in TTFT_COMPONENTS:
        for tag in ("p50", "p95", "p99"):
            registry.gauge(f"serve/ttft_{comp}_ms_{tag}", "ms")
    registry.gauge("serve/ttft_queue_wait_fraction")


class ContinuousBatchingScheduler:
    """Drive an :class:`~apex_tpu_torch.serve.engine.InferenceEngine`
    with continuous batching.

    >>> sched = ContinuousBatchingScheduler(engine, prefix_cache=True)
    >>> sched.submit(Request(prompt=[...], max_new_tokens=32))
    >>> sched.run()

    ``prefix_cache=True`` shares committed prompt pages across requests;
    ``prefill_chunk_tokens`` (a positive page multiple) runs prefill in
    chunks of that many tokens, one chunk a step.  ``spans`` attaches a
    :class:`~apex_tpu_torch.observability.spans.SpanRecorder`: the
    scheduler records each request's span chain and hands the recorder
    to the engine (taking over from a previous scheduler's), sharing a
    non-default ``clock`` with it so the record has one time basis.
    """

    def __init__(self, engine, *, registry=ENGINE_REGISTRY,
                 clock=time.monotonic, window: int = 32,
                 spans=None, attribution_window: int = 128,
                 max_queue_depth: Optional[int] = None,
                 max_retries: int = 2,
                 decode_timeout_ms: Optional[float] = None,
                 clamp_max_new_tokens: Optional[int] = None,
                 clamp_occupancy: float = 0.75,
                 clamp_queue_depth: Optional[int] = None,
                 rebuild_limit: int = 2,
                 leak_checks: bool = True,
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
        # failure and degradation knobs
        self.max_queue_depth = max_queue_depth
        self.max_retries = max_retries
        self.decode_timeout_ms = decode_timeout_ms
        self.clamp_max_new_tokens = clamp_max_new_tokens
        self.clamp_occupancy = clamp_occupancy
        self.clamp_queue_depth = clamp_queue_depth
        if clamp_queue_depth is None and max_queue_depth is not None:
            self.clamp_queue_depth = max(1, max_queue_depth // 2)
        self.rebuild_limit = rebuild_limit
        self.leak_checks = leak_checks
        self.draining = False
        self._drain_handoff = None
        self._drain_rerouted = 0
        self._rebuild_pending = False
        self._rebuilds_started = 0
        self._admissions = 0   # chaos index of the serve.admission site
        self._kv_allocs = 0    # chaos index of the serve.kv_alloc site
        self.leak_checks_run = 0
        #: copy-on-write forks of shared pages
        self.forks = 0
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * self.serve.max_batch
        self.completed: List[Request] = []
        self.shed: List[Request] = []
        self._step = 0
        # tokens/s over a sliding window of (time, cumulative tokens)
        self._tokens_out = 0
        self._window: Deque = collections.deque(maxlen=window)
        spec = engine.spec
        #: speculative decoding's counters (also on the registry): rounds,
        #: proposals drafted and accepted, rollbacks (slots with a rejected
        #: tail), fallbacks to plain decode, faulted draft calls
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
        self.registry = (
            engine.registry if registry is ENGINE_REGISTRY else registry
        )
        self.spans = spans
        # this scheduler owns the engine's recorder for its life (None
        # detaches a retired scheduler's recorder)
        engine.spans = spans
        if spans is not None and clock is not time.monotonic:
            # one time basis per recorder: the engine's spans read
            # rec.now(), the request ledger this clock
            spans.clock = clock
        # recent completions' TTFT components: the percentile window
        self._comps: Deque[Dict[str, float]] = collections.deque(
            maxlen=attribution_window
        )
        # the TTFT distribution an OpenMetrics scrape exposes
        self.ttft_hist = Histogram(
            "serve/ttft_hist_ms", DEFAULT_LATENCY_BUCKETS_MS, unit="ms",
            help="TTFT distribution over admitted requests",
        )
        self._published_done = 0
        # the iteration's counts and gauges, folded into the registry's
        # state in one update when the iteration publishes (what each
        # observe sees is what per-call updates would have made)
        self._counts: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._mstate = None
        if self.registry is not None:
            declare_serve_metrics(self.registry)
            self._mstate = self.registry.init()

    # -- bookkeeping ------------------------------------------------------
    @property
    def running(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def pending(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def batch_fill(self) -> float:
        return len(self.running) / len(self.slots)

    def submit(self, req: Request) -> Request:
        req.status = QUEUED
        now = self.clock()
        if req.submitted_at is None:
            # a re-routed request keeps its original submission time:
            # its TTFT and deadline count from the client's submit
            req.submitted_at = now
        if self.spans is not None:
            self.spans.request_event(
                req.rid, QUEUED, now,
                prompt_tokens=len(req.prompt),
                slo_ttft_ms=req.slo_ttft_ms,
            )
        # rung 1 — backpressure: a bounded queue rejects at the front
        # door; a draining scheduler rejects everything new the same way
        if self.draining:
            self._shed_request(req, SHED_DRAINING)
            return req
        if (self.max_queue_depth is not None
                and len(self.queue) >= self.max_queue_depth):
            self._shed_request(req, SHED_QUEUE_FULL)
            return req
        self.queue.append(req)
        return req

    def _page_table_row(self, req: Request) -> np.ndarray:
        row = np.full((self.serve.max_pages_per_seq,), NULL_PAGE, np.int32)
        row[: len(req.pages)] = req.pages
        return row

    def _close_blocked(self, req: Request, now: float) -> None:
        if req.blocked_since is not None:
            req.queue_blocked_s += now - req.blocked_since
            req.blocked_since = None

    def _span_terminal(self, req: Request, status: str,
                       reason: Optional[str]) -> None:
        rec = self.spans
        if rec is None:
            return
        args: Dict[str, object] = {}
        if status == DONE:
            args["tokens"] = len(req.tokens)
        else:
            args["reason"] = reason
            if req.submitted_at is not None and req.done_at is not None:
                args["waited_ms"] = 1e3 * (req.done_at - req.submitted_at)
        if req.first_decode_iter is not None:
            args["first_iter"] = req.first_decode_iter
            args["last_iter"] = req.last_decode_iter
        # a request retired straight out of prefill still carries its
        # TTFT attribution on its req/prefill span
        if rec.open_requests.get(req.rid) == "prefill":
            comps = req.ttft_components()
            if comps:
                args.update(comps)
        rec.request_event(req.rid, status, req.done_at, **args)

    def _free_pages(self, req: Request) -> None:
        if req.pages:
            # one reference each: a borrowed page survives its co-holders
            self.pool.free(req.pages)
            req.pages = []
        if req.draft_pages:
            self.pool.free(req.draft_pages)
            req.draft_pages = []

    def _retire(self, req: Request, status: str,
                reason: Optional[str] = None) -> None:
        self._free_pages(req)
        req.status = status
        req.shed_reason = reason if status == SHED else None
        req.done_at = self.clock()
        self._close_blocked(req, req.done_at)
        self._span_terminal(req, status, reason)
        if status == DONE:
            self.completed.append(req)
            comps = req.ttft_components()
            if comps is not None:
                self._comps.append(comps)
        else:
            self.shed.append(req)
        if self.leak_checks:
            # every shed and free path funnels through here: page
            # accounting is re-proven exact on each of them
            self.leak_check()

    def _shed_request(self, req: Request, reason: str) -> None:
        self._retire(req, SHED, reason)
        self._count("serve/shed")
        self._count(f"serve/shed_{reason}")

    def _reroute_request(self, req: Request, handoff) -> bool:
        """Offer a never-admitted request to a drain's ``handoff`` instead
        of shedding it.  Its pages are dropped first (they are this
        replica's); on acceptance it leaves this replica's ledger as
        ``shed(rerouted)`` on the counters but is not terminal (no span,
        no :attr:`shed` entry); on refusal the caller sheds it as
        ``draining``."""
        self._free_pages(req)
        if not handoff(req):
            return False
        self._count("serve/shed")
        self._count(f"serve/shed_{SHED_REROUTED}")
        if self.leak_checks:
            self.leak_check()
        return True

    # -- page accounting ---------------------------------------------------
    def owned_pages(self) -> List[List[int]]:
        """The live ownership ledger: per-request page lists (target and
        draft) of the slots and of queued requests that hold pages (a
        retrying request keeps its pages)."""
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
        KV), all or nothing, behind the ``serve.kv_alloc`` chaos site (a
        fault takes the failure path an exhausted pool takes).  An
        exhausted pool first evicts idle prefix-cache runs (LRU, never a
        borrowed page): cached history yields to live work."""
        idx = self._kv_allocs
        self._kv_allocs += 1
        if chaos.active(chaos.SERVE_KV_ALLOC, idx) is not None:
            self._count("serve/kv_alloc_faults")
            return None
        got = self.pool.alloc(n, ns=ns)
        if got is None and self.prefix is not None:
            freed = self.prefix.evict(need=n)
            if freed:
                self._count("serve/prefix_evictions", freed)
                if self.leak_checks:
                    self.leak_check()
                got = self.pool.alloc(n, ns=ns)
        return got

    def _stream(self, req: Request) -> int:
        """The request's sampling-stream id: its seed, or a hash of its
        id."""
        if req.stream_seed is not None:
            return req.stream_seed
        return zlib.crc32(str(req.rid).encode()) & 0x7FFFFFFF

    # -- fault recovery ----------------------------------------------------
    def _send_to_retry(self, req: Request, cause: str) -> None:
        """Bounded re-admission: the request keeps its pages and its
        generated prefix and re-enters at the queue front; past
        ``max_retries`` it is shed as ``retries_exhausted``."""
        if req.retries >= self.max_retries:
            self._shed_request(req, SHED_RETRIES_EXHAUSTED)
            return
        req.retries += 1
        req.status = RETRYING
        req.blocked_since = None
        self._count("serve/retries")
        if self.spans is not None:
            self.spans.request_event(
                req.rid, RETRYING, self.clock(),
                cause=cause, attempt=req.retries,
            )
        self.queue.appendleft(req)
        if self.leak_checks:
            self.leak_check()

    def _on_engine_fault(self, error: BaseException) -> None:
        """Supervise a decode fault: every running request goes to
        ``retrying`` (re-admitted the next iteration, on the incumbent
        graphs) and a rebuild is owed at the next idle point; a second
        fault before it ran rebuilds at once.  Past ``rebuild_limit`` the
        fault is raised: a persistently crashing engine must not loop."""
        self._count("serve/engine_faults")
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.slots[i] = None
            self._send_to_retry(req, f"engine:{type(error).__name__}")
        if self._rebuilds_started >= self.rebuild_limit:
            raise RuntimeError(
                f"engine fault after {self._rebuilds_started} supervised "
                f"rebuilds (rebuild_limit={self.rebuild_limit})"
            ) from error
        if self._rebuild_pending:
            self._run_rebuild()  # repeat fault: rebuild before retrying
        else:
            self._rebuild_pending = True

    def _run_rebuild(self) -> None:
        self._rebuild_pending = False
        self._rebuilds_started += 1
        self._count("serve/engine_rebuilds")
        try:
            self.engine.rebuild()
        except BaseException as e:
            raise RuntimeError("supervised engine rebuild failed") from e

    def flush_rebuild(self) -> bool:
        """Run a deferred engine rebuild now if one is owed (the idle
        point, or a drain); True when a rebuild ran."""
        if not self._rebuild_pending:
            return False
        self._run_rebuild()
        return True

    # -- admission --------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _overloaded(self) -> bool:
        """Rung 2's trigger: pool pressure past ``clamp_occupancy`` or a
        bounded queue past ``clamp_queue_depth``."""
        if self.pool.occupancy() >= self.clamp_occupancy:
            return True
        return (self.clamp_queue_depth is not None
                and len(self.queue) >= self.clamp_queue_depth)

    def _readmit(self, req: Request, slot: int) -> bool:
        """Re-admit a retrying request that already has its first token:
        its pages and prefix were kept, so it drops straight back into a
        decode slot and resumes where it left off (no re-prefill, no
        change to its TTFT)."""
        now = self.clock()
        req.status = RUNNING
        req.blocked_since = None
        self.slots[slot] = req
        self._count("serve/readmitted")
        if self.spans is not None:
            self.spans.request_event(
                req.rid, "decode", now, resumed=True, attempt=req.retries,
            )
        return True

    def _deadline_blown(self, req: Request) -> bool:
        return (req.slo_ttft_ms is not None
                and 1e3 * (self.clock() - req.submitted_at) > req.slo_ttft_ms)

    def _admit_one(self) -> bool:
        """Try to move the queue head into a free slot (prefill now, or
        straight back to decode for a retrying request).  Returns True
        when a request was admitted or shed (progress)."""
        if not self.queue:
            return False
        slot = self._free_slot()
        if slot is None:
            return False
        # the serve.admission site: a fault leaves the head queued (tried
        # again next iteration)
        idx = self._admissions
        self._admissions += 1
        try:
            chaos.maybe_fail(chaos.SERVE_ADMISSION, idx)
        except chaos.InjectedFault:
            self._count("serve/admission_faults")
            return False
        req = self.queue[0]
        if self.draining and req.status != RETRYING:
            # a drain admits nothing new; retrying work may finish
            self.queue.popleft()
            if self._drain_handoff is not None and self._reroute_request(
                req, self._drain_handoff
            ):
                self._drain_rerouted += 1
            else:
                self._shed_request(req, SHED_DRAINING)
            return True
        if req.status == RETRYING and req.first_token_at is not None:
            self.queue.popleft()
            return self._readmit(req, slot)
        if len(req.prompt) > self.serve.max_context:
            self.queue.popleft()
            self._shed_request(req, SHED_OVERSIZE)
            return True
        need = self.pool.pages_for(len(req.prompt))
        if (self.prefix is not None and not req.cache_probed
                and req.first_token_at is None):
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
                self._count("serve/prefix_hits")
                self._count("serve/prefix_hit_tokens", hit_tokens)
            else:
                self._count("serve/prefix_misses")
        if len(req.pages) < need:
            grown = self._alloc(need - len(req.pages))
            if grown is None:
                # pool exhausted: shed only once the TTFT budget is blown
                if self._deadline_blown(req):
                    self.queue.popleft()
                    self._shed_request(req, SHED_DEADLINE)
                    return True
                return False
            req.pages = req.pages + grown
        if self.engine.spec is not None and req.spec_ok:
            # the draft mirrors the prompt's page span in its own
            # namespace, all or nothing, with the target's wait and shed
            # rules (its target pages stay on the ledger while it waits)
            dneed = need - len(req.draft_pages)
            if dneed > 0:
                dgot = self._alloc(dneed, ns="draft")
                if dgot is None:
                    if self._deadline_blown(req):
                        self.queue.popleft()
                        self._shed_request(req, SHED_DEADLINE)
                        return True
                    return False
                req.draft_pages.extend(dgot)
        # rung 2 — clamp the token budget while overloaded: admit more
        # requests shallower instead of fewer deeper
        if (self.clamp_max_new_tokens is not None
                and req.max_new_tokens > self.clamp_max_new_tokens
                and self._overloaded()):
            req.clamped_from = req.max_new_tokens
            req.max_new_tokens = self.clamp_max_new_tokens
            self._count("serve/clamped")
            if self.spans is not None:
                self.spans.instant(
                    "req/clamped", self.clock(), track="serve/requests",
                    lane=req.rid, max_new_tokens=req.max_new_tokens,
                    clamped_from=req.clamped_from,
                )
        self.queue.popleft()
        now = self.clock()
        self._close_blocked(req, now)
        req.admitted_at = now
        if self.spans is not None:
            self.spans.request_event(
                req.rid, "prefill", now,
                bucket=self.engine.bucket_for(len(req.prompt)),
                prompt_tokens=len(req.prompt), pages=len(req.pages),
                **({"cached_tokens": req.cache_hit_tokens}
                   if req.cache_hit_tokens else {}),
                **({"attempt": req.retries} if req.retries else {}),
            )
        if self.prefix is not None or self.prefill_chunk_tokens is not None:
            return self._start_chunked_prefill(req, slot)
        try:
            _, first = self.engine.prefill(
                req.prompt, req.pages, temperature=req.temperature,
                stream=self._stream(req),
            )
        except Exception as e:  # noqa: BLE001 — counted, bounded retry
            # the request keeps its pages and re-enters through bounded
            # retry (they hold nothing trusted yet: the retry prefills
            # them again)
            self._count("serve/engine_faults")
            self._send_to_retry(req, f"prefill:{type(e).__name__}")
            return True
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
        if self.prefix is not None:
            req.prefill_started_at = self.clock()
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
        try:
            _, first = self.engine.chunk_prefill(
                req.prompt[start:end], start, req.pages, chunk_pages,
                temperature=req.temperature, stream=self._stream(req),
            )
        except Exception as e:  # noqa: BLE001 — counted, bounded retry
            self._count("serve/engine_faults")
            self.slots[slot] = None
            self._send_to_retry(req, f"prefill:{type(e).__name__}")
            return
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
        req.first_token_at = self.clock()
        req.status = RUNNING
        self.slots[slot] = req
        self._tokens_out += 1
        self._count("serve/admitted")
        self._count("serve/prefills")
        self._count("serve/tokens_out")
        self._gauge("serve/ttft_ms", req.ttft_ms)
        self.ttft_hist.observe(req.ttft_ms)
        if self.prefix is not None:
            added = self.prefix.commit(
                req.prompt, req.pages[: self.pool.pages_for(len(req.prompt))]
            )
            if added:
                self._count("serve/prefix_commits", added)
        if self.engine.spec is not None and req.spec_ok:
            # the draft's KV over the prompt, so proposals start from the
            # context the target sees.  A failed draft prefill demotes the
            # request to plain decode: the draft is an accelerator, never
            # a dependency of the stream
            try:
                self.engine.draft_prefill(req.prompt, req.draft_pages)
            except Exception:  # noqa: BLE001 — counted, stream goes plain
                self.draft_faults += 1
                self._count("serve/draft_faults")
                req.spec_ok = False
        if self._finished(req):
            self.slots[slot] = None
            self._retire(req, DONE)
            self._count("serve/completed")
        elif self.spans is not None:
            # entering decode: the closing event carries the TTFT
            # attribution onto the req/prefill span
            self.spans.request_event(
                req.rid, "decode", req.first_token_at,
                **(req.ttft_components() or {}),
            )
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
                self._count("serve/prefix_forks")
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

    def _timeout_ms(self, req: Request) -> Optional[float]:
        return (req.decode_timeout_ms if req.decode_timeout_ms is not None
                else self.decode_timeout_ms)

    def _timed_out(self, req: Request, slot: int, elapsed_ms: float) -> bool:
        """A decode call this request rode took longer than its timeout:
        its token from the suspect step is discarded (the KV append is
        positionally idempotent, so the retried decode rewrites the same
        row) and it goes through bounded retry, prefix kept."""
        timeout_ms = self._timeout_ms(req)
        if timeout_ms is None or elapsed_ms <= timeout_ms:
            return False
        self._count("serve/decode_timeouts")
        self.slots[slot] = None
        self._send_to_retry(req, f"decode_timeout:{elapsed_ms:.0f}ms")
        return True

    def _mark_iter(self, req: Request, it: int) -> None:
        if req.first_decode_iter is None:
            req.first_decode_iter = it
        req.last_decode_iter = it

    def _plain_decode_once(self, only: Optional[set] = None) -> None:
        """One single-token decode iteration over every running slot, or
        over the slot indices in ``only`` (the plain side of a mixed
        batch); prefilling slots advance by chunks instead.  The decode
        call's time, measured up to its readback (which waits for the
        card), is what the per-request timeouts judge."""
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
                    self.running, key=lambda r: r.submitted_at or 0.0
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
        t0 = self.clock()
        try:
            _, next_tokens = self.engine.decode(
                tokens, lengths, tables, temps, streams=streams, gens=gens)
        except Exception as e:  # noqa: BLE001 — supervised, bounded
            # a crashed decode step produced nothing: every rider keeps
            # its prefix and pages and re-enters through bounded retry
            # while the engine rebuilds under supervision
            self._on_engine_fault(e)
            return
        elapsed_ms = 1e3 * (self.clock() - t0)
        finite = self.engine.last_decode_finite
        self._count("serve/decode_steps")
        it = self.engine.decode_iters
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
            if self._timed_out(req, i, elapsed_ms):
                continue
            self._mark_iter(req, it)
            req.ctx_len += 1
            req.tokens.append(int(next_tokens[i]))
            self._tokens_out += 1
            self._count("serve/tokens_out")
            if self._finished(req):
                self.slots[i] = None
                self._retire(req, DONE)
                self._count("serve/completed")

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
        t0 = self.clock()
        try:
            out, acc, finite = self.engine.spec_step(
                tokens, lengths, tables, dtables, temps, streams, gens)
        except chaos.InjectedFault as e:
            if e.site == chaos.SERVE_DRAFT:
                # a faulted draft never corrupts a stream: the round was
                # abandoned before any write, and every rider decodes
                # plain this iteration
                self.draft_faults += 1
                self._count("serve/draft_faults")
                self._plain_decode_once(set(idx))
                return
            self._on_engine_fault(e)
            return
        except Exception as e:  # noqa: BLE001 — supervised, bounded
            self._on_engine_fault(e)
            return
        elapsed_ms = 1e3 * (self.clock() - t0)
        self.spec_rounds += 1
        self._count("serve/decode_steps")
        self._count("serve/spec_rounds")
        it = self.engine.decode_iters
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
            if self._timed_out(req, i, elapsed_ms):
                continue
            self._mark_iter(req, it)
            a = int(acc[i])
            drafted += k
            accepted += a
            start_ctx = req.ctx_len
            n_emit = 0
            for t in out[i, : a + 1]:
                req.ctx_len += 1
                req.tokens.append(int(t))
                n_emit += 1
                self._tokens_out += 1
                if self._finished(req):
                    break
            emitted += n_emit
            self._count("serve/tokens_out", n_emit)
            if self._finished(req):
                self.slots[i] = None
                self._retire(req, DONE)
                self._count("serve/completed")
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
            n_rb = int((rb_counts > 0).sum())
            self.spec_rollbacks += n_rb
            self._count("serve/spec_rollbacks", n_rb)
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self._count("serve/spec_drafted", drafted)
        self._count("serve/spec_accepted", accepted)
        if drafted > accepted:
            self._count("serve/spec_rejected", drafted - accepted)
        self._spec_window.append((drafted, accepted, emitted, slot_steps))
        if self._acceptance_collapsed():
            # speculation costs more than it saves: plain decode until an
            # operator's resume() re-arms it
            self._spec_fallback = True
            self.spec_fallbacks += 1
            self._count("serve/spec_fallbacks")

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

    # -- metrics ----------------------------------------------------------
    def _count(self, name: str, n: float = 1.0) -> None:
        if self._mstate is not None:
            self._counts[name] = self._counts.get(name, 0.0) + n

    def _gauge(self, name: str, value) -> None:
        if self._mstate is not None and value is not None:
            self._gauges[name] = float(value)

    def _publish_attribution(self) -> None:
        """Percentile gauges over the recent completion window: one
        update, recomputed only when completions arrived since the last
        publish."""
        if (self._mstate is None or not self._comps
                or len(self.completed) == self._published_done):
            return
        self._published_done = len(self.completed)
        attr = ttft_attribution(self._comps)
        updates: Dict[str, float] = {}
        for comp in TTFT_COMPONENTS:
            for tag, value in attr[f"{comp}_ms"].items():
                updates[f"serve/ttft_{comp}_ms_{tag}"] = value
        updates["serve/ttft_queue_wait_fraction"] = attr[
            "queue_wait_fraction"]
        self._gauges.update(updates)

    def _publish(self) -> None:
        """The iteration's gauges, its counts and gauges folded into the
        registry's state in one update, then one ``observe`` (host values
        into a host-resident state: no launch, no copy)."""
        now = self.clock()
        self._window.append((now, self._tokens_out))
        tps = 0.0
        if len(self._window) >= 2:
            (t0, n0), (t1, n1) = self._window[0], self._window[-1]
            if t1 > t0:
                tps = (n1 - n0) / (t1 - t0)
        self._gauge("serve/queue_depth", len(self.queue))
        self._gauge("serve/batch_fill", self.batch_fill())
        self._gauge("serve/page_occupancy", self.pool.occupancy())
        self._gauge("serve/tokens_per_s", tps)
        if self.prefix is not None:
            self._gauge("serve/prefix_cached_pages",
                        float(len(self.prefix.cached_pages())))
        if self._spec_window:
            tot_d = sum(w[0] for w in self._spec_window)
            tot_a = sum(w[1] for w in self._spec_window)
            tot_e = sum(w[2] for w in self._spec_window)
            tot_s = sum(w[3] for w in self._spec_window)
            self._gauge("serve/spec_accept_rate",
                        tot_a / tot_d if tot_d else 0.0)
            self._gauge("serve/spec_tokens_per_step",
                        tot_e / tot_s if tot_s else 0.0)
        self._publish_attribution()
        if self._mstate is not None:
            self.registry.update(self._mstate,
                                 {**self._counts, **self._gauges})
            self._counts.clear()
            self._gauges.clear()
            self.registry.observe(self._step, self._mstate)

    # -- the iteration ----------------------------------------------------
    def step(self) -> None:
        """One continuous-batching iteration: admit into free slots
        (prefilling a request, or starting its chunked prefill), advance
        each chunked prefill by one chunk, then one decode pass over the
        running batch (spec rounds with a speculative engine)."""
        while self._admit_one():
            pass
        if self.queue:
            # admission gave up with requests queued: they are
            # resource-blocked from here to the next attempt (the
            # queue_wait component).  Only requests before their first
            # token accrue it: a retrying request's wait is recovery
            now = self.clock()
            for r in self.queue:
                if r.first_token_at is None and r.blocked_since is None:
                    r.blocked_since = now
        if self.prefix is not None and chaos.active(
            chaos.SERVE_PREFIX_EVICT, self._step
        ) is not None:
            # forced full eviction sweep (the serve.prefix_evict site):
            # borrowed pages survive, and the ledger stays exact
            self._count("serve/prefix_evict_faults")
            freed = self.prefix.evict()
            if freed:
                self._count("serve/prefix_evictions", freed)
            if self.leak_checks:
                self.leak_check()
        self._advance_prefills()
        self._decode_once()
        self._step += 1
        self._publish()
        if self._rebuild_pending and not self.pending:
            # the idle point of a caller-driven step() loop: run the owed
            # rebuild now, off the traffic path
            self.flush_rebuild()

    def run(self, max_steps: int = 10_000) -> None:
        """Step until every submitted request completed or was shed; a
        rebuild owed from the run runs at the idle exit."""
        for _ in range(max_steps):
            if not self.pending:
                self.flush_rebuild()
                return
            self.step()
        raise RuntimeError(
            f"scheduler did not drain within {max_steps} iterations"
        )

    def drain(self, max_steps: int = 10_000, *,
              handoff=None) -> Dict[str, object]:
        """Graceful drain for a rolling restart: stop admitting new work,
        let running decodes and retrying re-admissions finish, then
        report the drained state with the page pool proven empty.  The
        scheduler stays drained (new submissions are shed as
        ``draining``) until :meth:`resume`.  ``handoff`` — a
        ``callable(Request) -> bool`` — is offered each never-admitted
        request first (``shed(rerouted)`` when it accepts)."""
        self.start_drain(handoff=handoff)
        for _ in range(max_steps):
            if not self.pending:
                break
            self.step()
        else:
            raise RuntimeError(
                f"drain did not complete within {max_steps} iterations"
            )
        return self.finish_drain()

    def start_drain(self, *, handoff=None) -> int:
        """Enter the draining state (the first half of :meth:`drain`):
        hand never-admitted requests to ``handoff`` (or shed them as
        ``draining``) and keep retrying work.  Returns the re-routed
        count; call :meth:`finish_drain` once :attr:`pending` clears."""
        self.draining = True
        self._drain_handoff = handoff
        self._count("serve/drains")
        self._gauge("serve/draining", 1.0)
        kept = [r for r in self.queue if r.status == RETRYING]
        rejected = [r for r in self.queue if r.status != RETRYING]
        self.queue = collections.deque(kept)
        rerouted = 0
        for req in rejected:
            if handoff is not None and self._reroute_request(req, handoff):
                rerouted += 1
            else:
                self._shed_request(req, SHED_DRAINING)
        self._drain_rerouted = rerouted
        return rerouted

    def finish_drain(self) -> Dict[str, object]:
        """Seal a drain: run any owed rebuild, release the prefix cache's
        pages, re-prove the pool empty and report."""
        self._drain_handoff = None
        self.flush_rebuild()
        if self.prefix is not None:
            self.prefix.flush()
        self.leak_check()
        self._publish()
        return {
            "drained": True,
            "completed": len(self.completed),
            "shed": len(self.shed),
            "rerouted": self._drain_rerouted,
            "pool_in_use": self.pool.in_use,
            "engine_rebuilds": self.engine.rebuilds,
            "leak_checks_run": self.leak_checks_run,
        }

    def resume(self) -> None:
        """Leave the drained state: submissions are accepted again, the
        ``serve/draining`` gauge clears, and speculation is re-armed (the
        acceptance fallback and its window reset)."""
        self.draining = False
        self._gauge("serve/draining", 0.0)
        self._spec_fallback = False
        if self._spec_window is not None:
            self._spec_window.clear()

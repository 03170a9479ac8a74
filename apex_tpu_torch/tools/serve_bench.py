"""Closed-loop serving load generator — latency distribution, goodput,
and the serving acceptance artifact.

Counterpart of ``tools/serve_bench.py``.  Drives a real
:class:`apex_tpu_torch.serve.InferenceEngine` +
:class:`~apex_tpu_torch.serve.ContinuousBatchingScheduler` with
**Poisson arrivals** and a configurable prompt/output length mix, then
reports what a production operator would page on:

- the TTFT and per-output-token latency distributions (p50/p95/p99,
  rendered as a text histogram);
- goodput under shedding: completed / offered requests and tokens, with
  the shed count broken out by reason;
- the continuous-batching proof: mean/peak batch fill vs the
  single-request baseline (a scheduler that never admits mid-stream
  would sit at the baseline);
- the numerics proof: paged **int8-KV** decode logits vs the unpaged
  f32 forward (the port's :class:`~apex_tpu_torch.models.GptModel` and
  its tied logits) within the pinned tolerance, and the same check on
  f32 pages;
- the build checks: the ERROR counts of the engine's reports
  (``ServeConfig(verify=True)``: every prefill bucket and the decode
  step recorded at build and linted; zero required).

The model is an f32 GPT of the flags' widths with seeded random weights,
served on ``--device`` (the card by default; ``--device cpu`` runs the
plain versions).  Everything the engine needs is built (every prefill
bucket warmed, the decode step and the spec round captured as CUDA
graphs on the card) before the first arrival, so no TTFT measures a
build.  The Poisson arrivals, the length mix and the prompts are drawn
by numpy from ``--seed`` exactly as the reference tool draws them.

``--json FILE`` writes everything as one artifact (the reference's
keys): the per-reason shed breakdown, the TTFT queue-wait / prefill /
contention attribution percentiles and the process wall-clock anchor.
``--spans FILE`` records every request's span chain (``queued ->
admitted -> prefill -> decode[i] -> done|shed``) through a
:class:`~apex_tpu_torch.observability.spans.SpanRecorder`; feed it to
``python -m apex_tpu_torch.tools.timeline``.

The live ops plane:

- ``--ops-port PORT`` (or ``APEX_TPU_OPS_PORT``; 0 = OS-assigned)
  serves OpenMetrics at ``/metrics`` on 127.0.0.1 while the load runs;
  one scrape is taken over HTTP mid-run and one after the final registry
  drain, both in the artifact;
- with ``--slo-ttft-ms`` a health
  :class:`~apex_tpu_torch.observability.health.Watchdog` evaluates the
  serving SLO set with multi-window burn-rate alerting on every
  scheduler iteration (windows scaled by ``--slo-burn-short/-long``);
- live device-memory watermarks are sampled every iteration (the
  caching allocator's statistics on the card; on the CPU a fake provider
  seeded from the engine's own static peak estimates, scaled by
  ``--memstats-fake-scale``) and reconciled against the static estimates
  at the end: drift past ``--memstats-tolerance`` is reported, naming
  the program, and does not fail the run.

With ``--speculate K`` the run decodes speculatively (optionally with a
``--draft-layers N`` truncated draft) and the artifact grows a ``spec``
section: acceptance rate, tokens per decode step, per-request decode
steps saved, and the bit-identity replay against plain decode.

Two flags beyond the reference's: ``--device`` (cuda or cpu) and
``--intermediate`` (the FFN width, ``2 * --hidden`` by default as in the
reference), so that a card run can take ``GptConfig()``'s FFN of 4096.

Usage::

    python -m apex_tpu_torch.tools.serve_bench --device cpu
    python -m apex_tpu_torch.tools.serve_bench --requests 32 --rate 50 \\
        --json out.json
    python -m apex_tpu_torch.tools.serve_bench --speculate 4 --json out.json
    python -m apex_tpu_torch.tools.serve_bench --ops-port 9400 \\
        --slo-ttft-ms 250

Exit code: 0 when every gate holds, 1 otherwise (each failure printed to
stderr as ``FAIL <message>``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# the one nearest-rank implementation the scheduler's gauges use too
from apex_tpu_torch.observability.meter import percentile as _percentile

#: pinned acceptance tolerances on last-position logits vs the unpaged
#: f32 forward (the reference's numbers)
TOL_F32 = 2e-4
TOL_INT8_KV = 5e-2

#: the max_seq_len of the tool's model (the reference's)
MAX_SEQ_LEN = 1024


def _histogram(vals, width=40, bins=10):
    if not vals:
        return "  (no samples)"
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    counts = [0] * bins
    for v in vals:
        counts[min(bins - 1, int((v - lo) / span * bins))] += 1
    peak = max(counts)
    lines = []
    for i, c in enumerate(counts):
        b0 = lo + span * i / bins
        b1 = lo + span * (i + 1) / bins
        bar = "#" * int(width * c / peak)
        lines.append(f"  {b0:9.2f}-{b1:9.2f} ms |{bar:<{width}}| {c}")
    return "\n".join(lines)


def model_config(args):
    """The tool's ``GptConfig``: the flags' widths in f32."""
    from apex_tpu_torch.models import GptConfig

    return GptConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        num_layers=args.layers, num_heads=args.heads,
        intermediate_size=args.intermediate or 2 * args.hidden,
        max_seq_len=MAX_SEQ_LEN, dtype=torch.float32,
    )


def build_engine(args, model=None):
    """``(cfg, model, engine, registry)``: the f32 GPT (seeded random
    weights, or ``model`` when given) behind an engine built with the
    build checks on — every prefill bucket (and with the prefix cache or
    chunks every chunk bucket, with a draft the draft's prefill) run and
    linted, the decode step (and the spec round) captured on the card."""
    from apex_tpu_torch.models import GptModel
    from apex_tpu_torch.observability import MetricRegistry
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    cfg = model_config(args)
    serve_cfg = ServeConfig(
        page_size=args.page_size, num_pages=args.pages,
        max_batch=args.batch, max_pages_per_seq=args.pages_per_seq,
        kv_wire=args.kv_wire, weight_wire=args.weight_wire,
        verify=True,
    )
    if model is None:
        gen = torch.Generator(args.device).manual_seed(1)
        model = GptModel(cfg, device=args.device, generator=gen)
    registry = MetricRegistry(fetch_every=1)
    spec = None
    if args.speculate:
        from apex_tpu_torch.serve import SpecConfig, draft_from_params

        if args.draft_layers:
            # truncated draft: the target's first N layers (embeddings
            # and final norm shared)
            spec = SpecConfig(draft_from_params(model, args.draft_layers),
                              k=args.speculate)
        else:
            # self-draft: 100% greedy acceptance, the upper bound
            spec = SpecConfig(None, k=args.speculate)
    engine = InferenceEngine(
        cfg, model, serve_cfg, spec=spec, registry=registry,
        device=args.device,
    ).build(chunked=bool(args.prefix_cache or args.chunk_tokens))
    return cfg, model, engine, registry


@torch.no_grad()
def numerics_check(cfg, model, args):
    """Paged decode logits (f32 pages AND int8-KV pages) vs the unpaged
    f32 forward of ``model``, on one greedy continuation."""
    from apex_tpu_torch.models.gpt import tied_logits
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    rs = np.random.RandomState(7)
    prompt = [int(t) for t in rs.randint(0, cfg.vocab_size, size=24)]
    steps = 6
    out = {}
    for wire, tol in (("f32", TOL_F32), ("int8", TOL_INT8_KV)):
        eng = InferenceEngine(
            cfg, model,
            ServeConfig(
                page_size=args.page_size, num_pages=args.pages,
                max_batch=2, max_pages_per_seq=args.pages_per_seq,
                kv_wire=wire, verify=False,
            ),
            device=model.device,
        )
        pages = eng.pool.alloc(eng.pool.pages_for(len(prompt)))
        _, tok = eng.prefill(prompt, pages)
        cur = list(prompt)
        ctx = len(prompt)
        worst = 0.0
        table = np.zeros((2, args.pages_per_seq), np.int32)
        for _ in range(steps):
            if ctx // args.page_size >= len(pages):
                got = eng.pool.alloc(1)
                if got is None:
                    raise RuntimeError(
                        "numerics check: page pool exhausted — raise "
                        "--pages"
                    )
                pages += got
            table[0, : len(pages)] = pages
            logits, nxt = eng.decode(
                np.array([tok, 0]), np.array([ctx + 1, 0]), table
            )
            cur.append(tok)
            ids = torch.tensor(cur, dtype=torch.int64,
                               device=model.device)[:, None]
            ref = tied_logits(model, model(ids), cfg.dtype)
            worst = max(
                worst,
                float((logits[0].float() - ref[-1, 0].float()).abs().max()),
            )
            ctx += 1
            tok = int(nxt[0])
        out[wire] = {
            "max_abs_logit_diff": worst,
            "tolerance": tol,
            "ok": worst <= tol,
        }
        del eng
    return out


def http_scrape(url, timeout=5.0):
    """One HTTP GET of the ops endpoint: ``{ok, ms, bytes, status}``
    (+ ``text`` on success, ``error`` on failure)."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            body = resp.read().decode("utf-8")
            return {
                "ok": True,
                "status": resp.status,
                "ms": 1e3 * (time.perf_counter() - t0),
                "bytes": len(body),
                "content_type": resp.headers.get("Content-Type", ""),
                "text": body,
            }
    except (urllib.error.URLError, OSError) as e:
        return {
            "ok": False,
            "ms": 1e3 * (time.perf_counter() - t0),
            "error": f"{type(e).__name__}: {e}",
        }


def run_load(sched, args, *, watchdog=None, monitor=None, ops=None):
    from apex_tpu_torch.serve import Request, ttft_attribution

    rs = np.random.RandomState(args.seed)

    # Poisson arrivals: exponential inter-arrival gaps at --rate req/s,
    # pre-drawn so the run is deterministic under --seed
    gaps = rs.exponential(1.0 / args.rate, size=args.requests)
    arrivals = np.cumsum(gaps)
    prompt_lens = rs.choice(args.prompt_mix, size=args.requests)
    out_lens = rs.choice(args.output_mix, size=args.requests)
    # shared-prefix workload (the prefix-cache proof): --shared-frac of
    # the requests open with the SAME --shared-prefix-tokens system
    # prompt; drawn after the base workload, as the reference draws it
    shared_prefix = None
    shared_mask = np.zeros(args.requests, bool)
    if args.shared_prefix_tokens:
        shared_prefix = list(rs.randint(
            0, args.vocab, size=args.shared_prefix_tokens
        ))
        shared_mask = rs.rand(args.requests) < args.shared_frac
        prompt_lens = np.maximum(
            prompt_lens, args.shared_prefix_tokens + 1
        )

    def make_prompt(i):
        n = int(prompt_lens[i])
        if shared_prefix is not None and shared_mask[i]:
            tail = list(rs.randint(0, args.vocab,
                                   size=n - len(shared_prefix)))
            return [int(t) for t in list(shared_prefix) + tail]
        return [int(t) for t in rs.randint(0, args.vocab, size=n)]

    submitted_reqs = []
    t0 = time.monotonic()
    submitted = 0
    iteration = 0
    fills = []
    occupancy = []
    mid_scrape = None
    while submitted < args.requests or sched.pending:
        now = time.monotonic() - t0
        while submitted < args.requests and arrivals[submitted] <= now:
            req = sched.submit(Request(
                prompt=make_prompt(submitted),
                max_new_tokens=int(out_lens[submitted]),
                slo_ttft_ms=args.slo_ttft_ms,
            ))
            submitted_reqs.append(req)
            submitted += 1
        if sched.pending:
            sched.step()
            iteration += 1
            fills.append(sched.batch_fill())
            occupancy.append(sched.pool.occupancy())
            if monitor is not None:
                monitor.sample(iteration)
            if watchdog is not None:
                watchdog.on_step(iteration)
            if (
                ops is not None
                and mid_scrape is None
                and submitted * 2 >= args.requests
            ):
                # the scrape-under-load proof: a real HTTP GET against
                # the endpoint while the scheduler is mid-traffic
                mid_scrape = http_scrape(ops.url)
                mid_scrape.pop("text", None)  # the end-of-run one is kept
        elif submitted < args.requests:
            time.sleep(min(0.002, arrivals[submitted] - now))
    wall = time.monotonic() - t0

    done = sched.completed
    shed = sched.shed
    ttfts = sorted(r.ttft_ms for r in done if r.ttft_ms is not None)
    per_tok = []
    for r in done:
        n_decode = len(r.tokens) - 1
        if n_decode > 0 and r.done_at and r.first_token_at:
            per_tok.append(
                1e3 * (r.done_at - r.first_token_at) / n_decode
            )
    per_tok.sort()
    tokens_done = sum(len(r.tokens) for r in done)
    # offered output tokens across ALL submitted requests (shed
    # included): the token-level goodput denominator
    tokens_offered = int(sum(int(n) for n in out_lens[:submitted]))
    offered = len(done) + len(shed)

    shed_reasons = {}
    for r in shed:
        key = r.shed_reason or "?"
        shed_reasons[key] = shed_reasons.get(key, 0) + 1
    # TTFT attribution: the scheduler's own aggregation, so the artifact
    # and the serve/ttft_* registry gauges come from one implementation
    comps = [c for c in (r.ttft_components() for r in done)
             if c is not None]
    ttft_attr = ttft_attribution(comps)
    return {
        "requests": {
            "offered": offered,
            "completed": len(done),
            "shed": len(shed),
            "shed_reasons": shed_reasons,
            "goodput": len(done) / offered if offered else 0.0,
        },
        "ttft_attribution": ttft_attr,
        "tokens": {
            "completed": tokens_done,
            "offered": tokens_offered,
            "goodput": (
                tokens_done / tokens_offered if tokens_offered else 0.0
            ),
            "throughput_per_s": tokens_done / wall if wall > 0 else 0.0,
        },
        "ttft_ms": {
            "p50": _percentile(ttfts, 0.50),
            "p95": _percentile(ttfts, 0.95),
            "p99": _percentile(ttfts, 0.99),
            "samples": len(ttfts),
        },
        "per_token_ms": {
            "p50": _percentile(per_tok, 0.50),
            "p95": _percentile(per_tok, 0.95),
            "p99": _percentile(per_tok, 0.99),
            "samples": len(per_tok),
        },
        "batch_fill": {
            "mean": sum(fills) / len(fills) if fills else 0.0,
            "peak": max(fills) if fills else 0.0,
        },
        "page_occupancy_peak": max(occupancy) if occupancy else 0.0,
        "wall_s": wall,
        "_ttft_samples": ttfts,
        "_per_tok_samples": per_tok,
        "_mid_scrape": mid_scrape,
        "_requests": submitted_reqs,
    }


def _prefill_flops(cfg, n, start):
    """Analytic prefill FLOPs for positions ``[start, n)`` of an
    ``n``-token prompt: per-token linear work (qkv + attention output
    + MLP matmuls) plus causal attention ``QK^T``/``AV`` work, which
    for position ``i`` scans a context of ``i + 1``."""
    h = cfg.hidden_size
    linear = 4 * h * h + 2 * h * cfg.intermediate_size
    pairs = (n * (n + 1) - start * (start + 1)) / 2.0
    return cfg.num_layers * (linear * (n - start) + 2.0 * h * pairs)


def prefix_report(sched, cfg, args, load):
    """The prefix-cache acceptance section: hit-vs-miss TTFT (classified
    by each completed request's actual ``cache_hit_tokens``), the
    analytic prefill-FLOPs saving over the whole completed set, the
    cache ledger, and the pool-accounting proof."""
    done = [r for r in sched.completed if r.ttft_ms is not None]
    hit = [r for r in done if r.cache_hit_tokens > 0]
    miss = [r for r in done if r.cache_hit_tokens == 0]
    grain = args.chunk_tokens or args.page_size
    flops_cold = flops_cached = 0.0
    for r in done:
        n = len(r.prompt)
        start = (min(r.cache_hit_tokens, n - 1) // grain) * grain
        flops_cold += _prefill_flops(cfg, n, 0)
        flops_cached += _prefill_flops(cfg, n, start)
    saved_pct = (
        100.0 * (1.0 - flops_cached / flops_cold) if flops_cold else 0.0
    )
    sched.leak_check()  # must not raise — the final accounting proof
    prefix = sched.prefix
    return {
        "shared_prefix_tokens": args.shared_prefix_tokens,
        "shared_frac": args.shared_frac,
        "chunk_tokens": args.chunk_tokens,
        "hit_requests": len(hit),
        "miss_requests": len(miss),
        "hit_ttft_ms": {
            "p50": _percentile(sorted(r.ttft_ms for r in hit), 0.50),
            "samples": len(hit),
        },
        "miss_ttft_ms": {
            "p50": _percentile(sorted(r.ttft_ms for r in miss), 0.50),
            "samples": len(miss),
        },
        "prefill_flops_saved_pct": saved_pct,
        "cache": {
            "hits": prefix.hits,
            "misses": prefix.misses,
            "hit_tokens": prefix.hit_tokens,
            "commits": prefix.commits,
            "evictions": prefix.evictions,
            "cached_pages": len(prefix.cached_pages()),
        },
        "leak_checks_run": sched.leak_checks_run,
    }


def prefix_replay_check(cfg, model, args, completed):
    """Bit-identity proof: replay every completed request, one at a
    time, through a cache-DISABLED, speculation-free scheduler with the
    same chunk config — the run's full token stream must match exactly
    (greedy sampling; a cache hit re-runs the same final chunk over
    bit-identical committed pages, so a divergence means a borrowed page
    was corrupted).

    The replay engine has the run's ``--batch`` slots, where the
    reference's has 2: on the card cuBLAS picks its f32 GEMM by the
    batch's rows, so a decode step at 2 slots and at 8 rounds apart (an
    H100 read 2.9e-6 to 3.2e-5 between them at ``GptConfig()``'s width)
    and a near-tie's argmax can flip; at the run's own shapes the
    comparison is bit for bit."""
    from apex_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        InferenceEngine,
        Request,
        ServeConfig,
    )

    eng = InferenceEngine(cfg, model, ServeConfig(
        page_size=args.page_size, num_pages=args.pages,
        max_batch=args.batch, max_pages_per_seq=args.pages_per_seq,
        kv_wire=args.kv_wire, weight_wire=args.weight_wire,
        verify=False,
    ), device=model.device)
    sched = ContinuousBatchingScheduler(
        eng, registry=None, prefix_cache=False,
        prefill_chunk_tokens=args.chunk_tokens,
    )
    mismatches = []
    for r in completed:
        ref = sched.submit(Request(
            prompt=list(r.prompt), max_new_tokens=r.max_new_tokens,
        ))
        sched.run()
        if ref.tokens != r.tokens:
            mismatches.append(r.rid)
    return {
        "replayed": len(completed),
        "mismatched_rids": mismatches,
        "bit_identical": not mismatches,
    }


def spec_report(sched, registry, args):
    """The speculative-decoding acceptance section: windowed acceptance
    rate and tokens per decode step from the scheduler's own gauges, the
    draft/accept/rollback ledger, and per-request decode-steps-saved
    percentiles (each completed request's engine iterations vs the
    one-token-per-step count plain decode would have needed)."""
    registry.fetch()
    vals = registry.values()
    saved = []
    for r in sched.completed:
        n_decode = len(r.tokens) - 1
        if (
            n_decode > 0
            and r.first_decode_iter is not None
            and r.last_decode_iter is not None
        ):
            steps = r.last_decode_iter - r.first_decode_iter + 1
            saved.append(100.0 * (1.0 - steps / n_decode))
    saved.sort()
    sched.leak_check()  # draft pages ledgered exactly, proven here
    return {
        "k": args.speculate,
        "draft_layers": args.draft_layers,
        "rounds": vals.get("serve/spec_rounds", 0.0),
        "drafted": vals.get("serve/spec_drafted", 0.0),
        "accepted": vals.get("serve/spec_accepted", 0.0),
        "rollbacks": vals.get("serve/spec_rollbacks", 0.0),
        "fallbacks": vals.get("serve/spec_fallbacks", 0.0),
        "draft_faults": vals.get("serve/draft_faults", 0.0),
        "accept_rate": vals.get("serve/spec_accept_rate", 0.0),
        "tokens_per_step": vals.get("serve/spec_tokens_per_step", 0.0),
        "decode_steps_saved_pct": {
            "p50": _percentile(saved, 0.50),
            "p95": _percentile(saved, 0.95),
            "p99": _percentile(saved, 0.99),
            "samples": len(saved),
        },
        "leak_checks_run": sched.leak_checks_run,
    }


def single_request_baseline(engine, args):
    """Batch fill a lone request sustains — the bar the continuous
    batcher must beat (one request on max_batch slots)."""
    from apex_tpu_torch.serve import ContinuousBatchingScheduler, Request

    rs = np.random.RandomState(1)
    sched = ContinuousBatchingScheduler(engine, registry=None)
    sched.submit(Request(
        prompt=[int(t) for t in rs.randint(0, args.vocab,
                                           size=int(args.prompt_mix[0]))],
        max_new_tokens=int(args.output_mix[0]),
    ))
    fills = []
    while sched.pending:
        sched.step()
        fills.append(sched.batch_fill())
    return sum(fills) / len(fills) if fills else 0.0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="closed-loop serving load generator"
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--prompt-mix", type=int, nargs="+",
                    default=[16, 32, 48], dest="prompt_mix")
    ap.add_argument("--output-mix", type=int, nargs="+",
                    default=[4, 8, 16], dest="output_mix")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="per-request TTFT SLO (None = best effort)")
    ap.add_argument("--vocab", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--intermediate", type=int, default=None,
                    help="FFN width (default 2 * --hidden)")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=96)
    ap.add_argument("--pages-per-seq", type=int, default=8)
    ap.add_argument("--kv-wire", default="f32", choices=["f32", "int8"])
    ap.add_argument("--weight-wire", default="f32", choices=["f32", "int8"])
    ap.add_argument("--prefix-cache", action="store_true",
                    help="arm the cross-request prefix cache")
    ap.add_argument("--shared-prefix-tokens", type=int, default=0,
                    metavar="N", dest="shared_prefix_tokens",
                    help="length of the shared system prompt opening "
                    "--shared-frac of the requests (0 = off)")
    ap.add_argument("--shared-frac", type=float, default=0.8,
                    dest="shared_frac",
                    help="fraction of requests drawing the shared prefix")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    metavar="N", dest="chunk_tokens",
                    help="prefill chunk size (page multiple): slices "
                    "prefill between decode iterations; also the "
                    "re-run grain a cache hit's bit-identity rides on")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decoding: draft K tokens per "
                    "round, one target verify step scores them all "
                    "(0 = off)")
    ap.add_argument("--draft-layers", type=int, default=None,
                    metavar="N", dest="draft_layers",
                    help="draft = the target's first N layers "
                    "(embeddings shared); default self-draft — the "
                    "target proposes for itself (100%% greedy accept)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", metavar="FILE", default=None)
    ap.add_argument("--spans", metavar="FILE", default=None,
                    help="record per-request span chains and dump them "
                    "here (feed to apex_tpu_torch.tools.timeline)")
    ap.add_argument("--span-capacity", type=int, default=65536)
    ap.add_argument("--ops-port", type=int, default=None,
                    metavar="PORT",
                    help="serve OpenMetrics at /metrics during the run "
                    "(0 = OS-assigned; APEX_TPU_OPS_PORT is the default)")
    ap.add_argument("--slo-objective", type=float, default=0.9,
                    help="TTFT SLO objective (fraction of requests "
                    "under --slo-ttft-ms)")
    ap.add_argument("--slo-burn-short", type=float, default=0.25,
                    metavar="S",
                    help="short burn-rate window, seconds (scaled for "
                    "in-process runs; production uses slo.DEFAULT_WINDOWS)")
    ap.add_argument("--slo-burn-long", type=float, default=1.0,
                    metavar="S", help="long burn-rate window, seconds")
    ap.add_argument("--slo-burn-factor", type=float, default=2.0,
                    help="burn-rate page factor over BOTH windows")
    ap.add_argument("--memstats-fake-scale", type=float, default=1.0,
                    help="scale of the fake provider's live watermark "
                    "vs the static peak (CPU only; 2.0 plants the "
                    "drift the gate must flag)")
    ap.add_argument("--memstats-tolerance", type=float, default=0.25,
                    help="static-vs-live reconciliation tolerance")
    return ap


def main(argv=None, *, model=None):
    """Run the tool; returns the exit code.  ``model`` (a
    :class:`~apex_tpu_torch.models.GptModel` of the flags' widths on
    ``--device``) replaces the seeded random weights."""
    args = build_parser().parse_args(argv)
    from apex_tpu_torch.ops._dispatch import resolve_device

    resolve_device(args.device)  # the card unless asked otherwise
    if args.ops_port is None:
        from apex_tpu_torch.observability.ometrics import ops_port_from_env

        args.ops_port = ops_port_from_env()

    cfg, model, engine, registry = build_engine(args, model)
    lint_errors = {
        name: len(rep.errors()) for name, rep in engine.reports.items()
    }

    from apex_tpu_torch.observability import memstats as memstats_lib

    # the engine build (verify=True) just published its per-program
    # static peak estimates — the reconciliation baseline
    static_peaks = memstats_lib.static_peaks_from_board()
    provider = None
    if engine.device.type == "cuda":
        provider = memstats_lib.default_provider()
    if provider is None:  # CPU: a fake seeded from the static peaks
        provider = memstats_lib.FakeMemoryProvider.from_static(
            static_peaks or {"unverified": 0.0},
            scale=args.memstats_fake_scale,
        )
    monitor = memstats_lib.MemStatsMonitor(provider)

    recorder = None
    if args.spans:
        from apex_tpu_torch.observability.spans import SpanRecorder

        recorder = SpanRecorder(capacity=args.span_capacity)

    baseline_fill = single_request_baseline(engine, args)

    from apex_tpu_torch.serve import ContinuousBatchingScheduler

    sched = ContinuousBatchingScheduler(
        engine, registry=registry, spans=recorder,
        prefix_cache=args.prefix_cache,
        prefill_chunk_tokens=args.chunk_tokens,
    )

    ops = None
    if args.ops_port is not None:
        from apex_tpu_torch.observability.ometrics import OpsServer

        ops = OpsServer(
            registries=[registry], histograms=[sched.ttft_hist],
            collect=monitor.sample, port=args.ops_port,
        ).start()
        print(f"[serve_bench] ops endpoint live at {ops.url}")

    watchdog = None
    if args.slo_ttft_ms is not None:
        from apex_tpu_torch.observability import slo as slo_lib
        from apex_tpu_torch.observability.health import Watchdog

        windows = (slo_lib.Window(
            args.slo_burn_short, args.slo_burn_long,
            args.slo_burn_factor, "critical",
        ),)
        watchdog = Watchdog(
            rules=slo_lib.serve_slo_rules(
                ttft_histogram=sched.ttft_hist,
                ttft_threshold_ms=args.slo_ttft_ms,
                ttft_objective=args.slo_objective,
                windows=windows,
            ),
            registry=registry, spans=recorder, check_every=1,
        )

    load = run_load(
        sched, args, watchdog=watchdog, monitor=monitor, ops=ops
    )
    numerics = numerics_check(cfg, model, args)

    if recorder is not None:
        spans_path = recorder.dump(reason="serve_bench", path=args.spans)
        print(f"[serve_bench] wrote {spans_path} "
              f"({len(recorder.snapshot())} span entries, "
              f"{recorder.dropped} dropped)")

    ttft_samples = load.pop("_ttft_samples")
    per_tok_samples = load.pop("_per_tok_samples")
    mid_scrape = load.pop("_mid_scrape")
    load.pop("_requests")
    if args.prefix_cache:
        load["prefix"] = prefix_report(sched, cfg, args, load)
        load["prefix"]["replay"] = prefix_replay_check(
            cfg, model, args, sched.completed
        )
    if args.speculate:
        load["spec"] = spec_report(sched, registry, args)
        # bit-identity proof: prefix_replay_check's reference engine is
        # also speculation-free, so the same replay serves both gates
        load["spec"]["replay"] = prefix_replay_check(
            cfg, model, args, sched.completed
        )
    registry.fetch()

    # the end-of-run scrape happens AFTER the registry drain, so its
    # gauge/counter samples must equal the artifact's registry section
    final_scrape = http_scrape(ops.url) if ops is not None else None
    memstats_findings = monitor.crosscheck(
        static_peaks, tolerance=args.memstats_tolerance
    )

    print(f"== serve_bench: {args.requests} requests, Poisson "
          f"{args.rate}/s, kv_wire={args.kv_wire}, "
          f"weight_wire={args.weight_wire} ==")
    r = load["requests"]
    tk = load["tokens"]
    shed_desc = (
        " (" + ", ".join(
            f"{k}={v}" for k, v in sorted(r["shed_reasons"].items())
        ) + ")" if r["shed_reasons"] else ""
    )
    print(f"goodput: {r['completed']}/{r['offered']} requests "
          f"({100 * r['goodput']:.1f}%), {r['shed']} shed{shed_desc}; "
          f"{tk['completed']}/{tk['offered']} tokens "
          f"({100 * tk['goodput']:.1f}%)")
    print(f"throughput: {load['tokens']['throughput_per_s']:.1f} tokens/s "
          f"({load['tokens']['completed']} tokens in "
          f"{load['wall_s']:.2f}s)")
    t = load["ttft_ms"]
    print(f"TTFT ms: p50={t['p50']:.2f} p95={t['p95']:.2f} "
          f"p99={t['p99']:.2f} (n={t['samples']})")
    from apex_tpu_torch.serve import TTFT_COMPONENTS

    ta = load["ttft_attribution"]
    print("TTFT attribution (p50/p95/p99 ms): " + "  ".join(
        f"{comp}={ta[f'{comp}_ms']['p50']:.2f}/"
        f"{ta[f'{comp}_ms']['p95']:.2f}/{ta[f'{comp}_ms']['p99']:.2f}"
        for comp in TTFT_COMPONENTS
    ) + f"  queue-wait fraction={ta['queue_wait_fraction']:.3f}")
    print(_histogram(ttft_samples))
    p = load["per_token_ms"]
    print(f"per-token ms: p50={p['p50']:.2f} p95={p['p95']:.2f} "
          f"p99={p['p99']:.2f} (n={p['samples']})")
    print(_histogram(per_tok_samples))
    bf = load["batch_fill"]
    print(f"batch fill: mean={bf['mean']:.3f} peak={bf['peak']:.3f} "
          f"(single-request baseline {baseline_fill:.3f}); page "
          f"occupancy peak {load['page_occupancy_peak']:.3f}")
    for wire, rec in numerics.items():
        print(f"numerics [{wire} KV vs unpaged f32]: max|dlogit|="
              f"{rec['max_abs_logit_diff']:.2e} tol={rec['tolerance']} "
              f"{'OK' if rec['ok'] else 'FAIL'}")
    if args.prefix_cache:
        px = load["prefix"]
        hp = px["hit_ttft_ms"]["p50"]
        mp = px["miss_ttft_ms"]["p50"]
        ratio = (hp / mp) if (hp == hp and mp and mp == mp) else float("nan")
        print(f"prefix cache: {px['hit_requests']} hit / "
              f"{px['miss_requests']} miss; hit p50 TTFT {hp:.2f}ms vs "
              f"miss {mp:.2f}ms (ratio {ratio:.3f}); prefill FLOPs "
              f"saved {px['prefill_flops_saved_pct']:.1f}%; "
              f"evictions={px['cache']['evictions']} "
              f"commits={px['cache']['commits']} "
              f"leak_checks={px['leak_checks_run']}")
        rp = px["replay"]
        print(f"prefix replay: {rp['replayed']} requests vs uncached "
              f"reference — "
              f"{'BIT-IDENTICAL' if rp['bit_identical'] else 'MISMATCH'}")
    if args.speculate:
        sx = load["spec"]
        ds = sx["decode_steps_saved_pct"]
        print(f"speculative decode (k={sx['k']}, draft_layers="
              f"{sx['draft_layers'] or 'self'}): accept rate "
              f"{100 * sx['accept_rate']:.1f}%, "
              f"{sx['tokens_per_step']:.2f} tokens/step over "
              f"{sx['rounds']:.0f} rounds; decode steps saved "
              f"p50={ds['p50']:.1f}% p95={ds['p95']:.1f}% "
              f"(rollbacks={sx['rollbacks']:.0f} "
              f"fallbacks={sx['fallbacks']:.0f} "
              f"draft_faults={sx['draft_faults']:.0f})")
        srp = sx["replay"]
        print(f"spec replay: {srp['replayed']} requests vs plain-decode "
              f"reference — "
              f"{'BIT-IDENTICAL' if srp['bit_identical'] else 'MISMATCH'}")
    print(f"graph lint ERRORs: {lint_errors}")

    slo_events = list(watchdog.events) if watchdog is not None else []
    if watchdog is not None:
        print(f"SLO burn-rate alerts fired: {len(slo_events)}")
        for ev in slo_events[:5]:
            print(f"  [{ev.severity}] {ev.rule}: {ev.message}")
    live_peaks = monitor.live_peaks()
    print(
        f"memstats [{provider.kind}]: live peak "
        f"{max(live_peaks.values(), default=0.0) / (1 << 20):.2f} MiB "
        f"vs static {max(static_peaks.values(), default=0.0) / (1 << 20):.2f}"
        f" MiB over {len(static_peaks)} program(s); "
        f"{len(memstats_findings)} drift finding(s)"
    )
    for f in memstats_findings:
        print(f"  DRIFT: {f['message']}")
    if ops is not None and final_scrape is not None:
        print(
            f"ops scrape: {final_scrape.get('bytes', 0)} bytes in "
            f"{final_scrape['ms']:.2f}ms "
            f"(mid-run: {'OK' if mid_scrape and mid_scrape.get('ok') else 'MISSED'})"
        )

    failures = []
    if bf["mean"] <= baseline_fill:
        failures.append(
            f"continuous batching not engaged: mean fill {bf['mean']:.3f} "
            f"<= single-request baseline {baseline_fill:.3f}"
        )
    for wire, rec in numerics.items():
        if not rec["ok"]:
            failures.append(
                f"{wire}-KV decode drifted {rec['max_abs_logit_diff']:.3e} "
                f"> {rec['tolerance']} from the unpaged f32 reference"
            )
    if "decode" not in lint_errors or not any(
        k.startswith("prefill") for k in lint_errors
    ):
        failures.append(
            f"analysis.check did not cover both steps: {sorted(lint_errors)}"
        )
    if any(lint_errors.values()):
        failures.append(f"graph lint ERRORs on serve steps: {lint_errors}")
    if args.prefix_cache:
        rp = load["prefix"]["replay"]
        if not rp["bit_identical"]:
            failures.append(
                f"prefix cache broke decode bit-identity: rids "
                f"{rp['mismatched_rids']} diverged from the uncached "
                f"reference"
            )
    if args.speculate:
        srp = load["spec"]["replay"]
        if not srp["bit_identical"]:
            failures.append(
                f"speculative decoding broke bit-identity: rids "
                f"{srp['mismatched_rids']} diverged from the "
                f"plain-decode reference"
            )

    if args.json:
        from apex_tpu_torch.observability.flight import json_safe
        from apex_tpu_torch.observability.spans import wall_clock_anchor

        artifact = {
            # the per-process monotonic -> epoch anchor: lines this
            # artifact up against span/flight records of the same run
            "anchor": wall_clock_anchor(),
            "config": {
                k: getattr(args, k) for k in (
                    "requests", "rate", "prompt_mix", "output_mix",
                    "slo_ttft_ms", "batch", "page_size", "pages",
                    "pages_per_seq", "kv_wire", "weight_wire", "seed",
                    "prefix_cache", "shared_prefix_tokens",
                    "shared_frac", "chunk_tokens", "speculate",
                    "draft_layers", "device", "intermediate",
                )
            },
            "load": load,
            "batch_fill_single_request_baseline": baseline_fill,
            "numerics_vs_unpaged_f32": numerics,
            "graph_lint_errors": lint_errors,
            "registry": {
                k: v for k, v in registry.values().items()
                if k.startswith("serve/")
            },
            "ttft_histogram": sched.ttft_hist.snapshot(),
            "ops": None if ops is None else {
                "port": ops.port,
                "url": ops.url,
                "mid_scrape": mid_scrape,
                "scrape": final_scrape,
            },
            "slo": None if watchdog is None else {
                "alerts_fired": len(slo_events),
                "windows": {
                    "short_s": args.slo_burn_short,
                    "long_s": args.slo_burn_long,
                    "factor": args.slo_burn_factor,
                },
                "events": [ev._asdict() for ev in slo_events],
            },
            "memstats": {
                "provider": provider.kind,
                "fake_scale": (
                    args.memstats_fake_scale
                    if provider.kind == "fake" else None
                ),
                "tolerance": args.memstats_tolerance,
                "live_peaks": live_peaks,
                "static_peaks": static_peaks,
                "watermark_samples": monitor.samples,
                "findings": memstats_findings,
            },
            "spans_file": args.spans,
            "failures": failures,
        }
        # strict JSON: an all-shed run yields NaN percentiles; encode
        # them the flight-dump way instead of bare NaN tokens
        with open(args.json, "w") as f:
            json.dump(json_safe(artifact), f, indent=2, allow_nan=False)
            f.write("\n")
        print(f"[serve_bench] wrote {args.json}")

    if ops is not None:
        ops.stop()
    for msg in failures:
        print(f"FAIL {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

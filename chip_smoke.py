#!/usr/bin/env python3
"""Bring-up check of apex_tpu_torch on one NVIDIA GPU (H100).

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``apex_tpu_torch/csrc`` (set-up
time, one ``nvcc`` per source, all started together) and then runs
seven phases; any failure raises and the exit code is non-zero.  Without
a CUDA device it exits non-zero at once and prints no result.

1. Each kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it and at ragged shapes,
   within a stated tolerance: K1 (LayerNorm forward), K2 (its backward,
   with rms and memory_efficient), K3 (flash forward), K4 (flash
   backward: Sq != Sk both ways, fully-masked rows, non-causal, dlse)
   and K6 (paged decode).
2. The serving slice: ``GptConfig()`` at full width (bf16, seeded random
   weights) behind ``InferenceEngine`` + ``ContinuousBatchingScheduler``
   answers 8 greedy requests (prompts of 17..1900 tokens, 32 new tokens
   each).  The launch counters are zeroed just before and read just
   after: K1, K3 and K6 must each have launched, exactly as often as the
   prefill and decode calls require, and every op must have taken the
   kernel path.  The page pool must end empty.  The same requests are
   then served again: the second run's rates pay no first-call costs.
3. Serving cross-check: at full width with 2 layers, one 256-token
   prefill and 4 decode steps through the card engine (bf16) against the
   CPU engine (f32, the same weights), fed the same tokens.
4. Timing at the main-path shapes (training and serving): each kernel,
   its plain version and one PyTorch library call computing the same
   function (the yardstick, never used by the port), with the least time
   the card could take.
5. Decode at batch 8, full width: host time per iteration unprofiled,
   then a ``torch.profiler`` trace of 4 iterations — the device time of
   their kernels (the device's busy share), the kernels that took most,
   and the host side split into the time inside PyTorch ops and runtime
   calls (by op) and the Python time outside them.
6. The training slice: ``python -m apex_tpu_torch.examples.train_gpt``'s
   ``train`` at ``GptConfig(remat=True)``, seq 2048, batch 8, 8 steps on
   a synthetic zipf corpus, with the launch counters zeroed before and
   read after: K1, K2, K3 and K4 must have launched exactly their
   per-step counts times 8.  Losses must be finite and falling; it
   reports step time, tokens/s, 6NT MFU, peak memory and the top device
   ops of one profiled step.
7. Training cross-check: 2 layers at full width, B=2, S=256 — the loss,
   every parameter's gradient and the weights after one FusedAdam step,
   card (bf16) against CPU (f32), from the same weights and batch.

The phases run in the order 1, 2, 3, 6, 7, 4, 5.
The line before the last is a JSON object of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet, dense): the bound_ms basis
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

#: bf16 output tolerance of a kernel against its plain version: the two
#: round f32 results to bf16 at different points (one to two bf16 steps)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
#: K6 output: both sides softmax in f32 and round once to the output
#: dtype, so they differ by at most one bf16 step (2^-8 at |o| < 1).  K6
#: has no lse check behind its output, so this is tight enough that a
#: kernel dropping one 16-token page of a 2048-token row (|o| ~ 0.04, an
#: error ~7e-3) fails at every length, not only at the short ones
K6_TOL = dict(atol=4e-3, rtol=8e-3)
#: f32 statistics (LayerNorm mean/rstd, attention lse): summation order
F32_TOL = dict(atol=1e-3, rtol=1e-4)
#: K2's dw/db: f32 sums over up to 16384 rows (|sum| up to ~500) taken
#: in another order (per-CTA partials, then torch.sum)
SUM_TOL = dict(atol=1e-2, rtol=1e-3)
#: K4's dq, dk, dv, scaled to the reference, row by row: at S = 2048 an
#: early row's gradient is tens of times a late row's (|dq_i| falls as
#: 1/sqrt(i)), so one absolute tolerance would be loose for late rows.
#: Each element may be off by ``rtol`` of itself (one bf16 step: both
#: sides round to bf16) plus ``row`` times the RMS of its reference row
#: (the kernel's bf16 p and ds) plus ``floor`` times the RMS of the
#: whole tensor (only so that a row whose reference is exactly 0 does
#: not demand exact zeros); and the tensor's relative Frobenius error
#: must stay under ``norm``.  On an H100 the sound kernel reads at most
#: 0.21 of its allowance and a relative error of 2.2e-3 to 2.7e-3; a K4
#: that drops one 64-key tile for the later half of the rows reads ~22
#: times its allowance and 0.07 to 0.08: phase 1 builds that output
#: from the twin's at the training shape and checks that it fails.
K4_TOL = dict(rtol=2 ** -7, row=1 / 8, floor=2 ** -10, norm=1e-2)
#: phase 3: bf16 card engine vs f32 CPU engine on 2-layer logits (logit
#: std ~0.64; a CPU bf16-vs-f32 run of the same check gives ~0.02)
LOGITS_TOL = 0.06

REPLACES = {
    "layer_norm_fwd": "apex_tpu/ops/pallas/layer_norm.py:237",
    "layer_norm_bwd": "apex_tpu/ops/pallas/layer_norm.py:258",
    "flash_fwd": "apex_tpu/ops/pallas/flash_attention.py:615",
    "flash_bwd": "apex_tpu/ops/pallas/flash_attention.py:873",
    "paged_decode": "apex_tpu/ops/pallas/decode_attention.py:263",
}


def log(*args):
    print(*args, flush=True)


def compare(name, out, ref, tol):
    """max |out - ref| after checking ``allclose`` under ``tol``; the
    relative error is reported over elements with |ref| >= 0.1."""
    import torch

    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    finite = bool(torch.isfinite(out).all())
    ok = finite and bool(torch.allclose(out, ref, **tol))
    max_abs = float(err.max()) if err.numel() else 0.0
    big = ref.abs() >= 0.1
    max_rel = float((err[big] / ref.abs()[big]).max()) if big.any() else 0.0
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"tol={tol} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_abs


def time_ms(fn, *, iters=25, warmup=3, flush=None):
    """Median milliseconds of ``fn()`` over ``iters`` runs, each between
    its own CUDA events.  All runs are queued behind a spin kernel of
    ~0.2 s (``torch.cuda._sleep``: little power, so the clocks stay up),
    so the card runs them back to back and each pair of events measures
    device time, not the host's launch overhead (a small kernel takes
    less time than its Python wrapper).  ``flush`` (a large tensor) is
    rewritten before each run so the inputs come from device memory, not
    the L2 cache."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)  # clock cycles: ~0.2 s at ~2 GHz
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(bytes_moved, ops, peak_ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


# ---------------------------------------------------------------------------
# inputs at the main-path shapes
# ---------------------------------------------------------------------------


def ln_inputs(rows, hidden, gen):
    import torch

    x = torch.randn(rows, hidden, generator=gen, device="cuda") * 2 + 0.5
    w = 1 + 0.1 * torch.randn(hidden, generator=gen, device="cuda")
    b = 0.1 * torch.randn(hidden, generator=gen, device="cuda")
    return x.to(torch.bfloat16), w, b


def attn_inputs(bh, sq, sk, d, gen):
    import torch

    def r(s):
        return torch.randn(bh, s, d, generator=gen, device="cuda").to(
            torch.bfloat16
        )

    return r(sq), r(sk), r(sk)


def paged_inputs(b, h, d, page, np_, pool, lengths, gen, kv="bf16"):
    import torch

    from apex_tpu_torch.models import rope_cos_sin

    dev = "cuda"
    q = torch.randn(b, h, d, generator=gen, device=dev).to(torch.bfloat16)
    if kv == "int8":
        k_pages = torch.randint(-127, 128, (pool, h, page, d), generator=gen,
                                device=dev, dtype=torch.int8)
        v_pages = torch.randint(-127, 128, (pool, h, page, d), generator=gen,
                                device=dev, dtype=torch.int8)
        k_scale = torch.rand(pool, h, page, generator=gen, device=dev) / 64
        v_scale = torch.rand(pool, h, page, generator=gen, device=dev) / 64
    else:
        dtype = torch.bfloat16 if kv == "bf16" else torch.float32
        k_pages = torch.randn(pool, h, page, d, generator=gen,
                              device=dev).to(dtype)
        v_pages = torch.randn(pool, h, page, d, generator=gen,
                              device=dev).to(dtype)
        k_scale = v_scale = None
        if kv == "f32":
            q = q.float()
    perm = torch.randperm(pool - 1, generator=gen, device=dev)[: b * np_] + 1
    table = perm.reshape(b, np_).to(torch.int32).contiguous()
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    cos_t, sin_t = rope_cos_sin(np_ * page, d, device=dev)
    pos = (lengths.long() - 1).clamp_min(0)
    return dict(q=q, k_pages=k_pages, v_pages=v_pages, page_table=table,
                lengths=lengths, k_scale=k_scale, v_scale=v_scale,
                rope_cos=cos_t[pos], rope_sin=sin_t[pos])


MAIN_LENGTHS = [0, 1, 17, 2048, 100, 555, 1024, 2047]


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version on the card
# ---------------------------------------------------------------------------


def phase1(gen):
    import torch

    from apex_tpu_torch.ops import attention as attn
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import paged_attention as pa

    log("phase 1: kernels against their plain versions")
    errs = {}
    # the training shape first (its error goes into the kernels line),
    # then the prefill shape, the decode batch, RMS and a ragged row
    for rows, hidden, rms in ((TRAIN_BATCH * TRAIN_SEQ, 1024, False),
                              (2048, 1024, False), (8, 1024, False),
                              (2048, 1024, True), (37, 1000, False)):
        x, w, b = ln_inputs(rows, hidden, gen)
        y, mu, rstd = ln.layer_norm_fwd(x, w, b, eps=1e-5, rms=rms)
        y_r, mu_r, rstd_r = ln.layer_norm_reference(x, w, b, 1e-5, rms)
        tag = f"K1 layer_norm_fwd rows={rows} hidden={hidden} rms={rms}"
        e = compare(tag + " y", y, y_r, BF16_TOL)
        compare(tag + " mu", mu, mu_r, F32_TOL)
        compare(tag + " rstd", rstd, rstd_r, F32_TOL)
        errs.setdefault("layer_norm_fwd", e)

    # the training shape (BH = batch x heads) first, then the prefill
    # shapes and ragged and Sq != Sk cases
    for bh, sq, sk in ((TRAIN_BATCH * 16, TRAIN_SEQ, TRAIN_SEQ),
                       (16, 16, 16), (16, 1024, 1024), (16, 2048, 2048),
                       (4, 200, 200), (4, 64, 192), (2, 96, 40)):
        q, k, v = attn_inputs(bh, sq, sk, 64, gen)
        o, lse = attn.flash_fwd(q, k, v, scale=0.125, causal=True)
        o_r, lse_r = attn.mha_reference_with_lse(
            q[None], k[None], v[None], causal=True, scale=0.125
        )
        tag = f"K3 flash_fwd BH={bh} Sq={sq} Sk={sk} D=64 causal"
        e = compare(tag + " o", o, o_r[0], BF16_TOL)
        compare(tag + " lse", lse, lse_r[0], F32_TOL)
        errs.setdefault("flash_fwd", e)
        del o_r, lse_r
        torch.cuda.empty_cache()

    errs["layer_norm_bwd"] = phase1_ln_bwd(gen)
    errs["flash_bwd"] = phase1_flash_bwd(gen)

    cases = (
        ("bf16", dict(b=8, h=16, d=64, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS)),
        ("int8", dict(b=8, h=16, d=64, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS)),
        ("f32", dict(b=3, h=4, d=32, page=8, np_=3, pool=12,
                     lengths=[17, 9, 0])),
    )
    for kv, shape in cases:
        args = paged_inputs(**shape, gen=gen, kv=kv)
        kw = {k: args[k] for k in ("k_scale", "v_scale", "rope_cos",
                                   "rope_sin")}
        pos = [args[k] for k in ("q", "k_pages", "v_pages", "page_table",
                                 "lengths")]
        scale = shape["d"] ** -0.5
        out = pa.paged_decode_fwd(*pos, scale=scale, **kw)
        ref = pa.paged_decode_attention_reference(*pos, scale=scale, **kw)
        tag = (f"K6 paged_decode {kv} B={shape['b']} H={shape['h']} "
               f"D={shape['d']} page={shape['page']} NP={shape['np_']}")
        e = compare(tag, out, ref, K6_TOL)
        idle = [i for i, n in enumerate(shape["lengths"]) if n == 0]
        if float(out[idle].float().abs().max()) != 0.0:
            raise AssertionError(tag + ": an idle slot is not exactly zero")
        if kv == "bf16":
            errs["paged_decode"] = e
    return errs


#: (rows, hidden, dtype, rms, memory_efficient): the training shape, the
#: other modes, ragged rows, f32, one hidden size for each of K2's
#: register variants (a thread holds 1, 2, 4, 8 or 16 columns) and a row
#: wider than that (the streamed variant)
LN_BWD_CASES = (
    (16384, 1024, "bf16", False, False),
    (16384, 1024, "bf16", False, True),
    (1000, 1024, "bf16", True, False),
    (37, 768, "f32", False, True),
    (37, 768, "f32", True, True),
    (64, 200, "f32", False, False),
    (64, 500, "bf16", True, True),
    (64, 2000, "bf16", False, False),
    (64, 4096, "f32", False, True),
    (64, 5000, "f32", False, False),
)


def phase1_ln_bwd(gen):
    """K2 against its twin on the same saved inputs (the twin's forward
    statistics).  dx: BF16_TOL in bf16, F32_TOL in f32; dw and db:
    SUM_TOL (f32 sums over the rows, taken in another order)."""
    import torch

    from apex_tpu_torch.ops import layer_norm as ln

    main_err = None
    for rows, hidden, dt, rms, me in LN_BWD_CASES:
        x, w, b = ln_inputs(rows, hidden, gen)
        if dt == "f32":
            x = x.float()
        if me:
            w[::7] = 0.0  # the w == 0 guard of the recovered xhat
        y, mu, rstd = ln.layer_norm_reference(x, w, b, 1e-5, rms)
        g = torch.randn(rows, hidden, generator=gen, device="cuda").to(x.dtype)
        saved = y if me else x
        out = ln.layer_norm_bwd(saved, w, b, mu, rstd, g, rms=rms,
                                x_is_output=me)
        ref = ln.layer_norm_bwd_reference(saved, w, b, mu, rstd, g, rms, me)
        tag = (f"K2 layer_norm_bwd rows={rows} hidden={hidden} {dt} rms={rms} "
               f"memory_efficient={me}")
        e = compare(tag + " dx", out[0], ref[0],
                    BF16_TOL if dt == "bf16" else F32_TOL)
        compare(tag + " dw", out[1], ref[1], SUM_TOL)
        compare(tag + " db", out[2], ref[2], SUM_TOL)
        if main_err is None:
            main_err = e
    return main_err


#: (BH, Sq, Sk, causal, with dlse): the training shape, ragged lengths,
#: Sq < Sk, Sq > Sk with fully-masked rows, non-causal, and an lse
#: cotangent folded into delta
FLASH_BWD_CASES = (
    (128, 2048, 2048, True, False),
    (4, 1000, 1000, True, False),
    (4, 17, 17, True, False),
    (4, 64, 192, True, False),
    (4, 200, 72, True, False),
    (4, 200, 130, False, False),
    (4, 300, 300, True, True),
)


def k4_check(out, ref):
    """(ok, max |out - ref|, relative Frobenius error, worst ratio of an
    element's error to its allowance) under ``K4_TOL``."""
    import torch

    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    row_rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    allowed = (K4_TOL["rtol"] * ref.abs() + K4_TOL["row"] * row_rms
               + K4_TOL["floor"] * ref.pow(2).mean().sqrt())
    rel = float(err.norm() / ref.norm().clamp_min(1e-30))
    ratio = float((err / allowed.clamp_min(1e-30)).max())
    ok = (bool(torch.isfinite(out).all()) and bool((err <= allowed).all())
          and rel <= K4_TOL["norm"])
    return ok, float(err.max()), rel, ratio


def k4_dropped_tile(q, k, v, do, lse, delta, ref, scale):
    """The twin's (dq, dk, dv) less what the 64-key tile at S/4 gives the
    later half of the query rows, in bf16: what a K4 that skipped that
    tile for those rows would return (causal, Sq = Sk = S >= 256, so the
    tile lies below the diagonal for every one of those rows)."""
    import torch

    s = q.shape[1]
    rows, keys = slice(s // 2, None), slice(s // 4, s // 4 + 64)
    qr, dor = q[:, rows].float(), do[:, rows].float()
    kt, vt = k[:, keys].float(), v[:, keys].float()
    p = torch.exp(qr @ kt.transpose(1, 2) * scale - lse[:, rows, None])
    ds = p * (dor @ vt.transpose(1, 2) - delta[:, rows, None])
    dq, dk, dv = (t.float() for t in ref)
    dq[:, rows] -= scale * ds @ kt
    dk[:, keys] -= scale * ds.transpose(1, 2) @ qr
    dv[:, keys] -= p.transpose(1, 2) @ dor
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def phase1_flash_bwd(gen):
    """K4 against its twin on the same bf16 q, k, v, dO and the same f32
    lse and delta (from the f32 reference forward), under ``K4_TOL``:
    the kernel rounds p and ds to bf16 for its products, as the TPU's
    bf16 passes do, and both round the result to bf16.  At the training
    shape (the first case), an output with one tile dropped must fail
    the same check."""
    import torch

    from apex_tpu_torch.ops import attention as attn

    main_err = None
    for bh, sq, sk, causal, with_dlse in FLASH_BWD_CASES:
        q, k, v = attn_inputs(bh, sq, sk, 64, gen)
        do = torch.randn(bh, sq, 64, generator=gen, device="cuda").to(
            torch.bfloat16)
        o, lse = attn.mha_reference_with_lse(q, k, v, causal=causal,
                                             scale=0.125)
        delta = (do.float() * o.float()).sum(-1)
        if with_dlse:
            delta = delta - torch.randn(bh, sq, generator=gen, device="cuda")
        del o
        out = attn.flash_bwd(q, k, v, do, lse, delta, scale=0.125,
                             causal=causal)
        ref = attn.flash_bwd_reference(q, k, v, do, lse, delta, scale=0.125,
                                       causal=causal)
        tag = (f"K4 flash_bwd BH={bh} Sq={sq} Sk={sk} D=64 causal={causal} "
               f"dlse={with_dlse}")
        errs = []
        for n, a, r in zip(("dq", "dk", "dv"), out, ref):
            ok, max_abs, rel, ratio = k4_check(a, r)
            log(f"  {tag} {n}: max_abs_err={max_abs:.3e} rel_fro_err="
                f"{rel:.3e} worst err/allowance={ratio:.3e} tol={K4_TOL} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag} {n} disagrees with its twin")
            errs.append(max_abs)
        if main_err is None:
            main_err = max(errs)
            bad = k4_dropped_tile(q, k, v, do, lse, delta, ref, 0.125)
            for n, a, r in zip(("dq", "dk", "dv"), bad, ref):
                ok, max_abs, rel, ratio = k4_check(a, r)
                log(f"  {tag} {n} with one 64-key tile dropped for the "
                    f"later half of the rows: max_abs_err={max_abs:.3e} "
                    f"rel_fro_err={rel:.3e} worst err/allowance="
                    f"{ratio:.3e} {'passes: FAIL' if ok else 'fails: ok'}")
                if ok:
                    raise AssertionError(
                        f"K4_TOL cannot tell a dropped tile in {n}")
            del bad
        del out, ref
        torch.cuda.empty_cache()
    return main_err


# ---------------------------------------------------------------------------
# phase 2: the serving slice at full width
# ---------------------------------------------------------------------------


PROMPT_LENS = (17, 100, 256, 511, 1000, 1024, 1500, 1900)
NEW_TOKENS = 32


def phase2():
    import torch

    from apex_tpu_torch.models import GptConfig, GptModel
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        InferenceEngine,
        Request,
        ServeConfig,
    )

    log("phase 2: GptConfig() at full width, 8 greedy requests")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = GptConfig()
    model = GptModel(cfg, generator=torch.Generator("cuda").manual_seed(1234))
    n_params = sum(p.numel() for p in model.parameters())
    serve = ServeConfig(page_size=16, max_batch=8, max_pages_per_seq=128,
                        num_pages=1025)
    engine = InferenceEngine(cfg, model, serve)
    log(f"  params={n_params} ({n_params / 1e6:.1f} M) "
        f"kv_pool_bytes={sum(t.numel() * t.element_size() for t in engine.cache.values())}")

    warm = ContinuousBatchingScheduler(engine)
    warm.submit(Request(prompt=[1, 2, 3], max_new_tokens=2))
    warm.run()

    prefill, decode = engine.prefill, engine.decode

    def serve_once():
        """The 8 requests through a new scheduler, with the host time of
        the prefill and decode calls; checks that each request finished
        and that no page leaked."""
        clock = {"prefill": 0.0, "decode": 0.0, "decode_tokens": 0}

        def timed_prefill(*a, **k):
            t = time.perf_counter()
            out = prefill(*a, **k)  # returns a host token: synchronised
            clock["prefill"] += time.perf_counter() - t
            return out

        def timed_decode(tokens, lengths, *a, **k):
            t = time.perf_counter()
            out = decode(tokens, lengths, *a, **k)  # host tokens: synced
            clock["decode"] += time.perf_counter() - t
            clock["decode_tokens"] += int((np.asarray(lengths) > 0).sum())
            return out

        engine.prefill, engine.decode = timed_prefill, timed_decode
        rs = np.random.RandomState(0)
        sched = ContinuousBatchingScheduler(engine)
        reqs = [
            sched.submit(Request(
                prompt=[int(t) for t in rs.randint(0, cfg.vocab_size,
                                                   size=n)],
                max_new_tokens=NEW_TOKENS,
            ))
            for n in PROMPT_LENS
        ]
        sched.run()
        torch.cuda.synchronize()
        engine.prefill, engine.decode = prefill, decode
        for r in reqs:
            if r.status != "done" or len(r.tokens) != NEW_TOKENS:
                raise AssertionError(
                    f"request of {len(r.prompt)} tokens ended {r.status} "
                    f"({r.shed_reason}) with {len(r.tokens)} tokens"
                )
            if not all(0 <= t < cfg.vocab_size for t in r.tokens):
                raise AssertionError("a generated token is outside the vocab")
        sched.leak_check()
        if engine.pool.in_use != 0:
            raise AssertionError(f"{engine.pool.in_use} pages still in use")
        return reqs, clock

    prefills0, decodes0 = engine.prefill_calls, engine.decode_iters
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    reqs, clock = serve_once()
    launches = _dispatch.launches()
    paths = _dispatch.last_paths()
    n_prefill = engine.prefill_calls - prefills0
    n_decode = engine.decode_iters - decodes0
    log(f"  prefill_calls={n_prefill} decode_iters={n_decode} "
        f"launches={launches} paths={paths}")
    layers = cfg.num_layers
    want = {
        "layer_norm_fwd": (2 * layers + 1) * (n_prefill + n_decode),
        "flash_fwd": layers * n_prefill,
        "paged_decode": layers * n_decode,
    }
    if launches != want or min(want.values()) <= 0:
        raise AssertionError(f"launches {launches} != expected {want}")
    want_paths = {"layer_norm": "cuda", "flash_attention": "cuda",
                  "paged_decode_attention": "cuda"}
    if paths != want_paths:
        raise AssertionError(f"op paths {paths} != {want_paths}")
    # the same requests again: every shape has run once, so this run
    # pays no first-call cost (cuBLAS's choice and loading of a GEMM
    # kernel for each new shape)
    again = serve_once()[1]
    prompt_tokens = sum(PROMPT_LENS)
    rates = {
        "prefill_tokens": prompt_tokens,
        "prefill_s": clock["prefill"],
        "prefill_tokens_per_s": prompt_tokens / clock["prefill"],
        "decode_tokens": clock["decode_tokens"],
        "decode_steps": n_decode,
        "decode_s": clock["decode"],
        "decode_tokens_per_s": clock["decode_tokens"] / clock["decode"],
        "prefill_tokens_per_s_warm": prompt_tokens / again["prefill"],
        "decode_tokens_per_s_warm": again["decode_tokens"] / again["decode"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    log(f"  prefill {rates['prefill_tokens_per_s']:.0f} tokens/s, decode "
        f"{rates['decode_tokens_per_s']:.1f} tokens/s; served again: "
        f"prefill {rates['prefill_tokens_per_s_warm']:.0f}, decode "
        f"{rates['decode_tokens_per_s_warm']:.1f}")
    log("  first tokens:", [r.tokens[:4] for r in reqs])
    return launches, rates, engine


# ---------------------------------------------------------------------------
# phase 3: card engine (bf16) against the CPU engine (f32), 2 layers
# ---------------------------------------------------------------------------


def phase3():
    import torch

    from apex_tpu_torch.models import GptConfig, GptModel
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    log("phase 3: 2-layer full width, card bf16 against CPU f32")
    cfg = GptConfig(num_layers=2)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    card = GptModel(cfg, generator=torch.Generator("cuda").manual_seed(7))
    cpu = GptModel(cpu_cfg, device="cpu")
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in card.state_dict().items()})
    serve = ServeConfig(page_size=16, max_batch=1, max_pages_per_seq=128,
                        num_pages=129)
    e_card = InferenceEngine(cfg, card, serve)
    e_cpu = InferenceEngine(cpu_cfg, cpu, serve, device="cpu")
    rs = np.random.RandomState(1)
    prompt = [int(t) for t in rs.randint(0, cfg.vocab_size, size=256)]
    p_card, p_cpu = e_card.pool.alloc(17), e_cpu.pool.alloc(17)
    lg, tg = e_card.prefill(prompt, p_card[:16])
    lc, tc = e_cpu.prefill(prompt, p_cpu[:16])
    steps = [("prefill", lg.float().cpu(), lc, tg, tc)]
    t_card = np.zeros((1, 128), np.int32)
    t_cpu = np.zeros((1, 128), np.int32)
    t_card[0, :17], t_cpu[0, :17] = p_card, p_cpu
    cur, ctx = tc, len(prompt)
    for i in range(4):
        # both engines are fed the reference's token (teacher forcing),
        # so every step compares the same computation
        lg, ng = e_card.decode(np.array([cur]), np.array([ctx + 1]), t_card)
        lc, nc = e_cpu.decode(np.array([cur]), np.array([ctx + 1]), t_cpu)
        steps.append((f"decode{i}", lg[0].float().cpu(), lc[0], int(ng[0]),
                      int(nc[0])))
        cur, ctx = int(nc[0]), ctx + 1
    worst, same = 0.0, 0
    for name, l_card, l_cpu, tok_card, tok_cpu in steps:
        err = float((l_card - l_cpu).abs().max())
        worst = max(worst, err)
        top = float(l_cpu.max())
        log(f"  {name}: max|logits diff|={err:.4f} token card={tok_card} "
            f"cpu={tok_cpu} cpu top-1 logit={top:.4f}")
        if not torch.isfinite(l_card).all() or err > LOGITS_TOL:
            raise AssertionError(f"{name}: logits differ by {err}")
        if tok_card == tok_cpu:
            same += 1
        elif float(l_cpu[tok_card]) < top - 2 * LOGITS_TOL:
            # a different greedy token is allowed only for a near-tie
            # that the bf16 tolerance itself can flip
            raise AssertionError(
                f"{name}: greedy token {tok_card} != {tok_cpu} and not a "
                f"near-tie"
            )
    log(f"  greedy tokens identical in {same}/{len(steps)} steps; "
        f"worst logits diff {worst:.4f} <= {LOGITS_TOL}")
    return {"same_tokens": same, "steps": len(steps),
            "max_logits_diff": worst}


# ---------------------------------------------------------------------------
# phase 4: timing at the main-path shapes
# ---------------------------------------------------------------------------


def _ln_bytes(rows, hidden, elem, *, bwd):
    """Bytes K1 (x in, y out) or K2 (x, g in, dx out) must move: each
    input read once, each output written once, with the f32 w, b, mu,
    rstd (and K2's f32 dw, db)."""
    n = rows * hidden
    if bwd:
        return 3 * n * elem + 4 * hidden * 4 + 2 * rows * 4
    return 2 * n * elem + 2 * hidden * 4 + 2 * rows * 4


def _attn_live_pairs(s, causal=True):
    return s * (s + 1) // 2 if causal else s * s


def _time_ln(gen, flush, rows, hidden):
    """K1 and K2 at x (rows, hidden) bf16, each beside its plain version
    and the library call (``F.layer_norm`` and its backward, bf16
    affine), with the bounds."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm as ln

    x, w, b = ln_inputs(rows, hidden, gen)
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    n = x.numel()
    fwd = dict(
        ms=time_ms(lambda: ln.layer_norm_fwd(x, w, b, eps=1e-5, rms=False),
                   flush=flush),
        plain_ms=time_ms(lambda: ln.layer_norm_reference(x, w, b, 1e-5, False),
                         flush=flush),
        library_ms=time_ms(lambda: F.layer_norm(x, (hidden,), wb, bb, 1e-5),
                           flush=flush),
    )
    fwd["bound_ms"], fwd["bound_by"] = bound(
        _ln_bytes(rows, hidden, 2, bwd=False), 8 * n, F32_FLOPS)

    _, mu, rstd = ln.layer_norm_reference(x, w, b, 1e-5, False)
    g = torch.randn(rows, hidden, generator=gen, device="cuda").to(x.dtype)
    xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, wb, bb))
    y_lib = F.layer_norm(xr, (hidden,), wr, br, 1e-5)
    bwd = dict(
        ms=time_ms(lambda: ln.layer_norm_bwd(x, w, b, mu, rstd, g, rms=False,
                                             x_is_output=False), flush=flush),
        plain_ms=time_ms(lambda: ln.layer_norm_bwd_reference(
            x, w, b, mu, rstd, g, False, False), flush=flush),
        library_ms=time_ms(lambda: torch.autograd.grad(
            y_lib, (xr, wr, br), g, retain_graph=True), flush=flush),
    )
    bwd["bound_ms"], bwd["bound_by"] = bound(
        _ln_bytes(rows, hidden, 2, bwd=True), 12 * n, F32_FLOPS)
    return fwd, bwd


def _time_attn(gen, flush, bh, s, *, with_bwd):
    """K3 (and K4) at q/k/v (bh, s, 64) causal bf16, beside the plain
    versions and SDPA (``is_causal``; its backward timed on its own),
    with the bounds: 2 products of 2*D flops per live pair forward, 5
    backward (the recompute, dO V^T, P^T dO, dS K, dS^T Q)."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as attn

    d = 64
    q, k, v = attn_inputs(bh, s, s, d, gen)
    live = bh * _attn_live_pairs(s)
    elems = bh * s * d
    fwd = dict(
        ms=time_ms(lambda: attn.flash_fwd(q, k, v, scale=0.125, causal=True),
                   flush=flush),
        plain_ms=time_ms(lambda: attn.mha_reference_with_lse(
            q, k, v, causal=True, scale=0.125), flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, scale=0.125),
            flush=flush),
    )
    fwd["bound_ms"], fwd["bound_by"] = bound(
        2 * 4 * elems + 4 * bh * s, 4 * d * live, BF16_TENSOR_FLOPS)
    if not with_bwd:
        return fwd, None
    do = torch.randn(bh, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = attn.flash_fwd(q, k, v, scale=0.125, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    qr, kr, vr = (t[None].detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                           scale=0.125)
    bwd = dict(
        ms=time_ms(lambda: attn.flash_bwd(q, k, v, do, lse, delta,
                                          scale=0.125, causal=True),
                   flush=flush),
        # the f32 twin materialises five (BH, S, S) f32 score-sized
        # tensors (~10 GB here): fewer runs
        plain_ms=time_ms(lambda: attn.flash_bwd_reference(
            q, k, v, do, lse, delta, scale=0.125, causal=True),
            iters=5, warmup=1, flush=flush),
        library_ms=time_ms(lambda: torch.autograd.grad(
            o_lib, (qr, kr, vr), do[None], retain_graph=True), flush=flush),
    )
    bwd["bound_ms"], bwd["bound_by"] = bound(
        2 * 7 * elems + 2 * 4 * bh * s, 10 * d * live, BF16_TENSOR_FLOPS)
    return fwd, bwd


def phase4(gen, launches, errs):
    """Each kernel at its main-path shapes: the training shapes of phase
    6 (K1, K2 at x (16384, 1024); K3, K4 at BH=128, S=2048) and the
    serving shapes of phase 2 (K1 at (2048, 1024), K3 at BH=16, S=2048,
    K6 at the decode batch).  ``launches`` maps kernel -> {path: count}
    from the phase-2 and phase-6 runs."""
    import torch

    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import paged_attention as pa

    log("phase 4: timing (median of 25 queued runs, L2 flushed before each)")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    train_rows = TRAIN_BATCH * TRAIN_SEQ
    train_bh = TRAIN_BATCH * 16
    rows = {}
    ln_fwd, ln_bwd = _time_ln(gen, flush, train_rows, 1024)
    rows["layer_norm_fwd"] = dict(ln_fwd, shape=f"x ({train_rows}, 1024) bf16")
    rows["layer_norm_bwd"] = dict(ln_bwd, shape=f"x, g ({train_rows}, 1024) bf16")
    torch.cuda.empty_cache()
    at_fwd, at_bwd = _time_attn(gen, flush, train_bh, TRAIN_SEQ, with_bwd=True)
    shape = f"BH={train_bh} S={TRAIN_SEQ} D=64 causal bf16"
    rows["flash_fwd"] = dict(at_fwd, shape=shape)
    rows["flash_bwd"] = dict(at_bwd, shape=shape + ", lse/delta f32")
    torch.cuda.empty_cache()

    serving = {}
    serving["layer_norm_fwd"] = dict(_time_ln(gen, flush, 2048, 1024)[0],
                                     shape="x (2048, 1024) bf16")
    serving["flash_fwd"] = dict(
        _time_attn(gen, flush, 16, 2048, with_bwd=False)[0],
        shape="BH=16 S=2048 D=64 causal bf16")
    xs, ws, bs = ln_inputs(8, 1024, gen)
    log(f"  K1 at the decode shape (8, 1024): "
        f"{time_ms(lambda: ln.layer_norm_fwd(xs, ws, bs, eps=1e-5, rms=False), flush=flush):.4f} ms")

    # K6 at the decode shape of phase 2's batch
    args = paged_inputs(b=8, h=16, d=64, page=16, np_=128, pool=1025,
                        lengths=MAIN_LENGTHS, gen=gen)
    pos = [args[k] for k in ("q", "k_pages", "v_pages", "page_table",
                             "lengths")]
    kw = dict(scale=0.125, rope_cos=args["rope_cos"],
              rope_sin=args["rope_sin"])
    tokens = sum(MAIN_LENGTHS)
    pages = sum(-(-n // 16) for n in MAIN_LENGTHS)
    b_ms, b_by = bound(
        2 * tokens * 16 * 64 * 2 + 2 * 8 * 16 * 64 * 2 + 2 * 8 * 64 * 4
        + 4 * pages + 4 * 8,
        4 * 16 * 64 * tokens, F32_FLOPS,
    )

    def library_paged():
        import torch.nn.functional as F

        from apex_tpu_torch.ops.rope import rotate_half

        qf = args["q"].float()
        qr = (qf * args["rope_cos"][:, None] + rotate_half(qf)
              * args["rope_sin"][:, None]).to(torch.bfloat16)
        table = args["page_table"].long()
        kk = args["k_pages"][table].transpose(1, 2).reshape(8, 16, -1, 64)
        vv = args["v_pages"][table].transpose(1, 2).reshape(8, 16, -1, 64)
        mask = (torch.arange(kk.shape[2], device="cuda")[None]
                < args["lengths"][:, None])[:, None, None]
        return F.scaled_dot_product_attention(qr[:, :, None], kk, vv,
                                              attn_mask=mask, scale=0.125)

    serving["paged_decode"] = dict(
        shape="B=8 H=16 D=64 page=16 NP=128 bf16, "
        f"lengths {MAIN_LENGTHS}",
        ms=time_ms(lambda: pa.paged_decode_fwd(*pos, **kw), flush=flush),
        plain_ms=time_ms(
            lambda: pa.paged_decode_attention_reference(*pos, **kw),
            flush=flush),
        library_ms=time_ms(library_paged, flush=flush),
        bound_ms=b_ms, bound_by=b_by,
    )

    def fields(r):
        return {key: r[key] for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "shape")}

    kernels = []
    for name in ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                 "flash_bwd", "paged_decode"):
        main = rows.get(name, serving.get(name))
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"apex_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name],
            "max_abs_err": errs[name],
            **fields(main),
        }
        if name in rows and name in serving:
            entry["serving_shape"] = fields(serving[name])
        kernels.append(entry)
        for tag, r in (("", main), (" (serving)", entry.get("serving_shape"))):
            if r is None:
                continue
            log(f"  {name}{tag} [{r['shape']}]: kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    return kernels


def device_kernels(prof):
    """(name, self device us, launches) of every kernel a
    ``torch.profiler`` run recorded, without the GPU ranges of user
    annotations (``Optimizer.step#...``), which overlap the kernels they
    enclose and would count their time twice."""
    from torch.autograd import DeviceType

    return [
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]


#: kernel-name fragments -> the layer that owns the time (phase 6)
KERNEL_GROUPS = (
    ("K3 flash_fwd", ("flash_fwd_kernel",)),
    ("K4 flash_bwd", ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")),
    ("K1 layer_norm_fwd", ("ln_fwd_kernel",)),
    ("K2 layer_norm_bwd", ("ln_bwd_kernel",)),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "xmma", "cutlass")),
)


def group_kernels(kernels):
    """Device ms per layer: the kernel groups above, then the rest
    (elementwise, copies, reductions, the optimizer's foreach kernels)."""
    out = {name: 0.0 for name, _ in KERNEL_GROUPS}
    out["other"] = 0.0
    for key, us, _ in kernels:
        name = next((g for g, frags in KERNEL_GROUPS
                     if any(f in key for f in frags)), "other")
        out[name] += us / 1e3
    return out


# ---------------------------------------------------------------------------
# phase 5: where the decode step's time goes
# ---------------------------------------------------------------------------


def phase5(engine):
    """Decode iterations at batch 8 (full width, contexts ~512): the host
    time of 4 unprofiled iterations, then a torch.profiler trace of 4
    more — the summed device time of the kernels they ran, the kernels
    that took most, and where the host time went: inside PyTorch ops and
    CUDA runtime calls (self CPU time, by op) or in Python outside them
    (scheduler, engine, the ctypes calls of the kernel wrappers)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.serve import ContinuousBatchingScheduler, Request

    log("phase 5: decode iterations at batch 8, unprofiled then profiled")
    rs = np.random.RandomState(2)
    sched = ContinuousBatchingScheduler(engine)
    steps = 4
    for _ in range(8):
        sched.submit(Request(
            prompt=[int(t) for t in rs.randint(0, engine.cfg.vocab_size,
                                               size=512)],
            max_new_tokens=2 * steps + 2,
        ))
    sched.step()  # the 8 prefills and the first decode, not timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        sched.step()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sched.run()
    kernels = device_kernels(prof)
    host_ops = [
        (e.key, e.self_cpu_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0
    ]
    in_ops_ms = sum(o[1] for o in host_ops) / 1e3 / steps
    out = {
        "host_ms_per_step_unprofiled": plain_ms,
        "host_ms_per_step": wall * 1e3 / steps,
        "host_ms_per_step_in_ops": in_ops_ms,
        "host_ms_per_step_outside_ops": wall * 1e3 / steps - in_ops_ms,
    }
    log(f"  host {plain_ms:.3f} ms/step unprofiled; profiled "
        f"{out['host_ms_per_step']:.3f} ms/step, of which "
        f"{in_ops_ms:.3f} inside PyTorch ops and runtime calls (self CPU "
        f"time) and {out['host_ms_per_step_outside_ops']:.3f} outside them")
    for key, us, count in sorted(host_ops, key=lambda o: -o[1])[:10]:
        log(f"    host {us / steps / 1e3:8.4f} ms/step  {count // steps:4d}x  "
            f"{key[:80]}")
    if not kernels:
        log("  the profiler recorded no device kernels: device time not "
            "measured")
        return out
    busy_us = sum(k[1] for k in kernels)
    launches = sum(k[2] for k in kernels)
    out.update({
        "device_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_busy_share_unprofiled": busy_us / 1e3 / steps / plain_ms,
        "kernel_launches_per_step": launches / steps,
    })
    log(f"  device kernels {out['device_ms_per_step']:.3f} ms/step, busy "
        f"share {out['device_busy_share']:.3f} profiled and "
        f"{out['device_busy_share_unprofiled']:.3f} against the unprofiled "
        f"host time, {out['kernel_launches_per_step']:.0f} kernel "
        f"launches/step")
    for key, us, count in sorted(kernels, key=lambda k: -k[1])[:8]:
        log(f"    {us / steps / 1e3:8.4f} ms/step  {count // steps:4d}x  "
            f"{key[:90]}")
    return out


# ---------------------------------------------------------------------------
# phase 6: the training slice at full width
# ---------------------------------------------------------------------------


TRAIN_BATCH = 8
TRAIN_SEQ = 2048
TRAIN_STEPS = 8
TRAIN_LR = 3e-4


def phase6():
    """``examples.train_gpt`` (its ``train``, which ``main`` wraps) at
    ``GptConfig(remat=True)``, seq 2048, batch 8, 8 steps, lr 3e-4 on the
    synthetic zipf corpus it writes to the temporary directory.  Per
    step with full remat, L layers: K1 runs 2L+1 times forward and 2L
    again in the recompute, K2 2L+1 times, K3 L + L times and K4 L
    times; every count must be exactly that times the steps.  Then one
    more step under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.ops import _dispatch

    log(f"phase 6: train GptConfig(remat=True) {TRAIN_STEPS} steps at "
        f"batch {TRAIN_BATCH}, seq {TRAIN_SEQ}")
    args = train_gpt.parse_args([
        "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
        "--seq-len", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
    ])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    run = train_gpt.train(args)
    torch.cuda.synchronize()
    launches = _dispatch.launches()
    paths = _dispatch.last_paths()
    peak = torch.cuda.max_memory_allocated()
    layers = run.cfg.num_layers
    per_step = {"layer_norm_fwd": 2 * (2 * layers) + 1,
                "layer_norm_bwd": 2 * layers + 1,
                "flash_fwd": 2 * layers, "flash_bwd": layers}
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    log(f"  launches={launches} (per step {per_step}) paths={paths}")
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")
    if paths != {"layer_norm": "cuda", "flash_attention": "cuda"}:
        raise AssertionError(f"training op paths {paths}")
    losses = run.losses
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    n_params = sum(p.numel() for p in run.model.parameters())
    step_s = statistics.median(run.step_seconds[1:])
    tokens_per_s = run.tokens_per_step / step_s
    mfu = 6 * n_params * run.tokens_per_step / step_s / BF16_TENSOR_FLOPS
    log(f"  losses {[round(x, 4) for x in losses]}")
    log(f"  step seconds {[round(x, 4) for x in run.step_seconds]}; median "
        f"of steps 1.. {step_s * 1e3:.1f} ms, {tokens_per_s:.0f} tokens/s, "
        f"6NT MFU {mfu:.4f} (N={n_params}), peak memory {peak / 1e9:.2f} GB")

    ids = next(run.batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_gpt.train_step(run.model, run.optimizer, ids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = sorted(device_kernels(prof), key=lambda o: -o[1])
    busy_ms = sum(o[1] for o in ops) / 1e3
    groups = group_kernels(ops)
    log(f"  profiled step: {wall * 1e3:.1f} ms host, {busy_ms:.1f} ms of "
        f"device kernels ({busy_ms / (wall * 1e3):.3f} busy), "
        f"{sum(o[2] for o in ops)} kernel launches")
    log("  device ms by layer: " + ", ".join(
        f"{k} {v:.2f}" for k, v in groups.items()))
    top = []
    for key, us, count in ops[:15]:
        log(f"    {us / 1e3:9.3f} ms  {count:5d}x  {key[:100]}")
        top.append({"op": key[:100], "ms": us / 1e3, "count": count})
    out = {
        "losses": losses,
        "step_seconds": run.step_seconds,
        "step_ms_median": step_s * 1e3,
        "tokens_per_step": run.tokens_per_step,
        "tokens_per_s": tokens_per_s,
        "params": n_params,
        "mfu_6nt": mfu,
        "peak_memory_bytes": peak,
        "profiled_step_ms": wall * 1e3,
        "profiled_device_ms": busy_ms,
        "device_ms_by_layer": groups,
        "top_device_ops": top,
    }
    del run
    torch.cuda.empty_cache()
    return launches, out


# ---------------------------------------------------------------------------
# phase 7: one training step, card bf16 against CPU f32, 2 layers
# ---------------------------------------------------------------------------


#: The phase-7 limits sit between sound and faulty readings of the same
#: comparison.  Sound: an H100 read a loss 5.5e-5 off the CPU's, a worst
#: per-parameter gradient error of 1.27% and a worst mean |Δ update| of
#: 9.0e-6 to 9.6e-6; the CPU path in bf16 against the CPU in f32 (other
#: random weights) reads 2.3e-4, 1.29% and 8.9e-6.  Faulty, each against
#: the sound CPU f32 step with one plain twin altered: K3 dropping the
#: second 64-key tile for the last 64 rows moves the loss by 3.2e-3 and
#: a gradient by 38%; K4 dropping that tile in the dQ pass moves a
#: gradient by 14% (mean |Δ update| 2.9e-5), in the dK/dV pass by 22%;
#: K2 dropping the mean(g·w) term of dx moves one by 4.8%.
#: |loss(card bf16) - loss(CPU f32)|: the loss is ~11 (ln 50304)
LOSS_TOL = 1e-3
#: per parameter, ||grad_card - grad_cpu|| / ||grad_cpu||
GRAD_REL_TOL = 2.5e-2
#: Adam's first step moves each weight by -lr * g / (|g| + eps), i.e.
#: by ±lr: an element whose gradient sign differs between the two runs
#: moves 2*lr apart and no element moves further; such sign flips are
#: rare (they need |g| within the gradient error), so the mean |Δ update|
#: over a parameter's elements stays small
ADAM_MAX_TOL = 2 * TRAIN_LR * (1 + 1e-3)
ADAM_MEAN_TOL = 2e-5


def phase7():
    """GptConfig at full width with 2 layers, B=2, S=256: the loss, every
    parameter's gradient and the weights after one FusedAdam step on the
    card (bf16 compute, kernels K1-K4) against the CPU (f32, the plain
    versions), from the same f32 weights and the same batch."""
    import torch

    from apex_tpu_torch.models import GptConfig, GptModel, gpt_lm_loss
    from apex_tpu_torch.optimizers import FusedAdam

    log("phase 7: 2-layer full width training step, card bf16 against "
        "CPU f32")
    cfg = GptConfig(num_layers=2, max_seq_len=256)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    card = GptModel(cfg, generator=torch.Generator("cuda").manual_seed(11))
    cpu = GptModel(cpu_cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(256, 2)).astype(np.int64))
    results = {}
    for name, model, dev_ids in (("card", card, ids.cuda()), ("cpu", cpu, ids)):
        before = {k: p.detach().clone().cpu()
                  for k, p in model.named_parameters()}
        opt = FusedAdam(model.parameters(), lr=TRAIN_LR)
        loss = gpt_lm_loss(model, dev_ids)
        loss.backward()
        grads = {k: p.grad.detach().float().cpu()
                 for k, p in model.named_parameters()}
        opt.step()
        updates = {k: p.detach().cpu() - before[k]
                   for k, p in model.named_parameters()}
        results[name] = (float(loss.detach()), grads, updates)
    (l_card, g_card, u_card), (l_cpu, g_cpu, u_cpu) = (results["card"],
                                                        results["cpu"])
    log(f"  loss card={l_card:.6f} cpu={l_cpu:.6f} diff={abs(l_card - l_cpu):.2e} "
        f"tol={LOSS_TOL}")
    if not np.isfinite(l_card) or abs(l_card - l_cpu) > LOSS_TOL:
        raise AssertionError("phase 7: the losses disagree")
    worst_grad, worst_max, worst_mean = 0.0, 0.0, 0.0
    for k in g_cpu:
        rel = float((g_card[k] - g_cpu[k]).norm() / g_cpu[k].norm().clamp_min(1e-30))
        du = (u_card[k] - u_cpu[k]).abs()
        worst_grad = max(worst_grad, rel)
        worst_max = max(worst_max, float(du.max()))
        worst_mean = max(worst_mean, float(du.mean()))
        if rel > GRAD_REL_TOL:
            raise AssertionError(f"phase 7: grad of {k} off by {rel:.3e}")
    log(f"  worst per-parameter grad relative error {worst_grad:.3e} "
        f"(tol {GRAD_REL_TOL}); after one Adam step: worst max |Δ update| "
        f"{worst_max:.3e} (tol {ADAM_MAX_TOL:.3e}), worst mean |Δ update| "
        f"{worst_mean:.3e} (tol {ADAM_MEAN_TOL:.3e})")
    if worst_max > ADAM_MAX_TOL or worst_mean > ADAM_MEAN_TOL:
        raise AssertionError("phase 7: the Adam updates disagree")
    return {"loss_card": l_card, "loss_cpu": l_cpu,
            "max_grad_rel_err": worst_grad, "max_update_diff": worst_max,
            "max_mean_update_diff": worst_mean}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
            "is False"
        )
    from apex_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            spills = "spill stores" in line and "0 bytes spill stores" not in line
            if "registers" in line or spills:
                log(f"  [{name}] {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = phase1(gen)
    serve_launches, rates, engine = phase2()
    cross = phase3()
    train_launches, training = phase6()
    train_cross = phase7()
    launches = {
        name: {path: counts[name] for path, counts in
               (("serving", serve_launches), ("training", train_launches))
               if name in counts}
        for name in _build.KERNELS
    }
    kernels = phase4(gen, launches, errs)
    profile = phase5(engine)
    log(json.dumps({"serving": rates, "cross_check": cross,
                    "training": training, "training_cross_check": train_cross,
                    "decode_profile": profile}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()

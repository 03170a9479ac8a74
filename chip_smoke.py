#!/usr/bin/env python3
"""Bring-up check of apex_tpu_torch on one NVIDIA GPU (H100).

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``apex_tpu_torch/csrc`` (set-up
time) and then runs five phases; any failure raises and the exit code is
non-zero.  Without a CUDA device it exits non-zero at once and prints no
result.

1. Each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it and at one ragged shape each, within
   a stated bf16 tolerance.
2. The slice: ``GptConfig()`` at full width (bf16, seeded random
   weights) behind ``InferenceEngine`` + ``ContinuousBatchingScheduler``
   answers 8 greedy requests (prompts of 17..1900 tokens, 32 new tokens
   each).  The launch counters are zeroed just before and read just
   after: K1, K3 and K6 must each have launched, exactly as often as the
   prefill and decode calls require, and every op must have taken the
   kernel path.  The page pool must end empty.
3. Whole-path cross-check: at full width with 2 layers, one 256-token
   prefill and 4 decode steps through the card engine (bf16) against the
   CPU engine (f32, the same weights), fed the same tokens.
4. Timing at the main-path shapes: each kernel, its plain version and
   one PyTorch library call computing the same function (the yardstick,
   never used by the port), with the least time the card could take.
5. Decode at batch 8, full width: host time per iteration unprofiled,
   then a ``torch.profiler`` trace of 4 iterations — the device time of
   their kernels (the device's busy share), the kernels that took most,
   and the host side split into the time inside PyTorch ops and runtime
   calls (by op) and the Python time outside them.

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
#: phase 3: bf16 card engine vs f32 CPU engine on 2-layer logits (logit
#: std ~0.64; a CPU bf16-vs-f32 run of the same check gives ~0.02)
LOGITS_TOL = 0.06

REPLACES = {
    "layer_norm_fwd": "apex_tpu/ops/pallas/layer_norm.py:237",
    "flash_fwd": "apex_tpu/ops/pallas/flash_attention.py:615",
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
    from apex_tpu_torch.ops import attention as attn
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import paged_attention as pa

    log("phase 1: kernels against their plain versions")
    errs = {}
    for rows, hidden, rms in ((2048, 1024, False), (8, 1024, False),
                              (2048, 1024, True), (37, 1000, False)):
        x, w, b = ln_inputs(rows, hidden, gen)
        y, mu, rstd = ln.layer_norm_fwd(x, w, b, eps=1e-5, rms=rms)
        y_r, mu_r, rstd_r = ln.layer_norm_reference(x, w, b, 1e-5, rms)
        tag = f"K1 layer_norm_fwd rows={rows} hidden={hidden} rms={rms}"
        e = compare(tag + " y", y, y_r, BF16_TOL)
        compare(tag + " mu", mu, mu_r, F32_TOL)
        compare(tag + " rstd", rstd, rstd_r, F32_TOL)
        if (rows, hidden, rms) == (2048, 1024, False):
            errs["layer_norm_fwd"] = e

    for bh, sq, sk in ((16, 16, 16), (16, 1024, 1024), (16, 2048, 2048),
                       (4, 200, 200), (4, 64, 192), (2, 96, 40)):
        q, k, v = attn_inputs(bh, sq, sk, 64, gen)
        o, lse = attn.flash_fwd(q, k, v, scale=0.125, causal=True)
        o_r, lse_r = attn.mha_reference_with_lse(
            q[None], k[None], v[None], causal=True, scale=0.125
        )
        tag = f"K3 flash_fwd BH={bh} Sq={sq} Sk={sk} D=64 causal"
        e = compare(tag + " o", o, o_r[0], BF16_TOL)
        compare(tag + " lse", lse, lse_r[0], F32_TOL)
        if (sq, sk) == (2048, 2048):
            errs["flash_fwd"] = e

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

    clock = {"prefill": 0.0, "decode": 0.0, "decode_tokens": 0}
    prefill, decode = engine.prefill, engine.decode

    def timed_prefill(*a, **k):
        t = time.perf_counter()
        out = prefill(*a, **k)  # returns a host token: synchronised
        clock["prefill"] += time.perf_counter() - t
        return out

    def timed_decode(tokens, lengths, *a, **k):
        t = time.perf_counter()
        out = decode(tokens, lengths, *a, **k)  # host tokens: synchronised
        clock["decode"] += time.perf_counter() - t
        clock["decode_tokens"] += int((np.asarray(lengths) > 0).sum())
        return out

    engine.prefill, engine.decode = timed_prefill, timed_decode
    rs = np.random.RandomState(0)
    sched = ContinuousBatchingScheduler(engine)
    reqs = [
        sched.submit(Request(
            prompt=[int(t) for t in rs.randint(0, cfg.vocab_size, size=n)],
            max_new_tokens=NEW_TOKENS,
        ))
        for n in PROMPT_LENS
    ]
    prefills0, decodes0 = engine.prefill_calls, engine.decode_iters
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    sched.run()
    torch.cuda.synchronize()
    launches = _dispatch.launches()
    paths = _dispatch.last_paths()
    engine.prefill, engine.decode = prefill, decode

    n_prefill = engine.prefill_calls - prefills0
    n_decode = engine.decode_iters - decodes0
    log(f"  prefill_calls={n_prefill} decode_iters={n_decode} "
        f"launches={launches} paths={paths}")
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
    prompt_tokens = sum(PROMPT_LENS)
    rates = {
        "prefill_tokens": prompt_tokens,
        "prefill_s": clock["prefill"],
        "prefill_tokens_per_s": prompt_tokens / clock["prefill"],
        "decode_tokens": clock["decode_tokens"],
        "decode_steps": n_decode,
        "decode_s": clock["decode"],
        "decode_tokens_per_s": clock["decode_tokens"] / clock["decode"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
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


def phase4(gen, launches, errs):
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as attn
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import paged_attention as pa

    log("phase 4: timing (median of 25 queued runs, L2 flushed before each)")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    rows = []

    # K1 at the prefill shape
    x, w, b = ln_inputs(2048, 1024, gen)
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    n = x.numel()
    b_ms, b_by = bound(2 * n * 2 + 2 * 1024 * 4 + 2 * 2048 * 4, 8 * n,
                       F32_FLOPS)
    rows.append(dict(
        name="layer_norm_fwd", shape="x (2048, 1024) bf16",
        ms=time_ms(lambda: ln.layer_norm_fwd(x, w, b, eps=1e-5, rms=False),
                   flush=flush),
        plain_ms=time_ms(lambda: ln.layer_norm_reference(x, w, b, 1e-5, False),
                         flush=flush),
        library_ms=time_ms(lambda: F.layer_norm(x, (1024,), wb, bb, 1e-5),
                           flush=flush),
        bound_ms=b_ms, bound_by=b_by,
    ))
    xs, ws, bs = ln_inputs(8, 1024, gen)
    log(f"  K1 at the decode shape (8, 1024): "
        f"{time_ms(lambda: ln.layer_norm_fwd(xs, ws, bs, eps=1e-5, rms=False), flush=flush):.4f} ms")

    # K3 at the longest prefill bucket
    bh, s, d = 16, 2048, 64
    q, k, v = attn_inputs(bh, s, s, d, gen)
    live = s * (s + 1) // 2
    b_ms, b_by = bound(2 * (4 * bh * s * d) + 4 * bh * s,
                       4 * bh * d * live, BF16_TENSOR_FLOPS)
    rows.append(dict(
        name="flash_fwd", shape="BH=16 S=2048 D=64 causal bf16",
        ms=time_ms(lambda: attn.flash_fwd(q, k, v, scale=0.125, causal=True),
                   flush=flush),
        plain_ms=time_ms(lambda: attn.mha_reference_with_lse(
            q[None], k[None], v[None], causal=True, scale=0.125),
            flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, scale=0.125),
            flush=flush),
        bound_ms=b_ms, bound_by=b_by,
    ))

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

    rows.append(dict(
        name="paged_decode", shape="B=8 H=16 D=64 page=16 NP=128 bf16, "
        f"lengths {MAIN_LENGTHS}",
        ms=time_ms(lambda: pa.paged_decode_fwd(*pos, **kw), flush=flush),
        plain_ms=time_ms(
            lambda: pa.paged_decode_attention_reference(*pos, **kw),
            flush=flush),
        library_ms=time_ms(library_paged, flush=flush),
        bound_ms=b_ms, bound_by=b_by,
    ))
    kernels = []
    for r in rows:
        name = r["name"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"apex_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": r["shape"],
        })
        log(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return kernels


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
    kernels = [
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
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
    launches, rates, engine = phase2()
    cross = phase3()
    kernels = phase4(gen, launches, errs)
    profile = phase5(engine)
    log(json.dumps({"serving": rates, "cross_check": cross,
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

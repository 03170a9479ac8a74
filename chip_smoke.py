#!/usr/bin/env python3
"""Bring-up check of apex_tpu_torch on one NVIDIA GPU (H100).

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``apex_tpu_torch/csrc`` (set-up
time, one ``nvcc`` per source, all started together) and then runs
eleven phases; any failure raises and the exit code is non-zero.  Without
a CUDA device it exits non-zero at once and prints no result.

1. Each kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it and at ragged shapes,
   within a stated tolerance: K1 (LayerNorm forward), K2 (its backward,
   with rms and memory_efficient), K3 (flash forward), K4 (flash
   backward: Sq != Sk both ways, fully-masked rows, non-causal, dlse)
   and K6 (paged decode).  K3 and K4 again with their bias and dropout
   operands: BERT's shape with its key-padding bias over ragged lengths
   and a fully masked row, with and without dropout 0.1, every other
   bias layout at smaller shapes, and biases whose S_k is not a multiple
   of 4 at D = 32 and 64; the dropout keep masks of K3 and of both K4
   passes read back bit for bit against the twin's; and K3 and K4 run
   twice at the GPT and triangle shapes, where both runs must give the
   same bits.  K5
   (the bias gradient) at the evoformer's two biased shapes and in every
   (G, RS) layout, causal and not, Sq != Sk both ways, ragged, with
   dropout, D = 32 and 64 (no model launches it: the phase-1 count is
   its check), and at every G = BH, RS = Sq case the fused call
   (``flash_bwd_dbias``: K4 writing K5's dbias from its dQ pass, the
   route of every trainable bias of the models), also at S_k odd, causal
   Sq > Sk (exact zeros at the masked pairs), D = 128 and 256, its
   triangle output run twice for the same bits and a halved tile
   rejected; K3 and K4 at D = 32, the triangle shape
   with its G = BH bias included.  K3, K4 and K5 at D = 128, 256 and 384
   (the wide instance) in every bias mode and with dropout, at D = 48,
   96, 160 and 320 (padded by the wrappers to 64, 128, 256 and 384), and
   their f32 instances at D 32, 64, 96, 128, 192, 320, 384 and the
   evoformer's triangle, MSA row and MSA column shapes, each beside a
   TF32 control that must fail the f32 limit by more than 10x; K6 at D
   34, 60, 80, 96, 128, 160, 192, 256 and 320 (int8, f32 and bf16 pages,
   RoPE, every copy width) and at lengths that straddle its splits (0, 1, a
   split, a split + 1, NP x page), the decode batch run twice for the
   same bits; K1 and K2
   also at widths 1001 (rows off 16-byte boundaries), 130 f32, 12288
   (streamed), 64 and 33 (several rows a warp).
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
4. Timing at the main-path shapes (training, BERT, the evoformer's
   triangle, MSA row and MSA column attention, and serving), and K1/K2
   at the evoformer's f32 rows, K3/K4 at the reference's long-context
   shape (BH 8, S 16384, D 128, causal) and at D = 256 (BH 32, S 2048,
   causal), K3, K4 and K5 at D = 384 (BH 32, S 2048; K3/K4 causal), K6
   at phase 1's short lengths, the fused K4 + K5 call at the triangle
   and MSA row shapes beside K4 alone and K5 alone, and the f32
   instances of K3-K5 at the
   triangle, MSA row and MSA column shapes: each kernel,
   its plain version and one PyTorch library call computing the same
   function (the yardstick, never used by the port), with the least time
   the card could take.
5. Decode at batch 8, full width: host time per iteration unprofiled,
   then a ``torch.profiler`` trace of 4 iterations — the device time of
   their kernels (the device's busy share), K6's share of it and its
   launches per step, the kernels that took most,
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
8. BERT-Large pretraining: ``python -m
   apex_tpu_torch.examples.pretrain_bert``'s ``train`` at
   ``BertConfig(remat=True)``, batch 128, seq 128, 20 masked predictions
   per sequence, FusedLAMB, 8 steps, then 2 steps with dropout through
   the same ``train_step``; exact K1-K4 counts for each run, losses
   finite and falling; step time, sequences/s, tokens/s, 6NT MFU, peak
   memory and one profiled step by layer.
9. BERT cross-check: 2 layers at full width, B=4, S=128, attention_mask
   lengths 128/100/37/0, attention dropout 0.1 with the same seeds on
   both sides — the loss, every gradient and the weights after one
   FusedLAMB step, card (bf16) against CPU (f32).
10. Evoformer training: 4 ``EvoformerBlock``s at AlphaFold2's widths
    (OpenFold's c_m 256, c_z 128, 4 heads) on N_seq 128 x N_res 256,
    MSE to seeded targets, FusedAdam, 8 steps; exact K1-K4 counts and
    the fused K4 + K5 call's (3 of 4 attention backwards a block-step),
    losses finite and falling; step time, analytic MFU, peak memory and
    one profiled step by layer.  Then the same 4 blocks with f32
    attention (the JAX module's precision) for 8 steps: exact counts of
    K1, K2 and the f32 instances of K3-K5, losses falling, step time and
    one profiled step by layer, with K5 f32's share of its kernel time.
11. Evoformer cross-check: one full-width block at N_res 64, N_seq 32 —
    the loss, every gradient and the weights after one FusedAdam step,
    card (bf16 attention) against CPU (f32), and a planted fault (K5's
    twin halved) that must fail the same limits.

The phases run in the order 1, 2, 3, 6, 7, 8, 9, 10, 11, 4, 5.
The line before the last is a JSON object of the kernels (every C entry
point, the f32 instances included); the last line is ``{"ok": true,
"device": {...}}``.

    python3 chip_smoke.py --f32-attention

times only the f32 instances of K3-K5 (phase 4's rows at the evoformer's
three shapes) and runs phase 10's f32 training, and prints them as one
JSON line: copied beside another tree's ``apex_tpu_torch`` it times that
tree's kernels with this script's timing code, for a comparison of two
commits.

    python3 chip_smoke.py --timing

runs phase 4 alone (no launch counts, no phase-1 errors) and prints its
rows as one JSON line, for the same kind of comparison; the D = 384 rows
of a tree whose kernels refuse that head dim (an older one) are logged
as refused and left out.

    python3 chip_smoke.py --phase1

runs phase 1 alone (every kernel against its plain version) and prints
the errors as one JSON line: the quick check of a kernel's first build.

    python3 chip_smoke.py --evoformer

runs phase 10's bf16 evoformer training alone (its launches logged, not
checked, so that the script can time an older tree's kernels too) and
prints it as one JSON line: the step times and the profiled step's
kernel time by layer.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet, dense): the bound_ms basis
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
TF32_TENSOR_FLOPS = 495e12
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
#: the f32 instances of K3, K4 and K5 (csrc/flash_f32.cu) against their
#: f32 twins, on inputs drawn in full f32: FFMA products, and sums in
#: another order than cuBLAS's.  The control that must fail is the same
#: twin with q, k and v rounded to TF32 and its products on TF32 (what a
#: kernel on bf16 or TF32 tensor cores would compute): phase 1 checks that
#: each f32 case's control fails this limit.  The limit sits between the
#: two, about a factor of 20 from each on an H100: phase 1 logs both
#: readings as "worst err/allowance" (PERF.md).
F32_ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
#: K2's dw/db: f32 sums over up to 65536 rows (|sum| up to ~1000) taken
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

#: BERT-Large phase-1 pretraining (``bench.py::bench_bert_lamb``): batch
#: 128, seq 128
BERT_BATCH = 128
BERT_SEQ = 128

REPLACES = {
    "layer_norm_fwd": "apex_tpu/ops/pallas/layer_norm.py:237",
    "layer_norm_bwd": "apex_tpu/ops/pallas/layer_norm.py:258",
    "flash_fwd": "apex_tpu/ops/pallas/flash_attention.py:615",
    "flash_bwd": "apex_tpu/ops/pallas/flash_attention.py:873",
    "flash_dbias": "apex_tpu/ops/pallas/flash_attention.py:1108",
    # K5's function (flash_dbias, its pallas_call at :1197) as the
    # epilogue of K4's dQ pass (csrc/flash_bwd.cu), with K4's outputs
    "flash_bwd_dbias": "apex_tpu/ops/pallas/flash_attention.py:1108",
    "paged_decode": "apex_tpu/ops/pallas/decode_attention.py:263",
    # the f32 instances of K3, K4 and K5 (csrc/flash_f32.cu): the same
    # Pallas kernels on f32 inputs, at Precision.HIGHEST
    "flash_fwd_f32": "apex_tpu/ops/pallas/flash_attention.py:615",
    "flash_bwd_f32": "apex_tpu/ops/pallas/flash_attention.py:873",
    "flash_dbias_f32": "apex_tpu/ops/pallas/flash_attention.py:1108",
}
#: every kernel's C entry point, as the launch counters name them
KERNEL_ENTRIES = tuple(REPLACES)
#: entries that no main path launches, each held to its twin in phase 1
#: instead: the standalone bf16 K5, because every trainable bias of the
#: ported models is G = BH, RS = Sq, whose gradient leaves K4's dQ pass
#: (flash_bwd_dbias); K5 serves the other layouts and the wide head dims
PHASE1_ONLY_ENTRIES = ("flash_dbias",)


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
    allowed = tol["atol"] + tol["rtol"] * ref.abs()
    ratio = float((err / allowed).max()) if err.numel() else 0.0
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"worst err/allowance={ratio:.3e} tol={tol} "
        f"{'ok' if ok else 'FAIL'}")
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
    """Each kernel against its plain version on the card; returns the
    errors that go into the kernels line."""
    log("phase 1: kernels against their plain versions")
    errs = {"layer_norm_fwd": phase1_ln_fwd(gen),
            "flash_fwd": phase1_flash_fwd(gen)}
    errs["layer_norm_bwd"] = phase1_ln_bwd(gen)
    errs["flash_bwd"] = phase1_flash_bwd(gen)
    phase1_flash_operands(gen)
    phase1_dropout_mask(gen)
    errs.update(phase1_head_dims(gen))
    errs["paged_decode"] = phase1_paged(gen)
    return errs


def phase1_ln_fwd(gen):
    """K1 against its twin: y under BF16_TOL (bf16) or F32_TOL (f32), mu
    and rstd under F32_TOL.  Returns max |y - y_ref| at the training
    shape."""
    from apex_tpu_torch.ops import layer_norm as ln

    main_err = None
    # the training shape first (its error goes into the kernels line),
    # then the prefill shape, the decode batch, RMS, a ragged row, the
    # evoformer's f32 rows (MSA 128 x 256 rows of 256, pair 256 x 256
    # rows of 128, eps 1e-6), an odd bf16 width (1001: every row but
    # every eighth starts off a 16-byte boundary, so one element per
    # load), an f32 width of 130 (520 bytes, also one element per load),
    # a wide row that streams (12288 > 32 lanes x 32 values) and narrow
    # rows that share a warp (64 bf16: 8 lanes a row; 33 f32: 16)
    for rows, hidden, rms, dt, eps in (
            (TRAIN_BATCH * TRAIN_SEQ, 1024, False, "bf16", 1e-5),
            (2048, 1024, False, "bf16", 1e-5), (8, 1024, False, "bf16", 1e-5),
            (2048, 1024, True, "bf16", 1e-5), (37, 1000, False, "bf16", 1e-5),
            (EVO_SEQ * EVO_RES, 256, False, "f32", 1e-6),
            (EVO_RES * EVO_RES, 128, False, "f32", 1e-6),
            (1000, 1001, False, "bf16", 1e-5), (999, 130, True, "f32", 1e-6),
            (64, 12288, False, "bf16", 1e-5), (300, 64, False, "bf16", 1e-5),
            (301, 33, False, "f32", 1e-6)):
        x, w, b = ln_inputs(rows, hidden, gen)
        if dt == "f32":
            x = x.float()
        y, mu, rstd = ln.layer_norm_fwd(x, w, b, eps=eps, rms=rms)
        y_r, mu_r, rstd_r = ln.layer_norm_reference(x, w, b, eps, rms)
        tag = (f"K1 layer_norm_fwd rows={rows} hidden={hidden} {dt} "
               f"rms={rms}")
        e = compare(tag + " y", y, y_r,
                    BF16_TOL if dt == "bf16" else F32_TOL)
        compare(tag + " mu", mu, mu_r, F32_TOL)
        compare(tag + " rstd", rstd, rstd_r, F32_TOL)
        if main_err is None:
            main_err = e
    return main_err


def phase1_flash_fwd(gen):
    """K3 against its twin at D = 64, causal: the training shape (BH =
    batch x heads, run twice for the same bits) first, then the prefill
    shapes and ragged and Sq != Sk cases.  Returns the training shape's
    error."""
    import torch

    from apex_tpu_torch.ops import attention as attn

    main_err = None
    for bh, sq, sk in ((TRAIN_BATCH * 16, TRAIN_SEQ, TRAIN_SEQ),
                       (16, 16, 16), (16, 1024, 1024), (16, 2048, 2048),
                       (4, 200, 200), (4, 64, 192), (2, 96, 40)):
        q, k, v = attn_inputs(bh, sq, sk, 64, gen)
        out = attn.flash_fwd(q, k, v, scale=0.125, causal=True)
        ref = attn.flash_fwd_reference(q, k, v, scale=0.125, causal=True)
        tag = f"K3 flash_fwd BH={bh} Sq={sq} Sk={sk} D=64 causal"
        e = check_k3(tag, out, ref)
        if main_err is None:
            main_err = e
            check_repeat(tag, out, attn.flash_fwd(q, k, v, scale=0.125,
                                                  causal=True))
        del out, ref
        torch.cuda.empty_cache()
    return main_err


def phase1_paged(gen):
    """K6 against its twin under K6_TOL, idle slots exactly zero.
    Returns the decode batch's error."""
    from apex_tpu_torch.ops import paged_attention as pa

    main_err = None
    # the decode batch (32 splits a row, run twice for the same bits),
    # int8 pages, f32 pages (one split a row), then head dims past the
    # main path's 64, all with the fused RoPE: 96 and 128 with int8 pages
    # and bf16 pages, 80 and 48, which are no multiple of 32, and 256,
    # 192 and 160, past 128; then lengths that straddle the splits
    cases = (
        ("bf16", dict(b=8, h=16, d=64, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS)),
        ("int8", dict(b=8, h=16, d=64, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS)),
        ("f32", dict(b=3, h=4, d=32, page=8, np_=3, pool=12,
                     lengths=[17, 9, 0])),
        ("int8", dict(b=8, h=8, d=96, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS)),
        ("int8", dict(b=8, h=8, d=128, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS)),
        ("bf16", dict(b=8, h=8, d=128, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS)),
        ("bf16", dict(b=4, h=4, d=80, page=16, np_=8, pool=33,
                      lengths=[0, 1, 100, 128])),
        ("f32", dict(b=3, h=4, d=48, page=8, np_=3, pool=12,
                     lengths=[17, 9, 0])),
        # above 128: q and the accumulators in shared memory
        ("int8", dict(b=8, h=8, d=256, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS)),
        ("int8", dict(b=4, h=4, d=192, page=16, np_=8, pool=33,
                      lengths=[0, 1, 100, 128])),
        ("bf16", dict(b=4, h=4, d=160, page=16, np_=8, pool=33,
                      lengths=[0, 1, 100, 128])),
        # lengths across the split edges (NP 12, page 16: 4-page splits,
        # 3 a row): 0, 1, one split, a split + 1, NP x page
        ("bf16", dict(b=6, h=4, d=64, page=16, np_=12, pool=80,
                      lengths=[0, 1, 64, 65, 192, 100])),
        ("int8", dict(b=6, h=4, d=128, page=16, np_=12, pool=80,
                      lengths=[0, 1, 64, 65, 192, 100])),
        ("f32", dict(b=6, h=2, d=256, page=16, np_=12, pool=80,
                     lengths=[0, 1, 64, 65, 192, 100])),
        ("bf16", dict(b=6, h=2, d=320, page=16, np_=12, pool=80,
                      lengths=[0, 1, 64, 65, 192, 100])),
        # rows no multiple of 16 bytes (4-byte copies) or of 4 (element
        # copies), across splits
        ("bf16", dict(b=6, h=2, d=60, page=16, np_=12, pool=80,
                      lengths=[0, 1, 64, 65, 192, 100])),
        ("int8", dict(b=6, h=2, d=34, page=8, np_=20, pool=130,
                      lengths=[0, 1, 64, 65, 160, 100])),
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
        if main_err is None:
            main_err = e
            # the splits merge in a fixed order: the same bits again
            check_repeat(tag, (out,), (pa.paged_decode_fwd(*pos, scale=scale,
                                                           **kw),))
    return main_err


#: (rows, hidden, dtype, rms, memory_efficient): the training shape, the
#: other modes, ragged rows, f32, one hidden size for each of K2's
#: register variants (a lane holds 4, 8, 16 or 32 values, from 16-byte
#: loads or one element per load), rows wider than that (streamed), the
#: evoformer's f32 rows (MSA 128 x 256 rows of 256, pair 256 x 256 rows
#: of 128), an odd bf16 width whose rows start off 16-byte boundaries
#: (1001), an f32 width of 130, a wide row (12288) and narrow rows that
#: share a warp (64, 33)
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
    (128 * 256, 256, "f32", False, False),
    (256 * 256, 128, "f32", False, False),
    (1000, 1001, "bf16", False, False),
    (999, 130, "f32", False, True),
    (64, 12288, "bf16", False, True),
    (300, 64, "bf16", True, False),
    (301, 33, "f32", False, False),
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


def k4_dropped_tile(q, k, v, do, m, l, delta, ref, scale):
    """The twin's (dq, dk, dv) less what the 64-key tile at S/4 gives the
    later half of the query rows, in bf16: what a K4 that skipped that
    tile for those rows would return (causal, Sq = Sk = S >= 256, so the
    tile lies below the diagonal for every one of those rows)."""
    import torch

    s = q.shape[1]
    rows, keys = slice(s // 2, None), slice(s // 4, s // 4 + 64)
    qr, dor = q[:, rows].float(), do[:, rows].float()
    kt, vt = k[:, keys].float(), v[:, keys].float()
    p = (torch.exp(qr @ kt.transpose(1, 2) * scale - m[:, rows, None])
         / l[:, rows, None])
    ds = p * (dor @ vt.transpose(1, 2) - delta[:, rows, None])
    dq, dk, dv = (t.float() for t in ref)
    dq[:, rows] -= scale * ds @ kt
    dk[:, keys] -= scale * ds.transpose(1, 2) @ qr
    dv[:, keys] -= p.transpose(1, 2) @ dor
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def check_k3(tag, out, ref):
    """K3's (o, lse, m, l) against its twin's: o within BF16_TOL, the f32
    row statistics within F32_TOL.  Returns max |o - o_ref|."""
    e = compare(tag + " o", out[0], ref[0], BF16_TOL)
    for name, a, r in zip(("lse", "m", "l"), out[1:], ref[1:]):
        compare(f"{tag} {name}", a, r, F32_TOL)
    return e


def check_k4(tag, out, ref):
    """K4's (dq, dk, dv) against its twin's under ``K4_TOL``; returns
    each max |out - ref|."""
    errs = []
    for n, a, r in zip(("dq", "dk", "dv"), out, ref):
        ok, max_abs, rel, ratio = k4_check(a, r)
        log(f"  {tag} {n}: max_abs_err={max_abs:.3e} rel_fro_err="
            f"{rel:.3e} worst err/allowance={ratio:.3e} tol={K4_TOL} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} {n} disagrees with its twin")
        errs.append(max_abs)
    return errs


def check_repeat(tag, first, again):
    """A kernel run twice on the same inputs must give the same bits: K3
    and K4 use no atomics, so no sum depends on the order in which the
    blocks finish."""
    import torch

    same = all(torch.equal(a, b) for a, b in zip(first, again))
    log(f"  {tag}: a second run on the same inputs is "
        f"{'bit-identical' if same else 'DIFFERENT: FAIL'}")
    if not same:
        raise AssertionError(f"{tag} differs from run to run")


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
        o, _, m, l = attn.flash_fwd_reference(q, k, v, causal=causal,
                                              scale=0.125)
        delta = (do.float() * o.float()).sum(-1)
        if with_dlse:
            delta = delta - torch.randn(bh, sq, generator=gen, device="cuda")
        del o
        out = attn.flash_bwd(q, k, v, do, m, l, delta, scale=0.125,
                             causal=causal)
        ref = attn.flash_bwd_reference(q, k, v, do, m, l, delta, scale=0.125,
                                       causal=causal)
        tag = (f"K4 flash_bwd BH={bh} Sq={sq} Sk={sk} D=64 causal={causal} "
               f"dlse={with_dlse}")
        errs = check_k4(tag, out, ref)
        if main_err is None:
            main_err = max(errs)
            check_repeat(tag, out, attn.flash_bwd(q, k, v, do, m, l, delta,
                                                  scale=0.125, causal=True))
            bad = k4_dropped_tile(q, k, v, do, m, l, delta, ref, 0.125)
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


def padding_bias(lengths, s):
    """BERT's key-padding mask in the kernels' layout: (B, 1, S) f32, 0 on
    the first ``lengths[b]`` keys and MASK_VALUE after (G = B, RS = 1)."""
    import torch

    keep = torch.arange(s, device="cuda")[None] < lengths[:, None]
    return torch.where(keep, 0.0, -1e9)[:, None, :].contiguous()


def bert_lengths(gen, batch=BERT_BATCH, s=BERT_SEQ):
    """Ragged key lengths in [1, S] with row 0 full and row 1 empty (a
    sequence with no real token: every key masked by the bias)."""
    import torch

    lengths = torch.randint(1, s + 1, (batch,), generator=gen, device="cuda")
    lengths[0], lengths[1] = s, 0
    return lengths


def phase1_flash_operands(gen):
    """K3 and K4 with the bias and dropout operands against their twins
    (K3: BF16_TOL and F32_TOL; K4: K4_TOL), on the same inputs and seed:
    BERT's shape (BH = 128·16, S = 128, non-causal) with its (B, 1, S)
    key-padding bias over ragged lengths and one fully masked row, with
    and without dropout 0.1, and dropout alone; then every other bias
    layout (G = BH / B / 1, RS = S_q / 1) at smaller ragged shapes, causal
    and not, with and without dropout; and biases whose S_k is not a
    multiple of 4 (rows TMA cannot map, read from global memory instead),
    at D = 32 and 64."""
    import torch

    from apex_tpu_torch.ops import attention as attn

    log("phase 1: K3/K4 bias and dropout operands against their twins")
    heads = 16
    bert_bias = padding_bias(bert_lengths(gen), BERT_SEQ)

    def rand_bias(g, rs, sk):
        return torch.randn(g, rs, sk, generator=gen, device="cuda")

    # (tag, BH, Sq, Sk, causal, bias, dropout_p, D)
    bh = BERT_BATCH * heads
    cases = [
        ("BERT padding bias G=B RS=1", bh, BERT_SEQ, BERT_SEQ, False,
         bert_bias, 0.0, 64),
        ("BERT padding bias G=B RS=1 + dropout 0.1", bh, BERT_SEQ, BERT_SEQ,
         False, bert_bias, 0.1, 64),
        ("dropout 0.1 alone", bh, BERT_SEQ, BERT_SEQ, False, None, 0.1, 64),
        ("G=BH RS=Sq", 8, 200, 200, True, rand_bias(8, 200, 200), 0.0, 64),
        ("G=BH RS=Sq", 8, 200, 136, False, rand_bias(8, 200, 136), 0.0, 64),
        ("G=B RS=Sq + dropout 0.1", 8, 136, 200, True,
         rand_bias(2, 136, 200), 0.1, 64),
        ("G=1 RS=1", 8, 200, 200, True, rand_bias(1, 1, 200), 0.0, 64),
        ("G=1 RS=Sq + dropout 0.1", 8, 96, 200, False,
         rand_bias(1, 96, 200), 0.1, 64),
        ("G=BH RS=1 + dropout 0.5", 8, 72, 72, True, rand_bias(8, 1, 72),
         0.5, 64),
    ]
    for d in (32, 64):
        cases += [
            ("G=B RS=Sq, Sk % 4 != 0", 8, 130, 37, True,
             rand_bias(2, 130, 37), 0.0, d),
            ("G=BH RS=1, Sk % 4 != 0", 8, 100, 101, False,
             rand_bias(8, 1, 101), 0.0, d),
        ]
    for tag, bh, sq, sk, causal, bias, p, d in cases:
        q, k, v = attn_inputs(bh, sq, sk, d, gen)
        seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=gen,
                             device="cuda", dtype=torch.int32)
        kw = dict(scale=d ** -0.5, causal=causal, dropout_p=p, seed=seed)
        tag = f"{tag} BH={bh} Sq={sq} Sk={sk} D={d} causal={causal}"
        ref = attn.flash_fwd_reference(q, k, v, bias, **kw)
        check_k3("K3 " + tag, attn.flash_fwd(q, k, v, bias, **kw), ref)
        do = torch.randn(bh, sq, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        o, _, m, l = ref
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, m, l, delta, bias)
        check_k4("K4 " + tag, attn.flash_bwd(*args, **kw),
                 attn.flash_bwd_reference(*args, **kw))
        del ref, o, args
        torch.cuda.empty_cache()


#: K5's dbias against its twin, element by element: both recompute p and
#: ds in f32 from the same bf16 inputs (the kernel's products on the
#: tensor cores with f32 sums, ``__expf``), so they differ by the f32
#: rounding of the sums and of exp; an element may be off by ``rtol`` of
#: itself plus ``floor`` times the RMS of the whole tensor (an element of
#: dbias is a difference p·(dp - delta) that cancels to near 0), and the
#: relative Frobenius error must stay under ``norm``.  Phase 1 shows that
#: an output with one 64-key tile's dbias halved for the later half of
#: the rows fails the same check.
K5_TOL = dict(rtol=2 ** -10, floor=2 ** -10, norm=1e-3)


def k5_check(out, ref):
    """(ok, max |out - ref|, relative Frobenius error, worst ratio of an
    element's error to its allowance) under ``K5_TOL``."""
    import torch

    err = (out - ref).abs()
    allowed = K5_TOL["rtol"] * ref.abs() + K5_TOL["floor"] * ref.pow(2).mean().sqrt()
    rel = float(err.norm() / ref.norm().clamp_min(1e-30))
    ratio = float((err / allowed.clamp_min(1e-30)).max())
    ok = (bool(torch.isfinite(out).all()) and bool((err <= allowed).all())
          and rel <= K5_TOL["norm"])
    return ok, float(err.max()), rel, ratio


def check_k5(tag, out, ref):
    ok, max_abs, rel, ratio = k5_check(out, ref)
    log(f"  {tag} dbias: max_abs_err={max_abs:.3e} rel_fro_err={rel:.3e} "
        f"worst err/allowance={ratio:.3e} tol={K5_TOL} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} dbias disagrees with its twin")
    return max_abs


#: the evoformer's attention calls at AlphaFold2's initial-training crop
#: (N_res 256, N_seq 128, 4 heads): (BH, S, D, bias) per call
EVO_RES, EVO_SEQ, EVO_HEADS = 256, 128, 4
TRIANGLE_SHAPE = (EVO_RES * EVO_HEADS, EVO_RES, 32)   # start and end node
MSA_ROW_SHAPE = (EVO_SEQ * EVO_HEADS, EVO_RES, 64)    # with the pair bias
MSA_COL_SHAPE = (EVO_RES * EVO_HEADS, EVO_SEQ, 64)    # no bias


def check_fused(tag, out, ref4, ref5, causal):
    """The fused call's (dq, dk, dv, dbias) against the twins': dq, dk,
    dv under K4_TOL, dbias under K5_TOL, and under a causal mask dbias
    exactly 0 at every pair the mask takes away, as the twin's (the key
    tiles the dQ pass skips there are written as zeros).  Returns max
    |dbias - ref|."""
    from apex_tpu_torch.ops import attention as attn

    check_k4(tag, out[:3], ref4)
    e = check_k5(tag, out[3], ref5)
    if causal:
        sq, sk = ref5.shape[1:]
        masked = ~attn._causal_mask(sq, sk, ref5.device)
        got, want = out[3][:, masked], ref5[:, masked]
        ok = bool((got == 0).all()) and bool((want == 0).all())
        log(f"  {tag} dbias: {'exactly 0' if ok else 'NOT 0: FAIL'} at the "
            f"{got.numel()} masked pairs (twin: "
            f"{int((want == 0).sum())} zeros, kernel: "
            f"{int((got == 0).sum())})")
        if not ok:
            raise AssertionError(f"{tag}: dbias is not 0 where the mask is")
    return e


def phase1_flash_dbias(gen):
    """K5 against its twin (``K5_TOL``), and K3/K4 at head dim 32 against
    theirs (BF16_TOL, F32_TOL, K4_TOL), on the same inputs and seed, with
    m, l from the f32 reference forward: the evoformer's three shapes
    first (triangle attention, D = 32, and MSA row attention, D = 64,
    each with its (BH, S, S) bias at G = BH, and K3/K4 at MSA column
    attention's, D = 64, no bias; all non-causal), then every (G, RS)
    layout at smaller ragged shapes, causal and not, Sq != Sk both ways,
    with and without dropout 0.1, D = 32 and 64.  Every G = BH, RS = Sq
    case also runs the fused call (``flash_bwd_dbias``: K4 with the dbias
    as its dQ pass's epilogue, the route of every trainable bias of the
    ported models) against both twins (:func:`check_fused`), with cases
    of its own for S_k % 4 != 0 (the bias read from global memory), a
    causal Sq > Sk (fully masked rows and skipped key tiles: dbias
    exactly 0 at every masked pair), D = 128 and D = 256 (two CTAs a q
    tile).  At the
    triangle shape K5's and the fused call's outputs run twice for the
    same bits, and an output with one tile halved must fail K5_TOL.
    Returns max |dbias - ref| of K5 and of the fused call at the triangle
    shape, K3's and K4's errors there, and the number of cases in which
    the standalone K5 passed K5_TOL (``k5_checks``)."""
    import torch

    from apex_tpu_torch.ops import attention as attn

    log("phase 1: K5 flash_dbias, the fused flash_bwd_dbias, and K3/K4 at "
        "head dim 32, against their twins")

    def rand_bias(g, rs, sk):
        return torch.randn(g, rs, sk, generator=gen, device="cuda")

    tri_bh, tri_s, _ = TRIANGLE_SHAPE
    row_bh, row_s, _ = MSA_ROW_SHAPE
    col_bh, col_s, _ = MSA_COL_SHAPE
    # (tag, BH, Sq, Sk, D, causal, bias (G, RS) or None (no bias, no K5),
    # dropout_p, with K3/K4)
    cases = [
        ("triangle G=BH RS=Sq", tri_bh, tri_s, tri_s, 32, False,
         (tri_bh, tri_s), 0.0, True),
        ("MSA row G=BH RS=Sq", row_bh, row_s, row_s, 64, False,
         (row_bh, row_s), 0.0, True),
        ("MSA column no bias", col_bh, col_s, col_s, 64, False, None, 0.0,
         True),
        ("G=1 RS=Sq", 8, 200, 200, 32, True, (1, 200), 0.0, True),
        ("G=B RS=Sq + dropout 0.1", 8, 136, 200, 64, True, (2, 136), 0.1,
         False),
        ("G=BH RS=1 + dropout 0.1", 8, 200, 136, 32, False, (8, 1), 0.1,
         True),
        ("G=B RS=1", 8, 200, 200, 64, True, (2, 1), 0.0, False),
        ("G=1 RS=1 + dropout 0.1", 8, 72, 200, 32, True, (1, 1), 0.1, True),
        ("G=BH RS=Sq", 8, 200, 72, 64, True, (8, 200), 0.0, False),
        ("G=BH RS=Sq + dropout 0.1", 8, 256, 256, 32, False, (8, 256), 0.1,
         True),
        # the fused call's own cases: S_k odd (no TMA map, one float per
        # store), causal Sq > Sk (rows 0..202 fully masked, key tiles past
        # each warpgroup's limit skipped), D = 128 and D = 256
        ("G=BH RS=Sq, Sk % 4 != 0", 8, 130, 37, 64, True, (8, 130), 0.0,
         False),
        ("G=BH RS=Sq causal Sq > Sk", 8, 333, 130, 32, True, (8, 333), 0.0,
         False),
        ("D=128 G=BH RS=Sq", 8, 256, 256, 128, False, (8, 256), 0.0, False),
        ("D=256 G=BH RS=Sq + dropout 0.1", 8, 200, 200, 256, True, (8, 200),
         0.1, False),
    ]
    main = {}
    k5_checks = 0
    for tag, bh, sq, sk, d, causal, layout, p, with_k34 in cases:
        q, k, v = attn_inputs(bh, sq, sk, d, gen)
        bias = None if layout is None else rand_bias(*layout, sk)
        seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=gen,
                             device="cuda", dtype=torch.int32)
        kw = dict(scale=d ** -0.5, causal=causal, dropout_p=p, seed=seed)
        tag = f"{tag} BH={bh} Sq={sq} Sk={sk} D={d} causal={causal}"
        triangle = bh == tri_bh and d == 32
        ref = attn.flash_fwd_reference(q, k, v, bias, **kw)
        if with_k34:
            out = attn.flash_fwd(q, k, v, bias, **kw)
            e3 = check_k3("K3 " + tag, out, ref)
            if triangle:
                check_repeat("K3 " + tag, out,
                             attn.flash_fwd(q, k, v, bias, **kw))
            del out
        do = torch.randn(bh, sq, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        o, _, m, l = ref
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, m, l, delta, bias)
        del ref, o
        ref4 = None
        if with_k34:
            out = attn.flash_bwd(*args, **kw)
            ref4 = attn.flash_bwd_reference(*args, **kw)
            e4 = check_k4("K4 " + tag, out, ref4)
            if triangle:
                check_repeat("K4 " + tag, out, attn.flash_bwd(*args, **kw))
            del out
        if bias is None:
            del args, q, k, v, do, m, l, delta, ref4
            torch.cuda.empty_cache()
            continue
        ref = attn.flash_dbias_reference(*args, **kw)
        e5 = check_k5("K5 " + tag, attn.flash_dbias(*args, **kw), ref)
        k5_checks += 1
        e45 = None
        if attn._fused_dbias(bias, bh, sq, q.dtype, d):
            if ref4 is None:
                ref4 = attn.flash_bwd_reference(*args, **kw)
            fused = attn.flash_bwd_dbias(*args, **kw)
            e45 = check_fused("K4+K5 flash_bwd_dbias " + tag, fused, ref4,
                              ref, causal)
            if triangle:
                check_repeat("K4+K5 flash_bwd_dbias " + tag, fused,
                             attn.flash_bwd_dbias(*args, **kw))
        if not main:
            main = {"flash_dbias": e5, "flash_fwd_d32": e3,
                    "flash_bwd_d32": max(e4), "flash_bwd_dbias": e45}
            for who, out in (("K5", ref), ("K4+K5 flash_bwd_dbias",
                                           fused[3])):
                bad = out.clone()
                bad[:, sq // 2:, 64:128] *= 0.5
                ok, max_abs, rel, ratio = k5_check(bad, ref)
                log(f"  {who} {tag} with one 64-key tile halved for the "
                    f"later half of the rows: max_abs_err={max_abs:.3e} "
                    f"rel_fro_err={rel:.3e} worst err/allowance="
                    f"{ratio:.3e} {'passes: FAIL' if ok else 'fails: ok'}")
                if ok:
                    raise AssertionError(
                        f"K5_TOL cannot tell a halved tile in {who}")
                del bad
        del ref, ref4, args, q, k, v, do, m, l, delta, bias
        if e45 is not None:
            del fused
        torch.cuda.empty_cache()
    main["k5_checks"] = k5_checks
    return main


#: (tag, BH, Sq, Sk, D, causal, bias (G, RS) or None, dropout_p) of
#: phase 1's head-dim and f32 cases
HEAD_DIM_CASES = (
    ("D=128 causal (the long-context bench's head dim)", 16, 1024, 1024,
     128, True, None, 0.0),
    ("D=128 G=BH RS=Sq", 8, 256, 256, 128, False, (8, 256), 0.0),
    ("D=128 G=B RS=1 + dropout 0.1", 8, 200, 136, 128, True, (2, 1), 0.1),
    ("D=128 G=B RS=Sq, Sk % 4 != 0", 8, 130, 37, 128, True, (2, 130), 0.0),
    ("D=48 (padded to 64)", 8, 200, 200, 48, True, None, 0.0),
    ("D=96 (padded to 128) G=BH RS=Sq + dropout 0.1", 8, 136, 200, 96,
     False, (8, 136), 0.1),
    ("D=96 (padded to 128)", 4, 1000, 1000, 96, True, None, 0.0),
    ("D=256 causal", 8, 512, 512, 256, True, None, 0.0),
    ("D=256 G=BH RS=Sq + dropout 0.1", 8, 256, 256, 256, False, (8, 256),
     0.1),
    ("D=256 G=B RS=1 + dropout 0.1", 8, 200, 136, 256, True, (2, 1), 0.1),
    ("D=256 G=B RS=Sq, Sk % 4 != 0", 8, 130, 37, 256, True, (2, 130), 0.0),
    ("D=160 (padded to 256) G=BH RS=Sq", 8, 200, 200, 160, True, (8, 200),
     0.0),
    # above 256: the wide instance (64-column blocks streamed)
    ("D=320 (padded to 384) causal", 8, 256, 256, 320, True, None, 0.0),
    ("D=384 G=BH RS=Sq + dropout 0.1", 8, 200, 200, 384, False, (8, 200),
     0.1),
    ("D=384 G=B RS=1 + dropout 0.1", 8, 200, 136, 384, True, (2, 1), 0.1),
    ("D=320 (padded to 384) G=BH RS=Sq, Sk % 4 != 0", 8, 130, 37, 320, True,
     (8, 130), 0.0),
)
F32_CASES = (
    ("f32 D=64", 8, 256, 256, 64, True, None, 0.0),
    ("f32 D=64 G=B RS=1 + dropout 0.1", 8, 136, 200, 64, True, (2, 1), 0.1),
    ("f32 D=64 G=BH RS=Sq", 8, 200, 136, 64, False, (8, 200), 0.0),
    ("f32 D=96 (padded to 128)", 8, 200, 200, 96, True, None, 0.0),
    ("f32 D=96 G=BH RS=Sq + dropout 0.1", 8, 200, 72, 96, True, (8, 200),
     0.1),
    ("f32 D=96 G=1 RS=1", 8, 72, 200, 96, False, (1, 1), 0.0),
    ("f32 D=32 + dropout 0.1", 8, 200, 200, 32, True, None, 0.1),
    ("f32 D=64 G=B RS=Sq, Sk % 4 != 0", 8, 130, 37, 64, True, (2, 130), 0.0),
    ("f32 D=192 (padded to 256) G=BH RS=Sq", 4, 136, 200, 192, False,
     (4, 136), 0.0),
    ("f32 D=192 (padded to 256) G=B RS=1 + dropout 0.1", 4, 200, 136, 192,
     True, (2, 1), 0.1),
    ("f32 triangle D=32 G=BH RS=Sq", TRIANGLE_SHAPE[0], TRIANGLE_SHAPE[1],
     TRIANGLE_SHAPE[1], 32, False, (TRIANGLE_SHAPE[0], TRIANGLE_SHAPE[1]),
     0.0),
    ("f32 MSA row D=64 G=BH RS=Sq", MSA_ROW_SHAPE[0], MSA_ROW_SHAPE[1],
     MSA_ROW_SHAPE[1], 64, False, (MSA_ROW_SHAPE[0], MSA_ROW_SHAPE[1]), 0.0),
    ("f32 MSA column D=64 no bias", MSA_COL_SHAPE[0], MSA_COL_SHAPE[1],
     MSA_COL_SHAPE[1], 64, False, None, 0.0),
    # K5 at D = 128 with two members (64-column blocks, Q and dO streamed)
    ("f32 D=128 G=B RS=Sq", 4, 136, 136, 128, False, (2, 136), 0.0),
    # above 256: the wide instances
    ("f32 D=384 causal", 4, 256, 256, 384, True, None, 0.0),
    ("f32 D=384 G=BH RS=Sq + dropout 0.1", 4, 200, 136, 384, False,
     (4, 200), 0.1),
    ("f32 D=320 (padded to 384) G=B RS=1", 4, 136, 200, 320, True, (2, 1),
     0.0),
    ("f32 D=320 (padded to 384) G=B RS=Sq, Sk % 4 != 0", 4, 130, 37, 320,
     True, (2, 130), 0.0),
)


def tf32_twin(fn, q, k, v, *rest, **kw):
    """The twin ``fn`` with q, k and v rounded to TF32 (10 mantissa bits,
    to nearest) and its products on TF32: the f32 instances' control."""
    import torch

    def tf32(t):
        return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
            torch.float32)

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn(tf32(q), tf32(k), tf32(v), *rest, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def f32_control(tag, names, ref, bad):
    """compare() of the TF32 control (:func:`tf32_twin`) with the sound
    twin under F32_ATTN_TOL: at least one output must fail, by more than
    10 times its allowance, or the limit could not tell an f32 kernel
    from one on bf16 or TF32 tensor cores."""
    failed, worst = [], 0.0
    for name, a, r in zip(names, bad, ref):
        a, r = a.float(), r.float()
        allowed = F32_ATTN_TOL["atol"] + F32_ATTN_TOL["rtol"] * r.abs()
        worst = max(worst, float(((a - r).abs() / allowed).max()))
        try:
            compare(f"{tag} {name}, control (twin on TF32)", a, r,
                    F32_ATTN_TOL)
        except AssertionError:
            failed.append(name)
    ok = bool(failed) and worst > 10.0
    log(f"  {tag} control fails on {failed or 'nothing'}, worst "
        f"err/allowance {worst:.1f}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(
            f"{tag}: F32_ATTN_TOL does not reject TF32 products by 10x")


def phase1_head_dims(gen):
    """K3, K4 and K5 at the head dims past the main paths' 32 and 64, and
    their f32 instances, against the twins on the same inputs and seed
    (m, l from the twin's forward).  bf16 (``HEAD_DIM_CASES``): D = 128
    and 256, the kernels' own instances, with every bias mode (TMA tiles,
    the key-padding row, a row stride TMA cannot map) and dropout, and D
    = 48, 96 and 160, which the wrappers pad to 64, 128 and 256; K3 under
    BF16_TOL and F32_TOL, K4 under K4_TOL, K5 under K5_TOL, and the D =
    128 causal case run twice for the same bits.  f32 (``F32_CASES``, q,
    k, v and dO drawn in full f32): D 32, 64, 96 and 192, with and
    without a bias, causal and not, with dropout, a bias whose S_k is no
    multiple of 4, and the evoformer's three shapes (triangle, MSA row,
    MSA column) at full size, which phase 10's f32 run gives them; o, lse,
    m, l, dq, dk, dv and dbias under F32_ATTN_TOL, and each kernel's TF32
    control (:func:`f32_control`) failing it.  Returns the first D = 128
    case's and the first f32 case's errors for the kernels line."""
    import torch

    from apex_tpu_torch.ops import attention as attn

    log("phase 1: K3/K4/K5 at D = 128, 256, 384 and padded head dims, and "
        "their f32 instances, against their twins")
    errs = {}
    for tag, bh, sq, sk, d, causal, layout, p in HEAD_DIM_CASES + F32_CASES:
        f32 = tag.startswith("f32")
        if f32:  # full f32: no value that bf16 or TF32 holds exactly
            q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda")
                       for s in (sq, sk, sk))
        else:
            q, k, v = attn_inputs(bh, sq, sk, d, gen)
        do = torch.randn(bh, sq, d, generator=gen, device="cuda").to(q.dtype)
        bias = (None if layout is None else
                torch.randn(*layout, sk, generator=gen, device="cuda"))
        seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=gen,
                             device="cuda", dtype=torch.int32)
        kw = dict(scale=d ** -0.5, causal=causal, dropout_p=p, seed=seed)
        tag = f"{tag} BH={bh} Sq={sq} Sk={sk} D={d} causal={causal}"
        ref = attn.flash_fwd_reference(q, k, v, bias, **kw)
        out = attn.flash_fwd(q, k, v, bias, **kw)
        if f32:
            e3 = compare(f"K3 {tag} o", out[0], ref[0], F32_ATTN_TOL)
            for name, a, r in zip(("lse", "m", "l"), out[1:], ref[1:]):
                compare(f"K3 {tag} {name}", a, r, F32_ATTN_TOL)
            f32_control("K3 " + tag, ("o", "lse"), ref,
                        tf32_twin(attn.flash_fwd_reference, q, k, v, bias,
                                  **kw))
        else:
            e3 = check_k3("K3 " + tag, out, ref)
        if d in (128, 320) and causal and bias is None and not f32:
            check_repeat("K3 " + tag, out, attn.flash_fwd(q, k, v, bias, **kw))
        o, _, m, l = ref
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, m, l, delta, bias)
        del ref, out, o
        out = attn.flash_bwd(*args, **kw)
        ref = attn.flash_bwd_reference(*args, **kw)
        if f32:
            e4 = [compare(f"K4 {tag} {n}", a, r, F32_ATTN_TOL)
                  for n, a, r in zip(("dq", "dk", "dv"), out, ref)]
            f32_control("K4 " + tag, ("dq", "dk", "dv"), ref,
                        tf32_twin(attn.flash_bwd_reference, *args, **kw))
        else:
            e4 = check_k4("K4 " + tag, out, ref)
        if d in (128, 320) and causal and bias is None and not f32:
            check_repeat("K4 " + tag, out, attn.flash_bwd(*args, **kw))
        del out, ref
        e5 = None
        if bias is not None and f32:
            ref = attn.flash_dbias_reference(*args, **kw)
            e5 = compare(f"K5 {tag} dbias", attn.flash_dbias(*args, **kw),
                         ref, F32_ATTN_TOL)
            f32_control("K5 " + tag, ("dbias",), (ref,),
                        (tf32_twin(attn.flash_dbias_reference, *args, **kw),))
            del ref
        elif bias is not None:
            e5 = check_k5("K5 " + tag, attn.flash_dbias(*args, **kw),
                          attn.flash_dbias_reference(*args, **kw))
        suffix = "_f32" if f32 else "_d128"
        if d in (64, 128) and f"flash_fwd{suffix}" not in errs:
            errs[f"flash_fwd{suffix}"] = e3
            errs[f"flash_bwd{suffix}"] = max(e4)
        if e5 is not None and f"flash_dbias{suffix}" not in errs:
            errs[f"flash_dbias{suffix}"] = e5
        del args, q, k, v, do, m, l, delta, bias
        torch.cuda.empty_cache()
    return errs


def phase1_dropout_mask(gen):
    """Reads K3's and K4's dropout keep masks back bit for bit at BERT's
    shape (BH = 2048, S = 128, p = 0.1) and compares each with the twin's
    ``dropout_keep_mask``.  BF16_TOL cannot see one flipped bit, which
    moves o by ~|v|/S.  q = 0 makes every score 0; the bias leaves 64
    keys unmasked (keys 0..63 for even bh, 64..127 for odd bh), so every
    (row, key) pair of the (BH, S, S) mask is read once:

    - K3: v is the identity on the unmasked keys, so o[i, c] =
      keep(i, j0 + c) · bf16(1/(1-p)) / 64;
    - K4's dK/dV pass: dO[i, c] = [c == i mod 64] · (1 if i < 64 else 2),
      so dv[j0 + c', c] / (bf16(1/(1-p)) / 64) = keep(c, j) + 2 keep(c + 64,
      j) with j = j0 + c';
    - K4's dQ pass: k = v = the identity on the unmasked keys and dO = 1,
      so dq[i, c] = scale · (keep ? 1/(1-p) : 0 - delta_i) / 64, kept
      iff dq[i, c] > -scale · delta_i / 128."""
    import torch

    from apex_tpu_torch.ops import attention as attn

    log("phase 1: K3/K4 dropout keep masks read back bit for bit")
    bh, s, d, p, scale = BERT_BATCH * 16, BERT_SEQ, 64, 0.1, 0.125
    seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=gen,
                         device="cuda", dtype=torch.int32)
    keep = attn.dropout_keep_mask(seed, (bh, s, s), p)
    j0 = (torch.arange(bh, device="cuda") % 2) * 64
    cols = torch.arange(s, device="cuda")
    live = (cols[None] >= j0[:, None]) & (cols[None] < j0[:, None] + 64)
    bias = torch.where(live, 0.0, -1e9)[:, None, :].contiguous()
    eye = torch.zeros(bh, s, d, device="cuda")
    eye[live] = torch.eye(d, device="cuda").repeat(bh, 1)
    eye = eye.to(torch.bfloat16)
    zeros = torch.zeros(bh, s, d, dtype=torch.bfloat16, device="cuda")
    kw = dict(scale=scale, causal=False, dropout_p=p, seed=seed)
    # per bh, the (S, 64) block of the mask over its unmasked keys
    want = keep[live[:, None, :].expand(bh, s, s)].reshape(bh, s, 64)
    unit = float(torch.tensor(1 / (1 - p)).to(torch.bfloat16)) / 64

    o, _, m, l = attn.flash_fwd(zeros, zeros, eye, bias, **kw)
    got = o.float() > 0
    bad = int((got != want).sum())
    vals = o.float()[got]
    log(f"  K3 o: {bad} of {want.numel()} mask bits differ; kept entries "
        f"in [{float(vals.min()):.6f}, {float(vals.max()):.6f}], expected "
        f"{unit:.6f}")
    if bad or not torch.all(vals == unit):
        raise AssertionError("K3's dropout mask differs from the twin's")

    rows = torch.arange(s, device="cuda")
    do = torch.zeros(bh, s, d, device="cuda")
    do[:, rows, rows % 64] = torch.where(rows < 64, 1.0, 2.0)
    do = do.to(torch.bfloat16)
    delta = torch.zeros(bh, s, device="cuda")
    _, _, dv = attn.flash_bwd(zeros, zeros, eye, do, m, l, delta, bias, **kw)
    code = torch.round(dv.float()[live] / unit).reshape(bh, 64, d)
    # code[b, c', c] = keep(c, j0 + c') + 2 keep(c + 64, j0 + c')
    got = torch.stack([code % 2, code // 2], 1).bool()  # (bh, 2, 64', 64)
    want_dv = want.reshape(bh, 2, 64, 64).transpose(2, 3)
    bad_dv = int((got != want_dv).sum()) + int((code > 3).sum())
    log(f"  K4 dK/dV pass dv: {bad_dv} of {want.numel()} mask bits differ")

    ones = torch.ones(bh, s, d, dtype=torch.bfloat16, device="cuda")
    o, _, m, l = attn.flash_fwd(zeros, eye, eye, bias, **kw)
    delta = o.float().sum(-1)
    dq, _, _ = attn.flash_bwd(zeros, eye, eye, ones, m, l, delta, bias, **kw)
    got = dq.float() > -scale * delta[..., None] / 128
    bad_dq = int((got != want).sum())
    log(f"  K4 dQ pass dq: {bad_dq} of {want.numel()} mask bits differ")
    if bad_dv or bad_dq:
        raise AssertionError("K4's dropout mask differs from the twin's")


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


def _time_ln(gen, flush, rows, hidden, dtype="bf16"):
    """K1 and K2 at x (rows, hidden) in ``dtype`` (bf16 or f32), each
    beside its plain version and the library call (``F.layer_norm`` and
    its backward, affine, with the weights in x's dtype), with the
    bounds."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm as ln

    x, w, b = ln_inputs(rows, hidden, gen)
    if dtype == "f32":
        x = x.float()
    wb, bb = w.to(x.dtype), b.to(x.dtype)
    n = x.numel()
    elem = x.element_size()
    fwd = dict(
        ms=time_ms(lambda: ln.layer_norm_fwd(x, w, b, eps=1e-5, rms=False),
                   flush=flush),
        plain_ms=time_ms(lambda: ln.layer_norm_reference(x, w, b, 1e-5, False),
                         flush=flush),
        library_ms=time_ms(lambda: F.layer_norm(x, (hidden,), wb, bb, 1e-5),
                           flush=flush),
    )
    fwd["bound_ms"], fwd["bound_by"] = bound(
        _ln_bytes(rows, hidden, elem, bwd=False), 8 * n, F32_FLOPS)

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
        _ln_bytes(rows, hidden, elem, bwd=True), 12 * n, F32_FLOPS)
    return fwd, bwd


def _time_attn(gen, flush, bh, s, *, with_bwd, d=64):
    """K3 (and K4) at q/k/v (bh, s, d) causal bf16, scale 1/sqrt(d),
    beside the plain versions and SDPA (``is_causal``; its backward timed
    on its own), with the bounds: 2 products of 2*D flops per live pair
    forward, 5 backward (the recompute, dO V^T, P^T dO, dS K, dS^T Q)."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as attn

    scale = d ** -0.5
    q, k, v = attn_inputs(bh, s, s, d, gen)
    live = bh * _attn_live_pairs(s)
    elems = bh * s * d
    fwd = dict(
        ms=time_ms(lambda: attn.flash_fwd(q, k, v, scale=scale, causal=True),
                   flush=flush),
        plain_ms=time_ms(lambda: attn.flash_fwd_reference(
            q, k, v, causal=True, scale=scale), flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, scale=scale),
            flush=flush),
    )
    fwd["bound_ms"], fwd["bound_by"] = bound(
        2 * 4 * elems + 3 * 4 * bh * s, 4 * d * live, BF16_TENSOR_FLOPS)
    if not with_bwd:
        return fwd, None
    do = torch.randn(bh, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    o, _, m, l = attn.flash_fwd(q, k, v, scale=scale, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    qr, kr, vr = (t[None].detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                           scale=scale)
    bwd = dict(
        ms=time_ms(lambda: attn.flash_bwd(q, k, v, do, m, l, delta,
                                          scale=scale, causal=True),
                   flush=flush),
        # the f32 twin materialises five (BH, S, S) f32 score-sized
        # tensors (~10 GB here): fewer runs
        plain_ms=time_ms(lambda: attn.flash_bwd_reference(
            q, k, v, do, m, l, delta, scale=scale, causal=True),
            iters=5, warmup=1, flush=flush),
        library_ms=time_ms(lambda: torch.autograd.grad(
            o_lib, (qr, kr, vr), do[None], retain_graph=True), flush=flush),
    )
    bwd["bound_ms"], bwd["bound_by"] = bound(
        2 * 7 * elems + 3 * 4 * bh * s, 10 * d * live, BF16_TENSOR_FLOPS)
    return fwd, bwd


#: the reference's long-context benchmark (``bench.py``'s long-context
#: config: B 1, H 8, S 16384, D 128, causal)
LONG_BH, LONG_S, LONG_D = 8, 16384, 128
#: phase 4's head dim past 128 (B 4, H 8, S 2048, D 256, causal)
WIDE_BH, WIDE_S, WIDE_D = 32, 2048, 256
#: and past 256: the wide instance
WIDER_D = 384


def sdpa_backend(fn):
    """The backend SDPA dispatches ``fn`` to: the first of its priority
    order (``torch._C._get_sdp_priority_order``, else flash, efficient,
    cuDNN, math) that accepts the call."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    try:
        order = [SDPBackend(int(b)) for b in torch._C._get_sdp_priority_order()]
    except (AttributeError, TypeError, ValueError):
        order = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                 SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
    for backend in order:
        try:
            with sdpa_kernel([backend]):
                fn()
            return backend.name.lower()
        except RuntimeError:
            continue
    return "none"


def _time_attn_wider(gen, flush):
    """K3, K4 (causal) and K5 (non-causal, a (BH, S, S) f32 bias at G =
    BH) at BH 32, S 2048, D 384, the wide instance, beside their plain
    versions and SDPA on whichever backend it picks for a head dim its
    flash kernels refuse (named in each row); None where this tree's
    kernels refuse the head dim (an older tree)."""
    import torch
    import torch.nn.functional as F

    bh, s, d = WIDE_BH, WIDE_S, WIDER_D
    try:
        fwd, bwd = _time_attn(gen, flush, bh, s, with_bwd=True, d=d)
    except ValueError as exc:  # a tree without the wide instance
        log(f"  D = {d} refused: {exc}")
        return None
    q, k, v = attn_inputs(bh, s, s, d, gen)
    qr, kr, vr = (t[None].detach().clone().requires_grad_() for t in (q, k, v))
    lib = sdpa_backend(lambda: F.scaled_dot_product_attention(
        qr, kr, vr, is_causal=True, scale=d ** -0.5))
    fwd["library"] = bwd["library"] = f"SDPA ({lib} backend)"
    del q, k, v, qr, kr, vr
    torch.cuda.empty_cache()
    k5 = _time_evo_attention(gen, flush, bh, s, d, with_k34=False)
    b = bh // EVO_HEADS
    q, k, v = (t.reshape(b, EVO_HEADS, s, d) for t in attn_inputs(bh, s, s, d,
                                                                  gen))
    mask = torch.zeros(b, EVO_HEADS, s, s, device="cuda",
                       dtype=torch.bfloat16, requires_grad=True)
    lib = sdpa_backend(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                       scale=d ** -0.5), mask,
        torch.ones_like(q)))
    k5["flash_dbias"]["library"] = (f"SDPA backward with the mask's "
                                    f"gradient ({lib} backend)")
    return fwd, bwd, k5["flash_dbias"]


def _time_attn_long(gen, flush):
    """K3 and K4 at the long-context shape (BH 8, S 16384, D 128, causal,
    bf16) beside the plain versions and SDPA (``is_causal``; its backward
    timed on its own), with the bounds: 2 products of 2*D flops per live
    pair forward, 5 backward.  The plain versions hold (8, 16384, 16384)
    f32 score-sized tensors (8.6 GB each): one run each after one warm-up,
    and "not measured" if the card runs out of memory."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as attn

    bh, s, d = LONG_BH, LONG_S, LONG_D
    scale = d ** -0.5
    q, k, v = attn_inputs(bh, s, s, d, gen)
    live = bh * _attn_live_pairs(s)
    elems = bh * s * d

    def plain(fn):
        try:
            return time_ms(fn, iters=1, warmup=1, flush=flush)
        except torch.cuda.OutOfMemoryError:
            log("  the plain version ran out of device memory: not measured")
            return None
        finally:
            torch.cuda.empty_cache()

    fwd = dict(
        ms=time_ms(lambda: attn.flash_fwd(q, k, v, scale=scale, causal=True),
                   flush=flush),
        plain_ms=plain(lambda: attn.flash_fwd_reference(
            q, k, v, causal=True, scale=scale)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, scale=scale),
            flush=flush),
    )
    fwd["bound_ms"], fwd["bound_by"] = bound(
        2 * 4 * elems + 3 * 4 * bh * s, 4 * d * live, BF16_TENSOR_FLOPS)
    do = torch.randn(bh, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    o, _, m, l = attn.flash_fwd(q, k, v, scale=scale, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    del o
    qr, kr, vr = (t[None].detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                           scale=scale)
    bwd = dict(
        ms=time_ms(lambda: attn.flash_bwd(q, k, v, do, m, l, delta,
                                          scale=scale, causal=True),
                   flush=flush),
        plain_ms=plain(lambda: attn.flash_bwd_reference(
            q, k, v, do, m, l, delta, scale=scale, causal=True)),
        library_ms=time_ms(lambda: torch.autograd.grad(
            o_lib, (qr, kr, vr), do[None], retain_graph=True), flush=flush),
    )
    bwd["bound_ms"], bwd["bound_by"] = bound(
        2 * 7 * elems + 3 * 4 * bh * s, 10 * d * live, BF16_TENSOR_FLOPS)
    return fwd, bwd


def _time_attn_bert(gen, flush, dropout_p):
    """K3 and K4 at BERT's shape (BH = 128·16, S = 128, D = 64,
    non-causal) with the (B, 1, S) padding bias over ragged lengths and
    ``dropout_p``, beside the plain versions and SDPA with the same
    additive mask (``attn_mask``, bf16) and dropout rate, forward and
    backward (timed on its own), with the bounds: the bytes of q, k, v
    (and dO) read, o (dq, dk, dv) written and the f32 row statistics, the
    bias and the seed; 2 products of 2·D flops per pair forward, 5
    backward, S² pairs per head."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as attn

    bh, s, d, heads = BERT_BATCH * 16, BERT_SEQ, 64, 16
    q, k, v = attn_inputs(bh, s, s, d, gen)
    bias = padding_bias(bert_lengths(gen), s)
    seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=gen,
                         device="cuda", dtype=torch.int32)
    kw = dict(scale=0.125, causal=False, dropout_p=dropout_p, seed=seed)
    pairs = bh * s * s
    elems = bh * s * d
    extra = BERT_BATCH * s * 4 + 4  # the bias and the seed
    q4, k4, v4 = (t.reshape(BERT_BATCH, heads, s, d) for t in (q, k, v))
    mask4 = bias[:, None].to(torch.bfloat16)  # (B, 1, 1, S)

    def sdpa(a, b_, c):
        return F.scaled_dot_product_attention(a, b_, c, attn_mask=mask4,
                                              dropout_p=dropout_p,
                                              scale=0.125)

    fwd = dict(
        ms=time_ms(lambda: attn.flash_fwd(q, k, v, bias, **kw), flush=flush),
        plain_ms=time_ms(lambda: attn.flash_fwd_reference(q, k, v, bias, **kw),
                         flush=flush),
        library_ms=time_ms(lambda: sdpa(q4, k4, v4), flush=flush),
    )
    fwd["bound_ms"], fwd["bound_by"] = bound(
        4 * elems * 2 + 3 * bh * s * 4 + extra, 4 * d * pairs,
        BF16_TENSOR_FLOPS)
    do = torch.randn(bh, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    o, _, m, l = attn.flash_fwd(q, k, v, bias, **kw)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, m, l, delta, bias)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    o_lib = sdpa(qr, kr, vr)
    bwd = dict(
        ms=time_ms(lambda: attn.flash_bwd(*args, **kw), flush=flush),
        plain_ms=time_ms(lambda: attn.flash_bwd_reference(*args, **kw),
                         flush=flush),
        library_ms=time_ms(lambda: torch.autograd.grad(
            o_lib, (qr, kr, vr), do.reshape(q4.shape), retain_graph=True),
            flush=flush),
    )
    bwd["bound_ms"], bwd["bound_by"] = bound(
        7 * elems * 2 + 3 * bh * s * 4 + extra, 10 * d * pairs,
        BF16_TENSOR_FLOPS)
    return fwd, bwd


def _time_evo_attention(gen, flush, bh, s, d, *, with_k34, with_bias=True,
                        dtype="bf16"):
    """K5 (and K3, K4) at an evoformer shape: q/k/v (bh, s, d) bf16,
    non-causal, a (bh, s, s) f32 bias at G = BH, beside the plain
    versions and SDPA with the same bias as a bf16 ``attn_mask`` of (B,
    H, S, S), H = 4.  K5's library call is SDPA's backward with the mask
    requiring grad, which returns dq, dk, dv and the mask's gradient: it
    stands beside K4 + K5 (``k4_plus_k5_ms``), not K5 alone.  Bounds:
    q, k, v (dO) read, o (dq, dk, dv) written, the f32 row statistics,
    the bias read and (K5) dbias written, against 2 products of 2·D
    flops per pair forward, 5 backward, 2 for K5's recompute.  Without
    ``with_bias`` (MSA column attention) only K3 and K4 run, and SDPA
    without a mask.  With ``dtype="f32"`` q, k, v, dO, the SDPA mask and
    SDPA run in f32 and the bytes count 4 per element; the f32 instances
    of K3, K4 and K5 count three TF32 products per product against the
    TF32 tensor-core peak (3xTF32)."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as attn

    b = bh // EVO_HEADS
    scale = d ** -0.5
    q, k, v = attn_inputs(bh, s, s, d, gen)
    if dtype == "f32":
        q, k, v = (t.float() for t in (q, k, v))
    elem = q.element_size()
    # (product multiplier, peak) of K3, K4 and K5
    k34 = (3, TF32_TENSOR_FLOPS) if dtype == "f32" else (1, BF16_TENSOR_FLOPS)
    bias = (torch.randn(bh, s, s, generator=gen, device="cuda") if with_bias
            else None)
    kw = dict(scale=scale, causal=False)
    pairs = bh * s * s
    elems = bh * s * d
    stats = 3 * bh * s * 4
    bias_bytes = 0 if bias is None else bias.numel() * 4
    q4, k4, v4 = (t.reshape(b, EVO_HEADS, s, d) for t in (q, k, v))
    mask4 = (None if bias is None
             else bias.reshape(b, EVO_HEADS, s, s).to(q.dtype))

    def library(fn):
        """A library timing, or None (logged) where SDPA refuses."""
        try:
            return time_ms(fn, flush=flush)
        except RuntimeError as exc:
            log(f"  SDPA refused: {str(exc).splitlines()[0][:200]}")
            return None

    rows = {}
    o, _, m, l = attn.flash_fwd(q, k, v, bias, **kw)
    do = torch.randn(bh, s, d, generator=gen, device="cuda").to(q.dtype)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, m, l, delta, bias)
    if with_k34:
        rows["flash_fwd"] = dict(
            ms=time_ms(lambda: attn.flash_fwd(q, k, v, bias, **kw),
                       flush=flush),
            plain_ms=time_ms(lambda: attn.flash_fwd_reference(q, k, v, bias,
                                                              **kw),
                             flush=flush),
            library_ms=library(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask4, scale=scale)),
        )
        rows["flash_fwd"]["bound_ms"], rows["flash_fwd"]["bound_by"] = bound(
            4 * elems * elem + stats + bias_bytes, k34[0] * 4 * d * pairs,
            k34[1])
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
        o_lib = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask4,
                                               scale=scale)
        rows["flash_bwd"] = dict(
            ms=time_ms(lambda: attn.flash_bwd(*args, **kw), flush=flush),
            plain_ms=time_ms(lambda: attn.flash_bwd_reference(*args, **kw),
                             flush=flush),
            library_ms=library(lambda: torch.autograd.grad(
                o_lib, (qr, kr, vr), do.reshape(q4.shape),
                retain_graph=True)),
        )
        rows["flash_bwd"]["bound_ms"], rows["flash_bwd"]["bound_by"] = bound(
            7 * elems * elem + stats + bias_bytes, k34[0] * 10 * d * pairs,
            k34[1])
        del o_lib
    if bias is None:
        return rows
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    mr = mask4.detach().clone().requires_grad_()
    lib_k45 = None
    try:
        o_lib = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mr,
                                               scale=scale)
        lib_k45 = library(lambda: torch.autograd.grad(
            o_lib, (qr, kr, vr, mr), do.reshape(q4.shape), retain_graph=True))
        del o_lib
    except RuntimeError as exc:
        log(f"  SDPA refused a mask that requires grad: "
            f"{str(exc).splitlines()[0][:200]}")
    k5_ms = time_ms(lambda: attn.flash_dbias(*args, **kw), flush=flush)
    k4_ms = (rows["flash_bwd"]["ms"] if with_k34
             else time_ms(lambda: attn.flash_bwd(*args, **kw), flush=flush))
    rows["flash_dbias"] = dict(
        ms=k5_ms,
        plain_ms=time_ms(lambda: attn.flash_dbias_reference(*args, **kw),
                         flush=flush),
        library_ms=lib_k45,
        k4_ms=k4_ms,
        k4_plus_k5_ms=k4_ms + k5_ms,
    )
    rows["flash_dbias"]["bound_ms"], rows["flash_dbias"]["bound_by"] = bound(
        4 * elems * elem + stats + 2 * bias_bytes, k34[0] * 4 * d * pairs,
        k34[1])
    # (an older tree, timed with this script, has no fused call)
    if hasattr(attn, "flash_bwd_dbias") and attn._fused_dbias(
            bias, bh, s, q.dtype, d):
        # the fused call computes K4's and K5's functions in one: q, k, v,
        # dO, the statistics and the bias read once, dq, dk, dv and dbias
        # written once, K4's five products
        fused_ms = time_ms(lambda: attn.flash_bwd_dbias(*args, **kw),
                           flush=flush)
        rows["flash_bwd_dbias"] = dict(
            ms=fused_ms,
            plain_ms=time_ms(
                lambda: attn.flash_bwd_dbias_reference(*args, **kw),
                flush=flush),
            library_ms=lib_k45,
            k4_ms=k4_ms,
            k5_ms=k5_ms,
            k4_plus_k5_ms=k4_ms + k5_ms,
        )
        rows["flash_bwd_dbias"]["bound_ms"], rows["flash_bwd_dbias"][
            "bound_by"] = bound(7 * elems * elem + stats + 2 * bias_bytes,
                                10 * d * pairs, BF16_TENSOR_FLOPS)
    return rows


def _time_f32_attention(gen, flush):
    """The f32 instances of K3, K4 and K5 at the evoformer's three shapes,
    those of phase 10's f32 run (:func:`_time_evo_attention` with
    ``dtype="f32"``): {kernel: {"triangle_shape" | "msa_row_shape" |
    "msa_col_shape": row}}; MSA column attention has no bias and no K5."""
    import torch

    out = {}
    for tag, (bh, s, d), with_bias, what in (
            ("triangle_shape", TRIANGLE_SHAPE, True, "triangle attention"),
            ("msa_row_shape", MSA_ROW_SHAPE, True, "MSA row attention"),
            ("msa_col_shape", MSA_COL_SHAPE, False, "MSA column attention")):
        timed = _time_evo_attention(gen, flush, bh, s, d, with_k34=True,
                                    with_bias=with_bias, dtype="f32")
        shape = (f"BH={bh} S={s} D={d} non-causal f32, "
                 + (f"bias ({bh}, {s}, {s}) f32" if with_bias else "no bias")
                 + f" ({what})")
        for name, row in timed.items():
            out.setdefault(name + "_f32", {})[tag] = dict(row, shape=shape)
        torch.cuda.empty_cache()
    return out


def phase4(gen, launches, errs):
    """Each kernel at its main-path shapes: the GPT training shapes of
    phase 6 (K1, K2 at x (16384, 1024), which is also BERT's B·S x
    hidden; K3, K4 at BH=128, S=2048), BERT's attention of phase 8 (K3,
    K4 at BH=2048, S=128 with the padding bias, without and with dropout
    0.1) and the serving shapes of phase 2 (K1 at (2048, 1024), K3 at
    BH=16, S=2048, K6 at the decode batch), and the evoformer's attention
    of phase 10 (K3, K4 and K5 at the triangle and MSA row shapes, K3
    and K4 at the MSA column shape).  Beside them: K1 and K2 at the
    evoformer's f32 rows (pair (65536, 128), MSA (32768, 256)), K3 and K4
    at the reference's long-context shape (BH 8, S 16384, D 128, causal)
    and at D = 256 (BH 32, S 2048, causal), K3, K4 and K5 at D = 384 (BH
    32, S 2048), K6 at phase 1's short lengths, and the f32 instances of
    K3, K4 and K5 at the triangle, MSA row and MSA column shapes (the
    f32-attention run of phase 10).  ``launches`` maps kernel -> {path:
    count} from the phase-2, -6, -8 and -10 runs (empty with
    ``--timing``)."""
    import torch

    from apex_tpu_torch.ops import _build
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
    extra = {}  # kernel -> {tag: row} of the shapes beside its main one
    for tag, n_rows, hidden in (
            ("evo_pair_shape", EVO_RES * EVO_RES, EVO["pair_dim"]),
            ("evo_msa_shape", EVO_SEQ * EVO_RES, EVO["msa_dim"])):
        ln_fwd, ln_bwd = _time_ln(gen, flush, n_rows, hidden, "f32")
        extra.setdefault("layer_norm_fwd", {})[tag] = dict(
            ln_fwd, shape=f"x ({n_rows}, {hidden}) f32 (evoformer)")
        extra.setdefault("layer_norm_bwd", {})[tag] = dict(
            ln_bwd, shape=f"x, g ({n_rows}, {hidden}) f32 (evoformer)")
        torch.cuda.empty_cache()
    at_fwd, at_bwd = _time_attn(gen, flush, train_bh, TRAIN_SEQ, with_bwd=True)
    shape = f"BH={train_bh} S={TRAIN_SEQ} D=64 causal bf16"
    rows["flash_fwd"] = dict(at_fwd, shape=shape)
    rows["flash_bwd"] = dict(at_bwd, shape=shape + ", m/l/delta f32")
    torch.cuda.empty_cache()

    for p, tag in ((0.0, "bert_shape"), (0.1, "bert_dropout_shape")):
        b_fwd, b_bwd = _time_attn_bert(gen, flush, p)
        shape = (f"BH={BERT_BATCH * 16} S={BERT_SEQ} D=64 non-causal bf16, "
                 f"bias (B, 1, S) f32, dropout {p}")
        extra.setdefault("flash_fwd", {})[tag] = dict(b_fwd, shape=shape)
        extra.setdefault("flash_bwd", {})[tag] = dict(b_bwd, shape=shape)
        torch.cuda.empty_cache()

    tri_bh, tri_s, tri_d = TRIANGLE_SHAPE
    row_bh, row_s, row_d = MSA_ROW_SHAPE
    evo = _time_evo_attention(gen, flush, tri_bh, tri_s, tri_d,
                              with_k34=True)
    tri_shape = (f"BH={tri_bh} S={tri_s} D={tri_d} non-causal bf16, bias "
                 f"({tri_bh}, {tri_s}, {tri_s}) f32 (triangle attention)")
    for name in ("flash_fwd", "flash_bwd"):
        extra.setdefault(name, {})["triangle_shape"] = dict(evo[name],
                                                           shape=tri_shape)
    rows["flash_dbias"] = dict(evo["flash_dbias"], shape=tri_shape)
    if "flash_bwd_dbias" in evo:
        rows["flash_bwd_dbias"] = dict(evo["flash_bwd_dbias"], shape=tri_shape)
    torch.cuda.empty_cache()
    msa = _time_evo_attention(gen, flush, row_bh, row_s, row_d,
                              with_k34=True)
    row_shape = (f"BH={row_bh} S={row_s} D={row_d} non-causal bf16, bias "
                 f"({row_bh}, {row_s}, {row_s}) f32 (MSA row attention)")
    for name in ("flash_fwd", "flash_bwd", "flash_dbias", "flash_bwd_dbias"):
        if name in msa:
            extra.setdefault(name, {})["msa_row_shape"] = dict(
                msa[name], shape=row_shape)
    torch.cuda.empty_cache()
    col_bh, col_s, col_d = MSA_COL_SHAPE
    msa = _time_evo_attention(gen, flush, col_bh, col_s, col_d,
                              with_k34=True, with_bias=False)
    for name in ("flash_fwd", "flash_bwd"):
        extra[name]["msa_col_shape"] = dict(
            msa[name], shape=f"BH={col_bh} S={col_s} D={col_d} non-causal "
            f"bf16, no bias (MSA column attention)")
    torch.cuda.empty_cache()
    long_fwd, long_bwd = _time_attn_long(gen, flush)
    shape = f"BH={LONG_BH} S={LONG_S} D={LONG_D} causal bf16 (long context)"
    extra["flash_fwd"]["long_context_shape"] = dict(long_fwd, shape=shape)
    extra["flash_bwd"]["long_context_shape"] = dict(
        long_bwd, shape=shape + ", m/l/delta f32")
    torch.cuda.empty_cache()
    for name, by_shape in _time_f32_attention(gen, flush).items():
        rows[name] = by_shape.pop("triangle_shape")
        extra.setdefault(name, {}).update(by_shape)
    # a head dim past 128, which no model of either package runs
    wide_fwd, wide_bwd = _time_attn(gen, flush, WIDE_BH, WIDE_S,
                                    with_bwd=True, d=WIDE_D)
    shape = f"BH={WIDE_BH} S={WIDE_S} D={WIDE_D} causal bf16 (no model path)"
    extra["flash_fwd"]["d256_shape"] = dict(wide_fwd, shape=shape)
    extra["flash_bwd"]["d256_shape"] = dict(wide_bwd,
                                            shape=shape + ", m/l/delta f32")
    torch.cuda.empty_cache()
    # and past 256 (the wide instance)
    wider = _time_attn_wider(gen, flush)
    if wider is not None:
        shape = f"BH={WIDE_BH} S={WIDE_S} D={WIDER_D} bf16 (no model path)"
        for name, r, what in zip(
                ("flash_fwd", "flash_bwd", "flash_dbias"), wider,
                (" causal", " causal, m/l/delta f32",
                 f" non-causal, bias ({WIDE_BH}, {WIDE_S}, {WIDE_S}) f32")):
            extra.setdefault(name, {})["d384_shape"] = dict(
                r, shape=shape + what)
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

    def library_paged(a, scale):
        """The same decode as one PyTorch gather of the pages and SDPA
        over them, with the RoPE applied to q first and the lengths as a
        mask, at any B, H, D and page size of ``a`` (paged_inputs)."""
        import torch.nn.functional as F

        from apex_tpu_torch.ops.rope import rotate_half

        b, h, d = a["q"].shape
        qf = a["q"].float()
        qr = (qf * a["rope_cos"][:, None] + rotate_half(qf)
              * a["rope_sin"][:, None]).to(a["k_pages"].dtype)
        table = a["page_table"].long()
        kk = a["k_pages"][table].transpose(1, 2).reshape(b, h, -1, d)
        vv = a["v_pages"][table].transpose(1, 2).reshape(b, h, -1, d)
        mask = (torch.arange(kk.shape[2], device="cuda")[None]
                < a["lengths"][:, None])[:, None, None]
        return F.scaled_dot_product_attention(qr[:, :, None], kk, vv,
                                              attn_mask=mask, scale=scale)

    serving["paged_decode"] = dict(
        shape="B=8 H=16 D=64 page=16 NP=128 bf16, "
        f"lengths {MAIN_LENGTHS}",
        ms=time_ms(lambda: pa.paged_decode_fwd(*pos, **kw), flush=flush),
        plain_ms=time_ms(
            lambda: pa.paged_decode_attention_reference(*pos, **kw),
            flush=flush),
        library_ms=time_ms(lambda: library_paged(args, 0.125), flush=flush),
        bound_ms=b_ms, bound_by=b_by,
    )
    # and at phase 1's short lengths (one split a row): f32 pages
    short = paged_inputs(b=3, h=4, d=32, page=8, np_=3, pool=12,
                         lengths=[17, 9, 0], gen=gen, kv="f32")
    pos = [short[k] for k in ("q", "k_pages", "v_pages", "page_table",
                              "lengths")]
    kw = dict(scale=32 ** -0.5, rope_cos=short["rope_cos"],
              rope_sin=short["rope_sin"])
    tokens = 17 + 9
    b_ms, b_by = bound(2 * tokens * 4 * 32 * 4 + 2 * 3 * 4 * 32 * 4
                       + 2 * 3 * 32 * 4 + 4 * 9 + 4 * 3,
                       4 * 4 * 32 * tokens, F32_FLOPS)
    extra.setdefault("paged_decode", {})["short_shape"] = dict(
        shape="B=3 H=4 D=32 page=8 NP=3 f32, lengths [17, 9, 0]",
        ms=time_ms(lambda: pa.paged_decode_fwd(*pos, **kw), flush=flush),
        plain_ms=time_ms(
            lambda: pa.paged_decode_attention_reference(*pos, **kw),
            flush=flush),
        library_ms=time_ms(lambda: library_paged(short, 32 ** -0.5),
                           flush=flush),
        bound_ms=b_ms, bound_by=b_by,
    )

    def fields(r):
        return {key: r[key] for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "library",
                                        "shape", "k4_ms", "k5_ms",
                                        "k4_plus_k5_ms")
                if key in r}

    kernels = []
    for name in KERNEL_ENTRIES:
        main = rows.get(name, serving.get(name))
        if main is None:  # --timing on an older tree without this entry
            log(f"  {name}: not in this tree")
            continue
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"apex_tpu_torch/csrc/{_build.library(name)}.cu",
            "replaces": REPLACES[name],
            "launches": sum(launches.get(name, {}).values()),
            "launches_by_path": launches.get(name, {}),
            "max_abs_err": errs.get(name),
            **fields(main),
        }
        if name in PHASE1_ONLY_ENTRIES:  # no main path: phase 1's count
            entry["phase1_launches"] = errs.get(f"{name}_phase1_launches")
        if name + "_d128" in errs:  # phase 1's first D = 128 case
            entry["max_abs_err_d128"] = errs[name + "_d128"]
        if name in rows and name in serving:
            entry["serving_shape"] = fields(serving[name])
        for tag, r in extra.get(name, {}).items():
            entry[tag] = fields(r)
        kernels.append(entry)
        for tag, r in (("", main), (" (serving)", entry.get("serving_shape")),
                       (" (BERT)", entry.get("bert_shape")),
                       (" (BERT, dropout)", entry.get("bert_dropout_shape")),
                       (" (triangle)", entry.get("triangle_shape")),
                       (" (MSA row)", entry.get("msa_row_shape")),
                       (" (MSA column)", entry.get("msa_col_shape")),
                       (" (long context)", entry.get("long_context_shape")),
                       (" (D = 256)", entry.get("d256_shape")),
                       (" (D = 384)", entry.get("d384_shape")),
                       (" (short lengths)", entry.get("short_shape")),
                       (" (evoformer pair)", entry.get("evo_pair_shape")),
                       (" (evoformer MSA)", entry.get("evo_msa_shape"))):
            if r is None:
                continue
            lib = ("not measured" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
            plain_s = ("not measured" if r["plain_ms"] is None
                       else f"{r['plain_ms']:.4f} ms")
            k45 = ("" if "k4_plus_k5_ms" not in r else
                   f" (K4 {r['k4_ms']:.4f} ms, "
                   + (f"K5 {r['k5_ms']:.4f} ms, " if "k5_ms" in r else "")
                   + f"K4 + K5 {r['k4_plus_k5_ms']:.4f} ms beside the "
                   f"library's backward with the mask's gradient)")
            if "library" in r:
                lib += f" ({r['library']})"
            log(f"  {name}{tag} [{r['shape']}]: kernel {r['ms']:.4f} ms, "
                f"plain {plain_s}, library {lib}, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}){k45}")
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


#: kernel-name fragments -> the layer that owns the time (phases 6, 8, 10)
KERNEL_GROUPS = (
    ("K3 flash_fwd", ("flash_fwd_kernel", "flash_fwd_wide_kernel")),
    ("K4 flash_bwd", ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                      "flash_bwd_dkdv_wide_kernel",
                      "flash_bwd_dq_wide_kernel")),
    # the fused call's dQ pass with the dbias epilogue (its dK/dV pass
    # counts under K4)
    ("K4+K5 dQ pass with dbias", ("flash_bwd_dq_dbias_kernel",)),
    ("K5 flash_dbias", ("flash_dbias_kernel",)),
    ("K3 flash_fwd_f32", ("flash_fwd_f32_kernel",
                          "flash_fwd_f32_wide_kernel")),
    ("K4 flash_bwd_f32", ("flash_bwd_dkdv_f32_kernel",
                          "flash_bwd_dq_f32_kernel",
                          "flash_bwd_dkdv_f32_wide_kernel",
                          "flash_bwd_dq_f32_wide_kernel")),
    ("K5 flash_dbias_f32", ("flash_dbias_f32_kernel",)),
    ("K6 paged_decode", ("paged_decode_kernel",)),
    ("K1 layer_norm_fwd", ("ln_fwd_kernel",)),
    ("K2 layer_norm_bwd", ("ln_bwd_kernel",)),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "xmma", "cutlass")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
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
    k6 = [k for k in kernels if "paged_decode_kernel" in k[0]]
    out["k6_ms_per_step"] = sum(k[1] for k in k6) / 1e3 / steps
    out["k6_launches_per_step"] = sum(k[2] for k in k6) / steps
    out["k6_share_of_device"] = out["k6_ms_per_step"] / out[
        "device_ms_per_step"]
    log(f"  device kernels {out['device_ms_per_step']:.3f} ms/step, busy "
        f"share {out['device_busy_share']:.3f} profiled and "
        f"{out['device_busy_share_unprofiled']:.3f} against the unprofiled "
        f"host time, {out['kernel_launches_per_step']:.0f} kernel "
        f"launches/step; K6 {out['k6_ms_per_step']:.4f} ms/step in "
        f"{out['k6_launches_per_step']:.0f} launches, "
        f"{out['k6_share_of_device']:.3f} of the kernel time")
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
        if not rel <= GRAD_REL_TOL:
            raise AssertionError(f"phase 7: grad of {k} off by {rel:.3e}")
    log(f"  worst per-parameter grad relative error {worst_grad:.3e} "
        f"(tol {GRAD_REL_TOL}); after one Adam step: worst max |Δ update| "
        f"{worst_max:.3e} (tol {ADAM_MAX_TOL:.3e}), worst mean |Δ update| "
        f"{worst_mean:.3e} (tol {ADAM_MEAN_TOL:.3e})")
    if not (worst_max <= ADAM_MAX_TOL and worst_mean <= ADAM_MEAN_TOL):
        raise AssertionError("phase 7: the Adam updates disagree")
    return {"loss_card": l_card, "loss_cpu": l_cpu,
            "max_grad_rel_err": worst_grad, "max_update_diff": worst_max,
            "max_mean_update_diff": worst_mean}


# ---------------------------------------------------------------------------
# phase 8: BERT-Large pretraining at full width
# ---------------------------------------------------------------------------


BERT_STEPS = 8
BERT_DROPOUT_STEPS = 2


def bert_step_launches(layers):
    """Kernel launches of one BERT training step with full remat and L
    layers: K1 runs 2L+2 times forward (the embedding LayerNorm, two per
    block, the MLM transform's) and 2L again in the blocks' recompute, K2
    2L+2 times, K3 L + L times (forward and recompute) and K4 L times."""
    return {"layer_norm_fwd": (2 * layers + 2) + 2 * layers,
            "layer_norm_bwd": 2 * layers + 2,
            "flash_fwd": 2 * layers, "flash_bwd": layers}


def _check_launches(tag, steps, layers):
    from apex_tpu_torch.ops import _dispatch

    launches = _dispatch.launches()
    paths = _dispatch.last_paths()
    per_step = bert_step_launches(layers)
    want = {k: n * steps for k, n in per_step.items()}
    log(f"  {tag}: launches={launches} (per step {per_step}) paths={paths}")
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want}")
    if paths != {"layer_norm": "cuda", "flash_attention": "cuda"}:
        raise AssertionError(f"{tag}: op paths {paths}")
    return launches


def phase8():
    """``examples.pretrain_bert``'s ``train`` at ``BertConfig(remat=True)``
    (BERT-Large, bf16 compute on f32 weights), batch 128, seq 128, K = 20
    masked predictions per sequence, FusedLAMB at lr 1e-3, 8 steps on the
    synthetic corpus; then 2 steps with dropout 0.1 in the attention and
    hidden layers (``deterministic=False``) through the same
    ``train_step``.  The launch counters are zeroed before each run and
    read after it: K1-K4 must have launched exactly their per-step counts
    times the steps.  Losses must be finite, and falling over the 8
    steps.  Then one more step under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.examples import pretrain_bert
    from apex_tpu_torch.ops import _dispatch

    log(f"phase 8: train BertConfig(remat=True) {BERT_STEPS} steps at batch "
        f"{BERT_BATCH}, seq {BERT_SEQ}, then {BERT_DROPOUT_STEPS} with "
        f"dropout")
    args = pretrain_bert.parse_args([
        "--steps", str(BERT_STEPS), "--batch", str(BERT_BATCH),
        "--seq-len", str(BERT_SEQ),
    ])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    run = pretrain_bert.train(args)
    torch.cuda.synchronize()
    layers = run.cfg.num_layers
    launches = {"bert": _check_launches("BERT", BERT_STEPS, layers)}
    peak = torch.cuda.max_memory_allocated()
    losses = run.losses
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")

    gen = torch.Generator().manual_seed(99)
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    drop_losses, drop_seconds = [], []
    for _ in range(BERT_DROPOUT_STEPS):
        batch = next(run.batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drop_losses.append(float(pretrain_bert.train_step(
            run.model, run.optimizer, batch, generator=gen)))
        torch.cuda.synchronize()
        drop_seconds.append(time.perf_counter() - t0)
    launches["bert_dropout"] = _check_launches(
        "BERT with dropout", BERT_DROPOUT_STEPS, layers)
    if not all(np.isfinite(drop_losses)):
        raise AssertionError(f"dropout losses not finite: {drop_losses}")

    n_params = sum(p.numel() for p in run.model.parameters())
    step_s = statistics.median(run.step_seconds[1:])
    mfu = 6 * n_params * run.tokens_per_step / step_s / BF16_TENSOR_FLOPS
    log(f"  losses {[round(x, 4) for x in losses]}; with dropout "
        f"{[round(x, 4) for x in drop_losses]}")
    log(f"  step seconds {[round(x, 4) for x in run.step_seconds]}; median "
        f"of steps 1.. {step_s * 1e3:.1f} ms, "
        f"{run.sequences_per_step / step_s:.1f} sequences/s, "
        f"{run.tokens_per_step / step_s:.0f} tokens/s, 6NT MFU {mfu:.4f} "
        f"(N={n_params}), peak memory {peak / 1e9:.2f} GB; with dropout "
        f"{[round(x * 1e3, 1) for x in drop_seconds]} ms")

    batch = next(run.batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pretrain_bert.train_step(run.model, run.optimizer, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = sorted(device_kernels(prof), key=lambda o: -o[1])
    busy_ms = sum(o[1] for o in ops) / 1e3
    groups = group_kernels(ops)
    log(f"  profiled step: {wall * 1e3:.1f} ms host, {busy_ms:.1f} ms of "
        f"device kernels ({busy_ms / (wall * 1e3):.3f} busy; "
        f"{busy_ms / (step_s * 1e3):.3f} of the unprofiled median step), "
        f"{sum(o[2] for o in ops)} kernel launches")
    log("  device ms by layer: " + ", ".join(
        f"{k} {v:.2f}" for k, v in groups.items()))
    top = []
    for key, us, count in ops[:15]:
        log(f"    {us / 1e3:9.3f} ms  {count:5d}x  {key[:100]}")
        top.append({"op": key[:100], "ms": us / 1e3, "count": count})
    out = {
        "device_busy_share_unprofiled": busy_ms / (step_s * 1e3),
        "losses": losses,
        "dropout_losses": drop_losses,
        "step_seconds": run.step_seconds,
        "dropout_step_seconds": drop_seconds,
        "step_ms_median": step_s * 1e3,
        "sequences_per_s": run.sequences_per_step / step_s,
        "tokens_per_s": run.tokens_per_step / step_s,
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
# phase 9: one BERT training step with dropout, card bf16 against CPU f32
# ---------------------------------------------------------------------------


#: The phase-9 limits, like phase 7's, sit between the sound reading and
#: the readings of a planted fault in one plain twin.  Faulty, each f32
#: CPU step with one twin altered against the sound f32 CPU step: K3
#: dropping the bias moves the loss by 4.0e-3, a gradient by 55% and an
#: update by 104%; K4 recomputing p = exp(s - lse) (the TPU's rule, wrong
#: in the fully padded row) moves a gradient 4300-fold and an update by
#: 154%; K4 hashing the keep mask with seed + 1 moves a gradient by 22%
#: and an update by 84%; K4 leaving the keep mask off dP by 14% and 74%;
#: K4 dropping the bias gives non-finite gradients; K2 dropping the
#: mean(g·w) term of dx moves a gradient by 4.1% and an update by 19%.
#: The same comparison with the CPU in bf16 reads 2.2e-3, 1.1% and 17.5%.
#: |loss(card bf16) - loss(CPU f32)|: the loss is ~11.6
BERT_LOSS_TOL = 3e-3
#: per parameter, ||grad_card - grad_cpu|| / ||grad_cpu||
BERT_GRAD_REL_TOL = 3e-2
#: per parameter, ||update_card - update_cpu|| / ||update_cpu||: LAMB's
#: first step moves each element by about ±lr·ratio, so an element whose
#: gradient sign differs between bf16 and f32 moves the other way; this
#: limit catches the attention twins' faults, the gradient limit K2's
BERT_UPDATE_REL_TOL = 0.5
BERT_LR = 1e-3
BERT_CROSS_LENGTHS = (128, 100, 37, 0)


def bert_cross_step(device, seed_model=13):
    """One ``bert_pretrain_loss`` + FusedLAMB step of the 2-layer,
    full-width BERT with attention dropout 0.1 (hidden dropout 0) on
    ``device`` ("cuda": bf16 compute; "cpu": f32), from the weights drawn
    on the CPU from ``seed_model`` and a fixed batch: B = 4, S = 128,
    attention_mask lengths 128/100/37/0 (the last sequence has no real
    token), 20 packed predictions per sequence, the dropout generator
    seeded alike on both sides (the same attention masks).  Returns
    (loss, {name: grad}, {name: update}) on the CPU in f32."""
    import torch

    from apex_tpu_torch import data
    from apex_tpu_torch.models import BertConfig, BertForPreTraining
    from apex_tpu_torch.models import bert_pretrain_loss
    from apex_tpu_torch.optimizers import FusedLAMB

    cfg = BertConfig(num_layers=2, attention_dropout=0.1, hidden_dropout=0.0,
                     dtype=torch.bfloat16 if device == "cuda"
                     else torch.float32)
    model = BertForPreTraining(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(
                                   seed_model)).to(device)
    rs = np.random.RandomState(5)
    b, s = len(BERT_CROSS_LENGTHS), BERT_SEQ
    ids = rs.randint(1000, cfg.vocab_size, size=(s, b)).astype(np.int32)
    labels = np.where(rs.rand(s, b) < 0.15, ids, -1).astype(np.int32)
    pos, pids, w = data.pack_mlm_predictions(labels, 20)
    batch = {
        "input_ids": ids,
        "token_type_ids": (np.arange(s)[:, None] >= s // 2).repeat(b, 1)
        .astype(np.int32),
        "attention_mask": (np.arange(s)[None] < np.array(
            BERT_CROSS_LENGTHS)[:, None]).astype(np.int32),
        "nsp_labels": rs.randint(0, 2, size=(b,)).astype(np.int32),
        "mlm_positions": pos, "mlm_label_ids": pids, "mlm_weights": w,
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    before = {k: p.detach().float().cpu().clone()
              for k, p in model.named_parameters()}
    opt = FusedLAMB(model.parameters(), lr=BERT_LR, weight_decay=0.01)
    loss = bert_pretrain_loss(model, batch, deterministic=False,
                              generator=torch.Generator().manual_seed(17))
    loss.backward()
    grads = {k: p.grad.detach().float().cpu()
             for k, p in model.named_parameters()}
    opt.step()
    updates = {k: p.detach().float().cpu() - before[k]
               for k, p in model.named_parameters()}
    return float(loss.detach()), grads, updates


def compare_cross(a, b):
    """(|loss diff|, worst per-parameter relative gradient error, worst
    per-parameter relative update error) of step ``a`` against the
    reference step ``b``, with the names of the worst parameters."""
    (la, ga, ua), (lb, gb, ub) = a, b

    def worst(x, y):
        rel = {k: float((x[k] - y[k]).norm() / y[k].norm().clamp_min(1e-30))
               for k in y}
        rel = {k: r if np.isfinite(r) else float("inf") for k, r in rel.items()}
        k = max(rel, key=rel.get)
        return rel[k], k

    return abs(la - lb), worst(ga, gb), worst(ua, ub)


def phase9():
    """BERT at full width with 2 layers: the loss, every parameter's
    gradient and the weights after one FusedLAMB step on the card (bf16,
    K1-K4 with the padding bias and attention dropout) against the CPU
    (f32, the plain twins), from the same weights, batch and attention
    dropout seeds."""
    log("phase 9: 2-layer full-width BERT step with attention dropout and "
        "a fully padded row, card bf16 against CPU f32")
    card = bert_cross_step("cuda")
    cpu = bert_cross_step("cpu")
    dloss, (grad_rel, grad_k), (upd_rel, upd_k) = compare_cross(card, cpu)
    log(f"  loss card={card[0]:.6f} cpu={cpu[0]:.6f} diff={dloss:.2e} "
        f"(tol {BERT_LOSS_TOL}); worst grad relative error {grad_rel:.3e} "
        f"({grad_k}, tol {BERT_GRAD_REL_TOL}); after one LAMB step worst "
        f"update relative error {upd_rel:.3e} ({upd_k}, tol "
        f"{BERT_UPDATE_REL_TOL})")
    if not dloss <= BERT_LOSS_TOL:
        raise AssertionError("phase 9: the losses disagree")
    if not grad_rel <= BERT_GRAD_REL_TOL:
        raise AssertionError(f"phase 9: grad of {grad_k} off by {grad_rel}")
    if not upd_rel <= BERT_UPDATE_REL_TOL:
        raise AssertionError(f"phase 9: update of {upd_k} off by {upd_rel}")
    return {"loss_card": card[0], "loss_cpu": cpu[0],
            "max_grad_rel_err": grad_rel, "max_update_rel_err": upd_rel}


# ---------------------------------------------------------------------------
# phase 10: evoformer training at AlphaFold2's widths
# ---------------------------------------------------------------------------


#: EvoformerBlock(msa_dim=256, pair_dim=128, heads=4, mlp_ratio=4,
#: opm_hidden=32): OpenFold's evoformer_stack widths (c_m 256, c_z 128,
#: c_hidden_mul 128, c_hidden_opm 32, 4 triangle heads of 32,
#: transition_n 4); 4 of its 48 blocks, at the initial-training crop
#: (N_res 256, N_seq 128, ``EVO_RES``/``EVO_SEQ``)
EVO = dict(msa_dim=256, pair_dim=128, heads=EVO_HEADS, mlp_ratio=4,
           opm_hidden=32)
EVO_BLOCKS = 4
EVO_STEPS = 8
EVO_LR = 3e-4
#: per block and step: LayerNorm 12 times (MSA row attention 2, column
#: attention, MSA transition, outer product mean, 2 per triangle update,
#: 1 per triangle attention, pair transition), attention 4 times (MSA
#: row, MSA column, triangle start, triangle end), a trainable bias 3
#: times (all but the column attention): those three backwards take the
#: fused call (G = BH, RS = Sq), the column attention the plain K4, and
#: the standalone K5 launches no time
EVO_BLOCK_LAUNCHES = {"layer_norm_fwd": 12, "layer_norm_bwd": 12,
                      "flash_fwd": 4, "flash_bwd": 1, "flash_bwd_dbias": 3,
                      "flash_dbias": 0}


def evoformer_block_flops(n_seq, n_res, msa_dim, pair_dim, heads, mlp_ratio,
                          opm_hidden):
    """Matrix-product flops of one EvoformerBlock forward (2 per
    multiply-add; the triangle updates' hidden width is pair_dim):
    MSA row and column attention (q, k, v, gate, out projections, the
    pair-bias projection, QK^T and PV), the MSA transition, the outer
    product mean (a, b, the outer product, out), two triangle
    multiplicative updates (a, a_gate, b, b_gate, the contraction, out,
    gate), two triangle attentions and the pair transition."""
    s, r, cm, cz, h = n_seq, n_res, msa_dim, pair_dim, heads
    msa_rows = s * r
    pair_rows = r * r
    f = 0
    f += 5 * 2 * msa_rows * cm * cm + 2 * pair_rows * cz * h   # row proj
    f += 4 * s * r * r * cm                                   # row attention
    f += 5 * 2 * msa_rows * cm * cm + 4 * r * s * s * cm      # column
    f += 2 * 2 * msa_rows * cm * mlp_ratio * cm               # transition
    f += 2 * 2 * msa_rows * cm * opm_hidden                   # OPM a, b
    f += 2 * s * pair_rows * opm_hidden ** 2                  # outer product
    f += 2 * pair_rows * opm_hidden ** 2 * cz                 # OPM out
    tri_mul = 4 * 2 * pair_rows * cz * cz + 2 * r ** 3 * cz + 2 * 2 * pair_rows * cz * cz
    f += 2 * tri_mul
    tri_att = 5 * 2 * pair_rows * cz * cz + 2 * pair_rows * cz * h + 4 * r ** 3 * cz
    f += 2 * tri_att
    f += 2 * 2 * pair_rows * cz * mlp_ratio * cz              # transition
    return f


def randomize_zero_params(module, generator, std=0.02):
    """Every parameter that is exactly zero at init (the out/down and gate
    kernels, the biases, the LayerNorm biases) gets N(0, std^2) from
    ``generator``, as the JAX tests' ``_randomize`` breaks the zero init:
    otherwise the output is the input and every gradient through the
    attention, dbias included, is zero."""
    import torch

    with torch.no_grad():
        for p in module.parameters():
            if not bool(p.any()):
                p.copy_(std * torch.randn(p.shape, generator=generator,
                                          device=generator.device))


def evoformer_stack(n_blocks, device, generator, dtype):
    import torch

    from apex_tpu_torch.contrib.openfold import EvoformerBlock

    blocks = torch.nn.ModuleList(
        EvoformerBlock(**EVO, dtype=dtype, device=device, generator=generator)
        for _ in range(n_blocks))
    randomize_zero_params(blocks, generator)
    return blocks


def evoformer_data(n_seq, n_res, device, seed):
    """Seeded MSA and pair inputs and MSE targets (numpy, then
    ``device``): m (n_seq, n_res, 256), z (n_res, n_res, 128)."""
    import torch

    rs = np.random.RandomState(seed)
    shapes = ((n_seq, n_res, EVO["msa_dim"]), (n_res, n_res, EVO["pair_dim"]))
    m, z, tm, tz = (torch.from_numpy(rs.randn(*shp).astype(np.float32))
                    .to(device) for shp in shapes * 2)
    return m, z, tm, tz


def evoformer_loss(blocks, m, z, tm, tz):
    for blk in blocks:
        m, z = blk(m, z)
    return (m - tm).pow(2).mean() + (z - tz).pow(2).mean()


def profiled_step(step, step_s):
    """One ``step()`` under ``torch.profiler``: its host time, the device
    kernels' time by layer (``KERNEL_GROUPS``) and the top kernels, and
    the kernels' share of the unprofiled median step ``step_s``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = sorted(device_kernels(prof), key=lambda o: -o[1])
    busy_ms = sum(o[1] for o in ops) / 1e3
    groups = group_kernels(ops)
    log(f"  profiled step: {wall * 1e3:.1f} ms host, {busy_ms:.1f} ms of "
        f"device kernels ({busy_ms / (wall * 1e3):.3f} busy; "
        f"{busy_ms / (step_s * 1e3):.3f} of the unprofiled median step), "
        f"{sum(o[2] for o in ops)} kernel launches")
    log("  device ms by layer: " + ", ".join(
        f"{k} {v:.2f}" for k, v in groups.items()))
    top = []
    for key, us, count in ops[:15]:
        log(f"    {us / 1e3:9.3f} ms  {count:5d}x  {key[:100]}")
        top.append({"op": key[:100], "ms": us / 1e3, "count": count})
    return {
        "device_busy_share_unprofiled": busy_ms / (step_s * 1e3),
        "profiled_step_ms": wall * 1e3,
        "profiled_device_ms": busy_ms,
        "device_ms_by_layer": groups,
        "top_device_ops": top,
    }


def phase10(check_launches=True):
    """4 full-width ``EvoformerBlock``s chained (the JAX package has no
    stack module, so the script chains them) at N_seq 128, N_res 256,
    bf16 attention on f32 weights, the zero-initialised parameters
    randomized, MSE to seeded targets, FusedAdam at lr 3e-4 for 8 steps.
    The launch counters are zeroed before and read after: K1-K5 must
    have launched exactly ``EVO_BLOCK_LAUNCHES`` x blocks x steps (the
    fused K4 + K5 call included; ``check_launches=False`` only logs them,
    for ``--evoformer`` on an older tree), and every op must have taken
    the kernel path.  Losses finite and falling; step time, the analytic
    MFU, peak memory, then one profiled step by layer."""
    import torch

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.optimizers import FusedAdam

    log(f"phase 10: train {EVO_BLOCKS} EvoformerBlock({EVO}) at N_seq "
        f"{EVO_SEQ}, N_res {EVO_RES}, {EVO_STEPS} FusedAdam steps")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(21)
    blocks = evoformer_stack(EVO_BLOCKS, "cuda", gen, torch.bfloat16)
    m, z, tm, tz = evoformer_data(EVO_SEQ, EVO_RES, "cuda", seed=22)
    opt = FusedAdam(blocks.parameters(), lr=EVO_LR)

    def step():
        loss = evoformer_loss(blocks, m, z, tm, tz)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    losses, seconds = [], []
    for _ in range(EVO_STEPS):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = _dispatch.launches()
    paths = _dispatch.last_paths()
    peak = torch.cuda.max_memory_allocated()
    want = {k: n * EVO_BLOCKS * EVO_STEPS
            for k, n in EVO_BLOCK_LAUNCHES.items() if n}
    log(f"  launches={launches} (per block and step {EVO_BLOCK_LAUNCHES}) "
        f"paths={paths}")
    if check_launches and launches != want:
        raise AssertionError(f"evoformer launches {launches} != {want}")
    if paths != {"layer_norm": "cuda", "flash_attention": "cuda"}:
        raise AssertionError(f"evoformer op paths {paths}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    n_params = sum(p.numel() for p in blocks.parameters())
    flops = 3 * EVO_BLOCKS * evoformer_block_flops(EVO_SEQ, EVO_RES, **EVO)
    step_s = statistics.median(seconds[1:])
    mfu = flops / step_s / BF16_TENSOR_FLOPS
    log(f"  losses {[round(x, 5) for x in losses]}")
    log(f"  step seconds {[round(x, 4) for x in seconds]}; median of steps "
        f"1.. {step_s * 1e3:.1f} ms; MFU {mfu:.4f} = 3 x {EVO_BLOCKS} x "
        f"{flops / 3 / EVO_BLOCKS / 1e9:.1f} GFLOP (one block's forward "
        f"matrix products, evoformer_block_flops; backward counted 2x) / "
        f"step time / 989 TFLOP/s; N={n_params}; peak memory "
        f"{peak / 1e9:.2f} GB")

    out = {
        "losses": losses,
        "step_seconds": seconds,
        "step_ms_median": step_s * 1e3,
        "params": n_params,
        "flops_per_step": flops,
        "mfu": mfu,
        "peak_memory_bytes": peak,
        **profiled_step(step, step_s),
    }
    del blocks, opt, m, z, tm, tz
    torch.cuda.empty_cache()
    return launches, out


#: phase 10's second run: the same blocks with f32 attention (the JAX
#: module's precision), through the f32 instances of K3, K4 and K5; 4
#: blocks and 8 steps, as the bf16 run
EVO_F32_BLOCKS = 4
EVO_F32_STEPS = 8
EVO_F32_BLOCK_LAUNCHES = {"layer_norm_fwd": 12, "layer_norm_bwd": 12,
                          "flash_fwd_f32": 4, "flash_bwd_f32": 4,
                          "flash_dbias_f32": 3}


def phase10_f32():
    """``EVO_F32_BLOCKS`` full-width ``EvoformerBlock`` with f32 attention
    (``dtype=torch.float32``: q, k and v reach the kernels in f32, as the
    JAX module computes them) at the same crop, FusedAdam, ``EVO_F32_STEPS``
    steps, with the launch counters zeroed before and read after: K1, K2
    and the f32 instances of K3, K4 and K5 must have launched exactly
    ``EVO_F32_BLOCK_LAUNCHES`` x blocks x steps, every op on the kernel
    path; losses finite and falling; the median step time, then one
    profiled step by layer."""
    import torch

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.optimizers import FusedAdam

    log(f"phase 10: train {EVO_F32_BLOCKS} EvoformerBlock({EVO}) with f32 "
        f"attention at N_seq {EVO_SEQ}, N_res {EVO_RES}, {EVO_F32_STEPS} "
        f"FusedAdam steps")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(23)
    blocks = evoformer_stack(EVO_F32_BLOCKS, "cuda", gen, torch.float32)
    m, z, tm, tz = evoformer_data(EVO_SEQ, EVO_RES, "cuda", seed=24)
    opt = FusedAdam(blocks.parameters(), lr=EVO_LR)

    def step():
        loss = evoformer_loss(blocks, m, z, tm, tz)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    torch.cuda.synchronize()
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    losses, seconds = [], []
    for _ in range(EVO_F32_STEPS):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = _dispatch.launches()
    paths = _dispatch.last_paths()
    want = {k: n * EVO_F32_BLOCKS * EVO_F32_STEPS
            for k, n in EVO_F32_BLOCK_LAUNCHES.items()}
    log(f"  launches={launches} (per block and step "
        f"{EVO_F32_BLOCK_LAUNCHES}) paths={paths}")
    if launches != want:
        raise AssertionError(f"f32 evoformer launches {launches} != {want}")
    if paths != {"layer_norm": "cuda", "flash_attention": "cuda"}:
        raise AssertionError(f"f32 evoformer op paths {paths}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    step_s = statistics.median(seconds[1:])
    log(f"  losses {[round(x, 5) for x in losses]}; step seconds "
        f"{[round(x, 4) for x in seconds]}; median of steps 1.. "
        f"{step_s * 1e3:.1f} ms")
    out = {"losses": losses, "step_seconds": seconds,
           "step_ms_median": step_s * 1e3, "blocks": EVO_F32_BLOCKS,
           **profiled_step(step, step_s)}
    k5_ms = out["device_ms_by_layer"]["K5 flash_dbias_f32"]
    out["k5_f32_share_of_device"] = k5_ms / out["profiled_device_ms"]
    log(f"  K5 flash_dbias_f32: {k5_ms:.2f} ms of the profiled step's "
        f"{out['profiled_device_ms']:.1f} ms of kernels "
        f"({out['k5_f32_share_of_device']:.3f})")
    del blocks, opt, m, z, tm, tz
    torch.cuda.empty_cache()
    return launches, out


# ---------------------------------------------------------------------------
# phase 11: one evoformer training step, card bf16 against CPU f32
# ---------------------------------------------------------------------------


EVO_CROSS_RES, EVO_CROSS_SEQ = 64, 32
#: The phase-11 limits, one per reading of the card's step against the
#: CPU's.  Each sits between the card's sound reading and that of a
#: planted fault (``EVO_FAULTS``) which the phase runs each time as a CPU
#: f32 step against the sound CPU f32 step.
EVO_LIMITS = {
    # |loss(card bf16) - loss(CPU f32)|; the loss is ~4.4, where one f32
    # step is 4.8e-7
    "loss_diff": 2e-5,
    # the worst parameter's ||grad_card - grad_cpu|| / ||grad_cpu||
    "max_grad_rel_err": 5e-2,
    # the worst parameter's mean |update_card - update_cpu| after one
    # FusedAdam step.  Adam's first step moves each weight by about lr
    # whatever the gradient's scale, so this reading sees the optimizer
    # and not a gradient scaled by a constant: only the gradient limit
    # sees a halved dbias
    "max_mean_update_diff": 1e-5,
    # |grad EVO_ZERO_GRAD| / |grad EVO_BIAS_KERNELS[0]|, the larger side
    "zero_grad_norm_ratio": 1e-3,
}
#: each planted fault and the reading it must push past its limit
EVO_FAULTS = {
    "K3 twin's output x 0.99": "loss_diff",
    "K5 twin's dbias x 0.5": "max_grad_rel_err",
    "K5 twin's dbias without delta": "zero_grad_norm_ratio",
    "FusedAdam lr x 1.1": "max_mean_update_diff",
}
#: a parameter whose gradient is zero in exact arithmetic: MSA row
#: attention's ``ln_z`` feeds only the pair-bias projection, so its bias
#: adds one value per head to every score, which the softmax ignores.
#: Both runs read round-off there (an H100 read a relative difference of
#: 6.3e3 and Adam's first step turns round-off into ±lr), so it is held
#: to a bound on its norm instead (``zero_grad_norm_ratio``): a dbias
#: whose rows do not sum to zero, as without delta, moves it
EVO_ZERO_GRAD = "msa_row_att.ln_z_bias"
#: the parameters K5's gradient feeds
EVO_BIAS_KERNELS = ("msa_row_att.pair_bias.weight",
                    "pair_block.tri_att_start.tri_bias.weight",
                    "pair_block.tri_att_end.tri_bias.weight")


def evoformer_cross_step(device, fault=None):
    """One MSE + FusedAdam step of one full-width EvoformerBlock at N_res
    64, N_seq 32 on ``device`` ("cuda": bf16 attention; "cpu": f32), from
    weights drawn on the CPU (seed 31, zero-initialised parameters
    randomized) and seeded data.  ``fault`` names one of ``EVO_FAULTS``
    to plant (CPU only: it patches the twins or the learning rate).
    Returns (loss, {name: grad}, {name: update}) on the CPU in f32."""
    import torch

    from apex_tpu_torch.ops import attention as attn
    from apex_tpu_torch.optimizers import FusedAdam

    fwd, dbias = attn.flash_fwd_reference, attn.flash_dbias_reference

    def fwd_scaled(*a, **kw):
        o, *rest = fwd(*a, **kw)
        return (0.99 * o, *rest)

    def dbias_without_delta(q, k, v, do, m, l, delta, *a, **kw):
        return dbias(q, k, v, do, m, l, torch.zeros_like(delta), *a, **kw)

    planted = {
        "K3 twin's output x 0.99": ("flash_fwd_reference", fwd_scaled),
        "K5 twin's dbias x 0.5": (
            "flash_dbias_reference", lambda *a, **kw: 0.5 * dbias(*a, **kw)),
        "K5 twin's dbias without delta": ("flash_dbias_reference",
                                          dbias_without_delta),
    }
    lr = EVO_LR * (1.1 if fault == "FusedAdam lr x 1.1" else 1.0)

    cpu = evoformer_stack(1, "cpu", torch.Generator().manual_seed(31),
                          torch.float32)
    if device == "cpu":
        blocks = cpu
    else:
        blocks = evoformer_stack(1, device, torch.Generator().manual_seed(0),
                                 torch.bfloat16)
        blocks.load_state_dict({k: v.to(device)
                                for k, v in cpu.state_dict().items()})
    data = evoformer_data(EVO_CROSS_SEQ, EVO_CROSS_RES, device, seed=32)
    before = {k: p.detach().float().cpu().clone()
              for k, p in blocks.named_parameters()}
    opt = FusedAdam(blocks.parameters(), lr=lr)
    if fault in planted:
        setattr(attn, *planted[fault])
    try:
        loss = evoformer_loss(blocks, *data)
        loss.backward()
    finally:
        attn.flash_fwd_reference, attn.flash_dbias_reference = fwd, dbias
    grads = {k.removeprefix("0."): p.grad.detach().float().cpu()
             for k, p in blocks.named_parameters()}
    opt.step()
    updates = {k.removeprefix("0."): p.detach().float().cpu() - before[k]
               for k, p in blocks.named_parameters()}
    return float(loss.detach()), grads, updates


def evoformer_cross_readings(a, b):
    """The readings of step ``a`` against step ``b``, keyed as
    ``EVO_LIMITS``, plus the worst gradient's parameter and the bias
    kernels' relative gradient errors; ``EVO_ZERO_GRAD`` is left out of
    the gradient and update readings."""
    (la, ga, ua), (lb, gb, ub) = a, b
    keys = [k for k in gb if k != EVO_ZERO_GRAD]
    rel = {k: float((ga[k] - gb[k]).norm() / gb[k].norm().clamp_min(1e-30))
           for k in keys}
    rel = {k: r if np.isfinite(r) else float("inf") for k, r in rel.items()}
    worst = max(rel, key=rel.get)
    zero = max(float(g[EVO_ZERO_GRAD].norm()
                     / g[EVO_BIAS_KERNELS[0]].norm().clamp_min(1e-30))
               for g in (ga, gb))
    return {"loss_diff": abs(la - lb), "max_grad_rel_err": rel[worst],
            "max_mean_update_diff": max(float((ua[k] - ub[k]).abs().mean())
                                        for k in keys),
            "zero_grad_norm_ratio": zero, "worst_param": worst,
            "bias_kernel_grad_rel_err": {k: rel[k] for k in EVO_BIAS_KERNELS}}


def phase11():
    """One EvoformerBlock at full channel widths, N_res 64, N_seq 32: the
    loss, every gradient (the pair-bias and triangle-bias kernels, which
    K5 feeds, named) and the weights after one FusedAdam step on the card
    (bf16 attention, K1-K5) against the CPU (f32, the plain twins), from
    the same weights and data, within ``EVO_LIMITS``; then each planted
    fault of ``EVO_FAULTS`` on the CPU against the sound CPU step, which
    must push its reading past its limit."""
    log(f"phase 11: one full-width EvoformerBlock step at N_res "
        f"{EVO_CROSS_RES}, N_seq {EVO_CROSS_SEQ}, card bf16 against CPU f32")
    card = evoformer_cross_step("cuda")
    cpu = evoformer_cross_step("cpu")
    out = {"loss_card": card[0], "loss_cpu": cpu[0]}
    runs = [("card", card, None)] + [
        (f"planted {fault}", evoformer_cross_step("cpu", fault), key)
        for fault, key in EVO_FAULTS.items()]
    for tag, a, key in runs:
        r = evoformer_cross_readings(a, cpu)
        out[tag] = r
        outside = [k for k, lim in EVO_LIMITS.items() if not r[k] <= lim]
        log(f"  {tag} against CPU f32: loss {a[0]:.6f} vs {cpu[0]:.6f}; "
            + ", ".join(f"{k} {r[k]:.3e} (limit {lim:.0e})"
                        for k, lim in EVO_LIMITS.items())
            + f"; worst gradient {r['worst_param']}; bias kernels "
            + ", ".join(f"{k} {v:.3e}"
                        for k, v in r["bias_kernel_grad_rel_err"].items())
            + f"; outside: {outside or 'none'}")
        if key is None and outside:
            raise AssertionError("phase 11: the card's step disagrees")
        if key is not None and key not in outside:
            raise AssertionError(
                f"phase 11: the {key} limit passes the {tag}")
    return out


def ptxas_summary(text, nvcc):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name
    (demangled by the toolkit's ``cu++filt`` beside ``nvcc``), registers
    and spills."""
    import re

    rows, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (f", spills {m.group(1)}/{m.group(2)} bytes"
                     if m.group(1) != "0" or m.group(2) != "0" else "")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, m.group(1), spill))
            name = None
    names = [r[0] for r in rows]
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    if names and os.path.exists(filt):
        res = subprocess.run([filt, *names], capture_output=True, text=True)
        if res.returncode == 0 and len(res.stdout.splitlines()) == len(names):
            # "void ns::name<args>(parameters)" -> "ns::name<args>"
            names = [n.split(">(")[0].removeprefix("void ") + ">"
                     for n in res.stdout.splitlines()]
    return [f"{n}: {r} registers{sp}" for n, (_, r, sp) in zip(names, rows)]


def main():
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--f32-attention", action="store_true",
                        help="time only the f32 instances of K3-K5 and "
                        "phase 10's f32 run")
    parser.add_argument("--timing", action="store_true",
                        help="run phase 4 alone (the kernels' times)")
    parser.add_argument("--phase1", action="store_true",
                        help="run phase 1 alone (the kernels against their "
                        "plain versions)")
    parser.add_argument("--evoformer", action="store_true",
                        help="run phase 10's bf16 evoformer training alone "
                        "(launches logged, not checked)")
    args = parser.parse_args()

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
        for line in ptxas_summary(_build.build_log(name), _build._nvcc()):
            log(f"  [{name}] {line}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.f32_attention:
        flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
        rows = _time_f32_attention(gen, flush)
        for name, by_shape in rows.items():
            for tag, r in by_shape.items():
                log(f"  {name} ({tag}): kernel {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
        _, run = phase10_f32()
        print(json.dumps({"f32_attention": rows,
                          "evoformer_f32_attention": run}), flush=True)
        return
    if args.timing:
        print(json.dumps({"timing": phase4(gen, {}, {})}), flush=True)
        return
    if args.evoformer:
        launches, run = phase10(check_launches=False)
        print(json.dumps({"evoformer": dict(run, launches=launches)}),
              flush=True)
        return
    from apex_tpu_torch.ops import _dispatch

    errs = phase1(gen)
    errs.update(phase1_flash_dbias(gen))
    # phase 1's launches (phase 2 zeroes the counters): the entries no
    # main path launches must have launched here and passed their checks
    phase1_launches = _dispatch.launches()
    for name in PHASE1_ONLY_ENTRIES:
        n = phase1_launches.get(name, 0)
        log(f"  {name}: {n} phase-1 launches, {errs['k5_checks']} cases "
            f"within K5_TOL (no main path launches it)")
        if not n or not errs["k5_checks"]:
            raise AssertionError(f"phase 1 never held {name} to its twin")
        errs[f"{name}_phase1_launches"] = n
    if args.phase1:
        print(json.dumps({"phase1": errs}), flush=True)
        return
    serve_launches, rates, engine = phase2()
    cross = phase3()
    train_launches, training = phase6()
    train_cross = phase7()
    bert_launches, bert = phase8()
    bert_cross = phase9()
    evo_launches, evoformer = phase10()
    evo_f32_launches, evoformer_f32 = phase10_f32()
    evo_cross = phase11()
    runs = (("serving", serve_launches), ("training", train_launches),
            ("bert", bert_launches["bert"]),
            ("bert_dropout", bert_launches["bert_dropout"]),
            ("evoformer", evo_launches),
            ("evoformer_f32", evo_f32_launches))
    launches = {
        name: {path: counts[name] for path, counts in runs if name in counts}
        for name in KERNEL_ENTRIES
    }
    idle = [name for name in KERNEL_ENTRIES if not sum(launches[name].values())
            and name not in PHASE1_ONLY_ENTRIES]
    if idle:
        raise AssertionError(f"kernels the main paths never launched: {idle}")
    kernels = phase4(gen, launches, errs)
    profile = phase5(engine)
    log(json.dumps({"serving": rates, "cross_check": cross,
                    "training": training, "training_cross_check": train_cross,
                    "bert": bert, "bert_cross_check": bert_cross,
                    "evoformer": evoformer,
                    "evoformer_f32_attention": evoformer_f32,
                    "evoformer_cross_check": evo_cross,
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

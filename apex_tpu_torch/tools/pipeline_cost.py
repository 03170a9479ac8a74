"""Pipeline-schedule cost measurement.

Counterpart of ``tools/pipeline_cost.py``.  Measures, for pp in {2, 4}:

- wall time per full fwd+bwd step of the lockstep pipeline
  (``forward_backward_pipelining_without_interleaving``) with remat on
  (the default) and off,
- the same work under ``forward_backward_no_pipelining`` on one rank
  (the whole L-layer model, nm microbatches) — the scaling baseline,
- each rank's memory of the step,

and prints a table plus the derived efficiency vs the ideal-bubble
model.  The modes (the first argument) are the reference's: ``all``
(default), ``schedules``, ``lockstep``, ``interleaved``, ``frontier``,
``frontier-vpp`` and ``nm-sweep``.

Each pipeline runs on pp worker processes joined over gloo
(:mod:`apex_tpu_torch.tools._ranks`; the stages' shifts are
``comm.shift``), on the card (every rank on card 0) unless ``--device
cpu``; the one-rank baseline runs in the calling process.  A kept
divergence: the reference reads XLA's compile-time memory analysis
(temp + output bytes of the compiled step); here the memory column is
the step's own peak on the card — ``torch.cuda.max_memory_allocated``
over the timed step less ``memory_allocated`` before it, the largest
over the ranks — and NaN on the CPU, which keeps no such statistic.
The weights and inputs are drawn by ``torch.Generator``s (a stage's
weights seeded with its virtual stage index): the reference's
``jax.random`` draws are not reproduced, and the costs do not depend on
them.

Run::

    python -m apex_tpu_torch.tools.pipeline_cost [MODE] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys
import time

HIDDEN = 512
LAYERS = 8  # total; each pp stage runs LAYERS/pp of these
NM = 8
MB = 4  # microbatch rows
SEQ = 128
FRONTIER_HIDDEN = 256  # 1/4 the compute of HIDDEN=512; same memory SHAPE

#: the sizes a run reads (a caller may pass smaller ones)
DIMS = dict(hidden=HIDDEN, layers=LAYERS, nm=NM, mb=MB, seq=SEQ)


def make_stage_fn(n_layers):
    """n_layers of (dense 4H + gelu + dense H) — a transformer-MLP-shaped
    stage with enough FLOPs for timing to mean something.  ``params`` is
    a flat dict ``{"<i>/w1", "<i>/w2"}`` (stacked on a leading chunk
    axis under an interleaved schedule, which hands the stage one
    chunk's slices)."""
    import torch.nn.functional as F

    def stage_fn(params, x):
        for i in range(n_layers):
            w1, w2 = params[f"{i}/w1"], params[f"{i}/w2"]
            h = F.gelu(x @ w1, approximate="tanh")
            x = x + h @ w2
        return x

    return stage_fn


def make_params(seed, n_layers, hidden, device):
    """One stage's weights from a generator seeded with ``seed``: w1
    (H, 4H) and w2 (4H, H), N(0, 1/H)."""
    import torch

    gen = torch.Generator(device).manual_seed(int(seed))
    scale = 1.0 / (hidden ** 0.5)
    out = {}
    for i in range(n_layers):
        out[f"{i}/w1"] = torch.randn(hidden, 4 * hidden, generator=gen,
                                     device=device) * scale
        out[f"{i}/w2"] = torch.randn(4 * hidden, hidden, generator=gen,
                                     device=device) * scale
    return out


def loss_fn(y, t):
    import torch

    return torch.mean((y - t) ** 2)


def ideal_speedup(pp, nm, vpp=1):
    """The bubble-limited speedup of pipelining ``nm`` microbatches over
    ``pp`` stages (``vpp`` chunks a stage): ``pp * vpp * nm / (nm * vpp
    + pp - 1)`` (ticks = nm*vpp + pp - 1 of duration 1/vpp stage)."""
    return pp * vpp * nm / (nm * vpp + pp - 1)


def _inputs(nm, hidden, dims, device):
    import torch

    gen = torch.Generator(device).manual_seed(12345)
    shape = (nm, dims["mb"], dims["seq"], hidden)
    return (torch.randn(shape, generator=gen, device=device),
            torch.randn(shape, generator=gen, device=device))


def _measure(step, device, reps):
    """(best wall seconds of ``reps`` timed runs after one warm run,
    the step's own peak bytes on the card or NaN)."""
    import torch

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    step()  # warm (allocations, kernels' first use)
    sync()
    mem = float("nan")
    ts = []
    for i in range(reps):
        if device == "cuda" and i == 0:
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        step()
        sync()
        ts.append(time.perf_counter() - t0)
        if device == "cuda" and i == 0:
            mem = (torch.cuda.max_memory_allocated() - before) / 1e6
    return min(ts), mem


def _step(rank, *, schedule, pp, vpp, nm, hidden, remat_kw, dims, device,
          reps):
    """One timed step of ``schedule`` (a name in
    ``transformer.pipeline_parallel``) on this rank's stage(s) of a
    pp-stage pipeline (pp = 1: the whole model), in the parallel state
    the caller set up."""
    import torch

    from apex_tpu_torch.transformer import pipeline_parallel as pl

    n_chunks = vpp or 1
    if dims["layers"] % (pp * n_chunks):
        # a silent clamp would compare different model sizes across rows
        raise ValueError(
            f"LAYERS={dims['layers']} not divisible by "
            f"pp*vpp={pp * n_chunks}")
    per_chunk = dims["layers"] // (pp * n_chunks)
    stage = make_stage_fn(per_chunk)
    x, t = _inputs(nm, hidden, dims, device)
    if vpp:
        chunks = [make_params(rank + pp * k, per_chunk, hidden, device)
                  for k in range(vpp)]
        params = {k: torch.stack([c[k] for c in chunks]) for k in chunks[0]}
        extra = dict(num_model_chunks=vpp)
    else:
        params = make_params(rank, per_chunk, hidden, device)
        extra = {}
    fn = getattr(pl, schedule)

    def step():
        losses, grads = fn(stage, loss_fn, params, (x, t),
                           num_microbatches=nm, **extra, **remat_kw)
        return float(losses.sum()) + sum(
            float(g.abs().sum()) for g in grads.values())

    return _measure(step, device, reps)


def _rank_steps(rank, world, *, jobs, dims, device):
    """This rank's ``(wall s, mem MB)`` of each job, one after another
    in one process group (the ranks of a job run it together).  The
    pipeline's parallel state is set up once for all the jobs (they
    share one ``vpp``); one rank (the baseline, in the calling process)
    needs none, and the caller's own state, if any, is left as it is."""
    from apex_tpu_torch import parallel_state as ps

    (vpp,) = {job["vpp"] for job in jobs}
    if world > 1:
        ps.initialize_model_parallel(1, world, vpp)
    try:
        return [_step(rank, pp=world, dims=dims, device=device, **job)
                for job in jobs]
    finally:
        if world > 1:
            ps.destroy_model_parallel()


def _job(schedule, *, vpp=None, nm=None, hidden=None, dims, reps=3,
         **remat_kw):
    return dict(schedule=schedule, vpp=vpp, nm=nm or dims["nm"],
                hidden=hidden or dims["hidden"], remat_kw=remat_kw,
                reps=reps)


def _run_jobs(pp, jobs, *, device="cuda", dims=None):
    """``[(wall s, mem MB)]`` of ``jobs`` over ``pp`` ranks: the slowest
    rank's wall and the largest rank's memory.  pp = 1 runs in this
    process (no group: every axis has size 1)."""
    from apex_tpu_torch.tools._ranks import run_ranks

    dims = dict(DIMS if dims is None else dims)
    if pp == 1:
        return _rank_steps(0, 1, jobs=jobs, dims=dims, device=device)
    out = run_ranks(pp, _rank_steps,
                    dict(jobs=jobs, dims=dims, device=device),
                    device=device)
    rows = []
    for per_rank in zip(*out):
        mems = [m for _, m in per_rank]
        rows.append((max(w for w, _ in per_rank),
                     float("nan") if any(math.isnan(m) for m in mems)
                     else max(mems)))
    return rows


def _run(pp, schedule, *, device="cuda", dims=None, **kw):
    dims = dict(DIMS if dims is None else dims)
    return _run_jobs(pp, [_job(schedule, dims=dims, **kw)], device=device,
                     dims=dims)[0]


def run_no_pipelining(device="cuda", dims=None):
    """The whole L-layer model on one rank, nm microbatches, no remat."""
    return _run(1, "forward_backward_no_pipelining", device=device,
                dims=dims, remat=False)


def run_lockstep(pp, remat, device="cuda", dims=None):
    return _run(pp, "forward_backward_pipelining_without_interleaving",
                device=device, dims=dims, remat=remat)


def run_interleaved(pp, vpp, remat, nm=None, device="cuda", dims=None):
    return _run(pp, "forward_backward_pipelining_with_interleaving",
                vpp=vpp, nm=nm, device=device, dims=dims, remat=remat)


def run_lockstep_nm(pp, nm, remat=True, device="cuda", dims=None):
    """Lockstep memory at large grad-accumulation nm."""
    return _run(pp, "forward_backward_pipelining_without_interleaving",
                nm=nm, device=device, dims=dims, reps=1, remat=remat)[1]


def run_schedule(pp, nm, schedule, vpp=None, device="cuda", dims=None,
                 **kw):
    """Wall + memory for one schedule at (pp, nm) at FRONTIER_HIDDEN —
    the frontier measurement (one timed run)."""
    return _run(pp, schedule, vpp=vpp, nm=nm, hidden=FRONTIER_HIDDEN,
                device=device, dims=dims, reps=1, **kw)


FRONTIER_POINTS = [
    # (label, schedule, kwargs) — every bounded-memory point on offer
    ("lockstep remat",
     "forward_backward_pipelining_without_interleaving",
     dict(remat=True)),
    ("lockstep no-remat",
     "forward_backward_pipelining_without_interleaving",
     dict(remat=False)),
    ("lockstep carry_chunk",
     "forward_backward_pipelining_without_interleaving",
     dict(remat=True, carry_chunk="sqrt")),
    ("hand 1f1b residuals",
     "forward_backward_pipelining_1f1b",
     dict(stash="residuals")),
    ("hand 1f1b input",
     "forward_backward_pipelining_1f1b",
     dict(stash="input")),
]


VPP_FRONTIER_POINTS = [
    ("interleaved remat",
     "forward_backward_pipelining_with_interleaving",
     dict(remat=True)),
    ("interleaved carry_chunk",
     "forward_backward_pipelining_with_interleaving",
     dict(remat=True, carry_chunk="sqrt")),
    ("hand intlv residuals",
     "forward_backward_pipelining_interleaved_1f1b",
     dict(stash="residuals")),
    ("hand intlv input",
     "forward_backward_pipelining_interleaved_1f1b",
     dict(stash="input")),
]


def run_frontier_vpp(device="cuda", dims=None):
    """The virtual-stage frontier: (pp, vpp) in {(2,2), (2,4), (4,2)},
    nm in {32, 64}."""
    print(
        f"{'schedule':<26}{'pp':>4}{'vpp':>5}{'nm':>5}{'wall ms':>10}"
        f"{'mem MB':>9}",
        flush=True,
    )
    for pp, vpp in ((2, 2), (2, 4), (4, 2)):
        for nm in (32, 64):
            for label, schedule, kw in VPP_FRONTIER_POINTS:
                kw = dict(kw)
                if kw.get("carry_chunk") == "sqrt":
                    kw["carry_chunk"] = max(
                        2, int(round((nm * vpp + pp - 1) ** 0.5))
                    )
                try:
                    wall, mem = run_schedule(pp, nm, schedule, vpp=vpp,
                                             device=device, dims=dims, **kw)
                except Exception as e:
                    print(f"{label:<26}{pp:>4}{vpp:>5}{nm:>5}  FAILED: {e}")
                    continue
                print(
                    f"{label:<26}{pp:>4}{vpp:>5}{nm:>5}{wall*1e3:>10.1f}"
                    f"{mem:>9.1f}",
                    flush=True,
                )


def run_frontier(device="cuda", dims=None):
    """The memory/compute frontier at grad-accumulation scale: nm in
    {32, 64} x pp in {4, 8}, wall + memory for each schedule."""
    print(
        f"{'schedule':<24}{'pp':>4}{'nm':>5}{'wall ms':>10}{'mem MB':>9}",
        flush=True,
    )
    for pp in (4, 8):
        for nm in (32, 64):
            for label, schedule, kw in FRONTIER_POINTS:
                kw = dict(kw)
                if kw.get("carry_chunk") == "sqrt":
                    kw["carry_chunk"] = max(
                        2, int(round((nm + pp - 1) ** 0.5))
                    )
                try:
                    wall, mem = run_schedule(pp, nm, schedule,
                                             device=device, dims=dims, **kw)
                except Exception as e:
                    print(f"{label:<24}{pp:>4}{nm:>5}  FAILED: {e}")
                    continue
                print(
                    f"{label:<24}{pp:>4}{nm:>5}{wall*1e3:>10.1f}"
                    f"{mem:>9.1f}",
                    flush=True,
                )


HEADER = (
    f"{'schedule':<28}{'pp':>4}{'vpp':>4}{'remat':>7}{'wall ms':>10}"
    f"{'mem MB':>9}{'speedup':>9}{'ideal':>7}{'eff':>7}"
)


def lockstep_row(pp, remat, wall, mem, base_wall, nm=NM) -> dict:
    """One lockstep row of the table: its keys and its printed line."""
    speed = base_wall / wall
    ideal = ideal_speedup(pp, nm)
    row = dict(schedule="lockstep_1f1b", pp=pp, vpp=None, remat=remat,
               wall_ms=wall * 1e3, mem_mb=mem, speedup=speed, ideal=ideal,
               eff=speed / ideal)
    row["line"] = (
        f"{'lockstep_1f1b':<28}{pp:>4}{'-':>4}{str(remat):>7}"
        f"{wall*1e3:>10.1f}{mem:>9.1f}{speed:>9.2f}{ideal:>7.2f}"
        f"{speed/ideal:>7.2f}")
    return row


def interleaved_row(pp, vpp, remat, wall, mem, base_wall, nm=NM) -> dict:
    speed = base_wall / wall
    ideal = ideal_speedup(pp, nm, vpp)
    row = dict(schedule="interleaved", pp=pp, vpp=vpp, remat=remat,
               wall_ms=wall * 1e3, mem_mb=mem, speedup=speed, ideal=ideal,
               eff=speed / ideal)
    row["line"] = (
        f"{'interleaved':<28}{pp:>4}{vpp:>4}{str(remat):>7}"
        f"{wall*1e3:>10.1f}{mem:>9.1f}{speed:>9.2f}{ideal:>7.2f}"
        f"{speed/ideal:>7.2f}")
    return row


def baseline_line(base_wall, base_mem, dims=None) -> str:
    dims = DIMS if dims is None else dims
    return (f"no_pipelining  (1 rank, L={dims['layers']}, nm={dims['nm']}):"
            f"  wall={base_wall*1e3:8.1f} ms  mem={base_mem:8.1f} MB")


def schedules_table(mode="schedules", *, pps=(2, 4), vpp_grid=((2, 2),
                    (2, 4), (4, 2)), device="cuda", dims=None) -> list:
    """The baseline line, the header and the lockstep and/or interleaved
    rows of ``mode`` (printed as they come); returns the rows."""
    dims = dict(DIMS if dims is None else dims)
    base_wall, base_mem = run_no_pipelining(device, dims)
    print(baseline_line(base_wall, base_mem, dims), flush=True)
    print(HEADER, flush=True)
    rows = []
    if mode in ("all", "schedules", "lockstep"):
        for pp in pps:
            # both remat settings of one pp on one group of ranks
            got = _run_jobs(pp, [
                _job("forward_backward_pipelining_without_interleaving",
                     dims=dims, remat=remat) for remat in (True, False)],
                device=device, dims=dims)
            for remat, (wall, mem) in zip((True, False), got):
                rows.append(lockstep_row(pp, remat, wall, mem, base_wall,
                                         dims["nm"]))
                print(rows[-1]["line"], flush=True)
    if mode in ("all", "schedules", "interleaved"):
        for pp, vpp in vpp_grid:
            for remat in (True, False):
                wall, mem = run_interleaved(pp, vpp, remat, device=device,
                                            dims=dims)
                rows.append(interleaved_row(pp, vpp, remat, wall, mem,
                                            base_wall, dims["nm"]))
                print(rows[-1]["line"], flush=True)
    return rows


MODES = ("all", "schedules", "lockstep", "interleaved", "frontier",
         "frontier-vpp", "nm-sweep")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="all", choices=MODES)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    from apex_tpu_torch.ops._dispatch import resolve_device

    device = resolve_device(args.device).type
    mode = args.mode

    if mode in ("all", "schedules", "lockstep", "interleaved"):
        schedules_table(mode, device=device)

    if mode in ("all", "frontier"):
        print()
        print("memory/compute frontier at grad-accumulation scale:",
              flush=True)
        run_frontier(device)

    if mode in ("all", "frontier-vpp"):
        print()
        print("virtual-stage (interleaved) frontier:", flush=True)
        run_frontier_vpp(device)

    if mode in ("all", "nm-sweep"):
        print()
        print("lockstep memory vs num_microbatches (remat=True):", flush=True)
        print(f"{'pp':>4}{'nm':>6}{'mem MB':>10}{'mem/nm MB':>12}", flush=True)
        for pp in (2, 4):
            for nm in (8, 16, 32, 64):
                mem = run_lockstep_nm(pp, nm, device=device)
                print(f"{pp:>4}{nm:>6}{mem:>10.1f}{mem/nm:>12.2f}", flush=True)


if __name__ == "__main__":
    sys.exit(main())

"""Collective structure of the multi-device BASELINE configs (#2, #5).

Counterpart of ``tools/comm_structure.py``, with its configs, its JSON
keys and its functions under their names.  The reference compiles each
config's step on an 8-device CPU mesh and reads the collectives out of
the optimized HLO; the port runs each step for real, once, on ``world``
ranks (:func:`apex_tpu_torch.tools._ranks.run_ranks`: processes forked
from a server with ``torch`` preloaded, NCCL where every rank has a card
of its own and gloo otherwise — so on a one-card host gloo, every rank
sharing the card), records the step
(:func:`apex_tpu_torch.analysis.passes.capture`) and reads the
collectives from the record (:func:`apex_tpu_torch.analysis.hlo.
collective_summary`: the call log of :mod:`apex_tpu_torch.parallel.comm`,
per kind ``{count, bytes}``, bytes of each call's result as XLA prints
them: the full buffer of an all-gather, the shard of a reduce-scatter).

From the bytes and a link model this gives the reference's analytic comm
fraction.  The model's defaults are the H100 SXM's: NVLink 4 at 450 GB/s
a direction (a ring streams over one direction of each link), and 989
TFLOP/s of dense bf16 — both overridable (``--ici-gbps``, the
reference's flag and key, and ``--peak-tflops``).  One card cannot time
the steps across cards, so these fractions are modelled, not measured.

The configs:

- ``tp_gpt_block`` / ``tp_gpt_block_h4096``: one ``GptBlock`` at tp =
  world with sequence parallelism, its loss's backward, the
  sequence-parallel gradients' all-reduce and a FusedAdam update (h 1024
  and h 4096, seq 1024, batch 8, bf16);
- ``ddp_resnet50_syncbn`` / ``..._int8wire``: ResNet-50 with
  SyncBatchNorm at dp = world (64 x 64 images, 2 a rank), its gradients
  synced by ``all_reduce_gradients`` (f32, one all-reduce a tensor) or by
  ``quantized_all_reduce_gradients`` (the int8 wire), and FusedSGD;
- ``cp_ring_causal_balance``: the causal ring's balance model (pure
  Python, the reference's) and a wall A/B of ring attention, contiguous
  against zigzag, at cp 2.

The reference's ``overlap`` section reads the compiled schedule's async
start/done pairs.  The port's collectives are synchronous calls (the
call log holds no start/wait handles on these paths: each returns when
its result is ready), so nothing can be said to overlap: ``overlap`` is
null, and the ``_nonoverlapped`` / ``_overlap_aware`` fields equal their
serial counterparts.

Rows go to ``build/COMM_STRUCTURE_torch.json`` (``--out``), one JSON
line each, never to the root's ``COMM_STRUCTURE_r{N}.json``: the
reference's ``--round N``, which numbers that file, is dropped::

    python -m apex_tpu_torch.tools.comm_structure [--world 8] \
        [--config tp_gpt_block --config ddp_resnet50_syncbn] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "COMM_STRUCTURE_torch.json")

#: NVLink 4 on an H100 SXM, one direction (GB/s), and its dense bf16
#: peak (TFLOP/s): the analytic model's defaults
NVLINK_GBPS = 450.0
PEAK_TFLOPS = 989.0


def ring_traffic_bytes(kinds: dict, world: int) -> float:
    """Per-chip ICI traffic (bytes sent) under ring algorithms."""
    t = 0.0
    for kind, rec in kinds.items():
        b = rec["bytes"]
        if kind == "all-reduce":
            t += 2.0 * b * (world - 1) / world
        elif kind in ("all-gather", "reduce-scatter"):
            # operand is the local shard for AG / full buffer for RS; the
            # shapes recorded are op RESULTS for AG (full) and shards for
            # RS in XLA's notation — both stream (world-1)/world of the
            # full buffer; b is whichever the HLO printed, so this is a
            # lower bound for RS and exact for AG results.
            t += b * (world - 1) / world
        elif kind == "collective-permute":
            t += b  # one hop
        elif kind == "all-to-all":
            t += b * (world - 1) / world
    return t


def emit(rec, fh):
    line = json.dumps(rec)
    print(line, flush=True)
    fh.write(line + "\n")


# ---------------------------------------------------------------------------
# the rank bodies (module level: run_ranks pickles them by reference)
# ---------------------------------------------------------------------------


def _device(device: str):
    import torch

    return torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fold_updates(loss, updates):
    """The loss plus every update leaf's sum (the reference folds them
    into its output so the optimizer's graph survives DCE)."""
    out = loss.detach().float()
    for u in updates.values():
        out = out + u.float().sum()
    return out


def _record(step, dev):
    """One run of ``step()`` under the recorder: ``(result, per-kind
    summary, calls by scope)``; the last holds each collective's call
    record (kind, axis, dtype, bytes) under its innermost scope."""
    from apex_tpu_torch.analysis import hlo, passes

    result, record = passes.capture(step)
    _sync(dev)
    scoped: dict = {}
    for op in record.ops:
        if op.kind == "collective":
            scoped.setdefault(op.scope.rsplit("/", 1)[-1] or "<step>",
                              []).append(dict(op.meta))
    return result, hlo.collective_summary(record), scoped


def _tp_gpt_rank(rank, world, hidden, heads, inter, seq, batch, device,
                 dtype="bfloat16"):
    import torch

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.models.gpt import GptBlock, GptConfig, rope_cos_sin
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.transformer.tensor_parallel.mappings import (
        allreduce_sequence_parallel_gradients,
    )

    dev = _device(device)
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(tensor_model_parallel_size=world)
    try:
        torch.manual_seed(1)
        cfg = GptConfig(hidden_size=hidden, num_heads=heads,
                        intermediate_size=inter, sequence_parallel=True,
                        dtype=getattr(torch, dtype))
        block = GptBlock(cfg, device=dev)
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(seq, batch, hidden, generator=gen).to(cfg.dtype)
        xl = x[rank * (seq // world):(rank + 1) * (seq // world)].to(dev)
        cos, sin = rope_cos_sin(seq, cfg.head_dim, device=dev)
        tx = fused_adam(learning_rate=1e-4)
        params = dict(block.named_parameters())
        opt_state = tx.init({k: p.detach() for k, p in params.items()})

        def step():
            y = block(xl, cos, sin)
            loss = torch.sum(y.float() ** 2)
            loss.backward()
            allreduce_sequence_parallel_gradients(block)
            grads = {k: p.grad for k, p in params.items()}
            updates, _ = tx.update(grads, opt_state, {
                k: p.detach() for k, p in params.items()})
            return _fold_updates(loss, updates)

        _, kinds, _ = _record(step, dev)
    finally:
        ps.destroy_model_parallel()
    return kinds


def tp_sp_block_plan(world: int, hidden: int, seq: int, batch: int,
                     elem_bytes: int = 2) -> dict:
    """The collectives one sequence-parallel block step issues at tp =
    ``world``: per kind ``{count, bytes}``.  Forward, an all-gather of
    the (seq, batch, hidden) rows before each of the two column-parallel
    GEMMs and a reduce-scatter after each of the two row-parallel ones;
    backward, each mirrored (4 of each kind); then one all-reduce a
    sequence-parallel parameter (the two LayerNorms' weight and bias,
    and the two row-parallel biases: 6 x hidden f32)."""
    if world <= 1:
        return {}
    full = seq * batch * hidden * elem_bytes
    return {"all-gather": {"count": 4, "bytes": 4 * full},
            "reduce-scatter": {"count": 4, "bytes": 4 * full // world},
            "all-reduce": {"count": 6, "bytes": 6 * hidden * 4}}


def tp_gpt_structure(world: int, hidden=1024, heads=16, inter=4096,
                     seq=1024, batch=8, *, device="cuda",
                     dtype="bfloat16", backend: Optional[str] = None):
    """BASELINE #5: the GPT block train step at tp=world (+SP).

    The default (h=1024) shape is the bench.py #5 toy and is
    comm-DOMINATED by construction — its analytic fraction measures the
    shape, not the design.  main() also records a GPT-Large-class shape
    (h=4096) where compute/comm overlap is the actual question.  Returns
    ``(kinds, flops_chip, None)``: rank 0's summary (every rank's must be
    equal), the block's GEMM FLOPs a chip, and no HLO text."""
    kinds = _all_ranks(world, _tp_gpt_rank, dict(
        hidden=hidden, heads=heads, inter=inter, seq=seq, batch=batch,
        device=device, dtype=dtype), device, backend)
    # fwd+bwd GEMM FLOPs of the block per chip: qkv/out/mlp-in/mlp-out
    h, i = hidden, inter
    gemm = 2 * seq * batch * (h * 3 * h + h * h + h * i + i * h)
    flops_chip = 3 * gemm / world
    return kinds, flops_chip, None


def _ddp_rank(rank, world, quantized, batch, image, device, stage_sizes,
              width):
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.analysis.passes import named_scope
    from apex_tpu_torch.models.resnet import resnet50
    from apex_tpu_torch.optimizers import fused_sgd
    from apex_tpu_torch.parallel import (
        all_reduce_gradients,
        quantized_all_reduce_gradients,
    )
    from apex_tpu_torch.train import module_loss, module_params

    dev = _device(device)
    ps.destroy_model_parallel()
    ps.initialize_model_parallel()  # pure dp
    try:
        gen = torch.Generator().manual_seed(2)  # drawn on the host
        model = resnet50(device=dev, generator=gen, use_syncbn=True,
                         stage_sizes=tuple(stage_sizes), width=width)
        cpu = torch.Generator().manual_seed(0)
        x = torch.randn(world * batch, image, image, 3, generator=cpu)
        y = torch.randint(0, 1000, (world * batch,), generator=cpu)
        xl = x[rank * batch:(rank + 1) * batch].to(dev)
        yl = y[rank * batch:(rank + 1) * batch].to(dev)
        params = module_params(model)
        run = module_loss(model, lambda m, image: m(image, train=True))
        tx = fused_sgd(0.1, momentum=0.9)
        opt_state = tx.init(params)

        def step():
            leaves = {k: p.detach().requires_grad_(True)
                      for k, p in params.items()}
            logits, _ = run(leaves, xl)
            loss = F.cross_entropy(logits.float(), yl)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            with named_scope("grad_sync"):
                if quantized:
                    quantized_all_reduce_gradients(grads)
                else:
                    all_reduce_gradients(grads)
            updates, _ = tx.update(grads, opt_state, params)
            return _fold_updates(loss, updates)

        _, kinds, scoped = _record(step, dev)
        sizes = [p.numel() for p in params.values()]
    finally:
        ps.destroy_model_parallel()
    return {"kinds": kinds, "grad_sync": scoped.get("grad_sync", []),
            "sizes": sizes}


def ddp_plan(sizes, world: int, quantized: bool = False) -> list:
    """The port's declared plan of the gradient sync of
    :func:`ddp_syncbn_structure`'s step (``comm.sync_plan`` at the
    settings ``all_reduce_gradients`` / ``quantized_all_reduce_gradients``
    use)."""
    from apex_tpu_torch.parallel import comm

    if quantized:
        return comm.sync_plan(sizes, world, wire="int8", chunks=1,
                              block=256, min_size=1024)
    return comm.sync_plan(sizes, world, wire="f32", chunks=None,
                          min_size=1 << 62, extra_allreduce_bytes=0)


def ddp_sync_summary(sizes, world: int, quantized: bool = False) -> dict:
    """The exact per-kind ``{count, bytes}`` that plan stands for: f32,
    one all-reduce a gradient; int8, the gradients of >= 1024 elements in
    one bucket (an all-to-all and an all-gather of ``world`` int8
    payloads of the rank's shard, one chunk) and an f32 all-reduce for
    each smaller one."""
    from apex_tpu_torch.parallel import comm

    if world <= 1:
        return {}
    small = [s for s in sizes if not quantized or s < 1024]
    out = {}
    if quantized:
        n = sum(s for s in sizes if s >= 1024)
        shard = (n + (-n) % world) // world
        payload = world * comm.wire_payload_bytes(shard, "int8", 256)
        out["all-to-all"] = {"count": 1, "bytes": payload}
        out["all-gather"] = {"count": 1, "bytes": payload}
    if small:
        out["all-reduce"] = {"count": len(small), "bytes": 4 * sum(small)}
    return out


def check_ddp(details: dict, world: int, quantized: bool) -> list:
    """The problems of a recorded gradient sync (``details`` of
    :func:`ddp_syncbn_structure`) against the port's plan: the trainer's
    plan check (``reshard-plan`` findings) and the exact summary."""
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.train.trainer import check_plan

    sizes = details["sizes"]
    out = [f.render() for f in check_plan(
        details["grad_sync"], {"collectives": ddp_plan(sizes, world,
                                                       quantized)})]
    got = comm.collective_summary(details["grad_sync"])
    want = ddp_sync_summary(sizes, world, quantized)
    if got != want:
        out.append(f"gradient sync {got} != {want}")
    return out


def ddp_syncbn_structure(world: int, quantized: bool = False, *,
                         device="cuda", batch=2, image=64,
                         stage_sizes=(3, 4, 6, 3), width=64,
                         backend: Optional[str] = None, details=None):
    """BASELINE #2: ResNet-50 + DDP + SyncBatchNorm at dp=world.

    Small images (64x64): conv compute shrinks but the collective
    structure (grad all-reduces + per-BN statistic all-reduces) and grad
    BYTES are image-size-invariant.  ``quantized=True`` swaps the
    gradient sync for ``quantized_all_reduce_gradients`` (the int8 wire:
    an all-to-all and an all-gather of int8 payloads in place of the f32
    all-reduces; the SyncBN statistics stay f32).  ``details`` (a dict),
    when given, receives rank 0's gradient-sync summary and the
    gradients' sizes, for a check against :func:`ddp_plan`."""
    out = _all_ranks(world, _ddp_rank, dict(
        quantized=quantized, batch=batch, image=image, device=device,
        stage_sizes=list(stage_sizes), width=width), device, backend)
    if details is not None:
        details.update(grad_sync=out["grad_sync"], sizes=out["sizes"])
    return out["kinds"], None, None


def cp_ring_balance_model(cp: int):
    """Analytic per-rank causal ring work, contiguous vs zigzag.  Unit:
    one FULL attention block at zigzag granularity — a (S/2cp × S/2cp)
    q×k tile; a diagonal (self) tile is a triangle = 0.5.  Work(r, h)
    sums the tiles rank ``r`` computes at hop ``h`` (kv arrives from rank
    ``(r-h) mod cp``; causal-future tiles are SKIPPED by the ring, not
    masked).  The lockstep wall per hop is the MAX over ranks (the ring's
    shift resynchronizes every hop), so imbalance is pure idle time."""

    def tile(qc, kc):
        return 1.0 if qc > kc else (0.5 if qc == kc else 0.0)

    def work(chunks_of, r, h):
        j = (r - h) % cp
        return sum(
            tile(qc, kc)
            for qc in chunks_of(r) for kc in chunks_of(j)
        )

    layouts = {
        "contiguous": lambda r: (2 * r, 2 * r + 1),
        "zigzag": lambda r: (r, 2 * cp - 1 - r),
    }
    out = {}
    for name, chunks_of in layouts.items():
        per_hop_max = [
            max(work(chunks_of, r, h) for r in range(cp))
            for h in range(cp)
        ]
        total_useful = sum(
            work(chunks_of, r, h)
            for r in range(cp) for h in range(cp)
        )
        wall = sum(per_hop_max)
        out[name] = {
            "per_hop_max_tiles": per_hop_max,
            "lockstep_wall_tiles": wall,
            "useful_tiles_total": total_useful,
            "utilization": round(total_useful / (cp * wall), 4),
        }
    out["wall_ratio_contiguous_over_zigzag"] = round(
        out["contiguous"]["lockstep_wall_tiles"]
        / out["zigzag"]["lockstep_wall_tiles"], 4
    )
    return out


def _cp_wall_rank(rank, world, seq_local, heads, head_dim, batch, reps,
                  device):
    import torch

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.transformer.context_parallel import ring_attention

    dev = _device(device)
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(context_parallel_size=world)
    try:
        gen = torch.Generator().manual_seed(0)
        shape = (world, batch, heads, seq_local, head_dim)
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        q, k, v = (torch.randn(shape, generator=gen)[rank].to(dev, dtype)
                   for _ in range(3))
        walls = {}
        for layout in ("contiguous", "zigzag"):
            def run():
                o = ring_attention(q, k, v, causal=True, layout=layout)
                return float(o.float().sum())

            run()  # warm
            ts = []
            for _ in range(reps):
                torch.distributed.barrier()
                _sync(dev)
                t0 = time.perf_counter()
                run()
                ts.append(time.perf_counter() - t0)
            walls[layout] = round(min(ts) * 1e3, 2)
    finally:
        ps.destroy_model_parallel()
    return walls


def cp_ring_wall_ab(cp: int = 2, seq_local: int = 256, heads: int = 4,
                    head_dim: int = 64, batch: int = 2, reps: int = 3, *,
                    device="cuda", backend: Optional[str] = None):
    """Wall A/B: causal ring attention, contiguous vs zigzag layout, same
    global problem, on ``cp`` ranks (rank 0's host wall, ms, the best of
    ``reps``).  On one card the ranks share its SMs and the ring's shifts
    cross the host, so the walls measure the sum of the ranks' work —
    which the model above proves is equal across layouts; the 2−1/cp
    lockstep win is the per-hop MAX row of the model and needs a card a
    rank."""
    return _all_ranks(cp, _cp_wall_rank, dict(
        seq_local=seq_local, heads=heads, head_dim=head_dim, batch=batch,
        reps=reps, device=device), device, backend, same=False)


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------


def _backend(world: int, device: str) -> str:
    """NCCL where every rank has a card of its own, gloo otherwise."""
    if device == "cuda":
        import torch

        if torch.cuda.device_count() >= world:
            return "nccl"
    return "gloo"


def _all_ranks(world, fn, kwargs, device, backend=None, same=True):
    """Rank 0's result of ``fn`` on ``world`` ranks; with ``same`` every
    rank's must equal it."""
    from apex_tpu_torch.tools._ranks import run_ranks

    out = run_ranks(world, fn, kwargs, device=device,
                    backend=backend or _backend(world, device))
    if same and any(o != out[0] for o in out[1:]):
        raise AssertionError(f"{fn.__name__}: the ranks' collectives "
                             f"differ: {out}")
    return out[0]


#: name -> builder(world, device) of the reference's configs
CONFIGS = {
    "tp_gpt_block": lambda w, d: tp_gpt_structure(w, device=d),
    # GPT-Large-class shape: h=4096 puts the GEMMs where a real tp
    # deployment sits, so the analytic fraction is a design signal
    # rather than a toy-shape artifact
    "tp_gpt_block_h4096": lambda w, d: tp_gpt_structure(
        w, hidden=4096, heads=32, inter=16384, device=d),
    "ddp_resnet50_syncbn": lambda w, d: ddp_syncbn_structure(w, device=d),
    # same model/step with the int8-wire grad sync: the bytes delta vs the
    # row above is the quantization win, from the recorded step
    "ddp_resnet50_syncbn_int8wire": lambda w, d: ddp_syncbn_structure(
        w, quantized=True, device=d),
}


def config_record(name, kinds, flops_chip, world, ici_gbps, peak_tflops):
    """One config's row: the reference's keys and formulas; ``overlap``
    null (the port's collectives are synchronous calls)."""
    traffic = ring_traffic_bytes(kinds, world)
    comm_s = traffic / (ici_gbps * 1e9)
    rec = {
        "config": name,
        "world": world,
        "collectives": kinds,
        "per_chip_traffic_bytes": int(traffic),
        "ici_model_gbps": ici_gbps,
        "analytic_comm_ms": round(comm_s * 1e3, 4),
        "overlap": None,
        "analytic_comm_ms_nonoverlapped": round(comm_s * 1e3, 4),
    }
    if flops_chip:
        comp_s = flops_chip / (peak_tflops * 1e12)
        rec["per_chip_gemm_flops"] = int(flops_chip)
        rec["analytic_compute_ms_at_peak"] = round(comp_s * 1e3, 4)
        rec["analytic_comm_fraction"] = round(comm_s / (comm_s + comp_s), 4)
        rec["analytic_comm_fraction_overlap_aware"] = \
            rec["analytic_comm_fraction"]
    return rec


def balance_record(device: str, cp_models=(4, 8), wall_cp: int = 2):
    return {
        "config": "cp_ring_causal_balance",
        "model_unit": "one (S/2cp)^2 attention tile; diagonal = 0.5",
        "model": {str(cp): cp_ring_balance_model(cp) for cp in cp_models},
        "wall_ab_cp": wall_cp,
        "wall_ab_ms": cp_ring_wall_ab(cp=wall_cp, device=device),
        "wall_ab_note": (
            "ranks share one card and the ring's shifts cross the host: "
            "wall ~ SUM of the ranks' work (equal across layouts by the "
            "model); the 2-1/cp win is the lockstep per-hop MAX row and "
            "needs a card a rank"
        ),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=8)
    ap.add_argument("--ici-gbps", type=float, default=NVLINK_GBPS,
                    help="per-card link GB/s for one ring direction "
                    "(H100 SXM NVLink 4: 450)")
    ap.add_argument("--peak-tflops", type=float, default=PEAK_TFLOPS,
                    help="dense bf16 TFLOP/s (H100 SXM: 989)")
    ap.add_argument("--config", action="append", default=None,
                    choices=sorted(CONFIGS) + ["cp_ring_causal_balance"],
                    help="record this config (repeatable; default all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    ap.add_argument("--out", default=DEFAULT_OUT, metavar="FILE")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import multiprocessing as mp

    import torch

    from apex_tpu_torch.ops._dispatch import resolve_device

    device = resolve_device(args.device).type
    if device == "cuda":
        from apex_tpu_torch.ops import _build

        _build.build()  # once, here: the ranks load what it built
    mp.get_context("forkserver").set_forkserver_preload(["torch", "numpy"])
    names = args.config or [*CONFIGS, "cp_ring_causal_balance"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        for name in names:
            if name == "cp_ring_causal_balance":
                emit(balance_record(device), fh)
                continue
            kinds, flops_chip, _ = CONFIGS[name](args.world, device)
            emit(config_record(name, kinds, flops_chip, args.world,
                               args.ici_gbps, args.peak_tflops), fh)
    print(f"[comm_structure] wrote {args.out}"
          f" ({torch.cuda.get_device_name(0) if device == 'cuda' else 'cpu'})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

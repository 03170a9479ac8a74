"""Static analysis of the CUDA kernels' launch plans — lint and roofline.

Counterpart of ``apex_tpu/analysis/kernels.py``.  The graph passes see a
kernel as one opaque node; this module reads the kernels themselves, from
the :class:`~apex_tpu_torch.ops.introspect.KernelSpec` records the op
modules build with their launchers' own rules (``kernel_specs`` in
``ops/layer_norm.py``, ``ops/attention.py``, ``ops/paged_attention.py``).
Nothing is compiled or launched: a plan is judged in microseconds.  The
passes, under the reference's rule ids:

- **shared memory** (``kernel-vmem-overflow``): a CTA's dynamic (and
  known static) shared memory against the card's opt-in limit per CTA
  (:func:`apex_tpu_torch.observability.meter.smem_bytes_for`, 227 KB on
  the H100);
- **tile alignment** (``kernel-tile-misaligned``): a ``wgmma`` with M a
  multiple of 64, N a multiple of 8 up to 256 and K 16 (bf16) or 8
  (tf32); a TMA box of at most 256 rows whose inner extent is a multiple
  of 16 bytes;
- **grid coverage and race** (``kernel-grid-oob``, ``kernel-block-race``):
  a one-item-a-CTA grid has exactly one CTA per output tile (a
  persistent grid walks items ``c, c + grid, ...``, each once; a CTA past
  the last item is noted), and the launches of one call own disjoint
  outputs (K4's dK/dV and dQ passes write without atomics);
- **causal dead tiles** (``kernel-dead-tiles``): the share of a causal
  walk's live tiles spent on masked elements (the reference's rule);
- **the roofline** (:func:`roofline`): the bound of the call's work —
  the bytes each input read once and each output written once take at
  the HBM rate, or its operations at the peak of their unit, whichever
  is larger — the ``bound_ms`` that ``chip_smoke.py`` and ``PERF.md``
  report; and the operations the tiles execute (dead elements of live
  tiles included), as the reference counts them.

:func:`occupancy` predicts the CTAs an SM keeps from a plan, its
registers (``nvcc -Xptxas -v``) and the H100's per-SM limits;
``chip_smoke.py`` holds it, and the plans' shared memory, against the
card's own figures (``csrc/launch_query.cuh``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.analysis.findings import Report, make_finding
from apex_tpu_torch.ops.introspect import KernelSpec, specs_from_launch

__all__ = [
    "KERNEL_PASSES",
    "SM_LIMITS",
    "analyze",
    "analyze_default_kernels",
    "bound",
    "dead_tile_stats",
    "default_kernel_specs",
    "occupancy",
    "predict_config",
    "publish_kernel_report",
    "roofline",
    "specs_from_launch",
]

KERNEL_PASSES = (
    "kernel-vmem", "kernel-tiling", "kernel-coverage", "kernel-dead-tiles",
)

#: per-SM limits of the H100 (compute capability 9.0) the occupancy model
#: reads: registers, their allocation unit per warp, shared memory an SM
#: holds and reserves per CTA, threads, CTAs
SM_LIMITS = {
    "NVIDIA H100": dict(regs=65536, reg_unit=256, sub_partitions=4,
                        smem=233472, smem_reserved=1024, smem_unit=128,
                        threads=2048, ctas=32),
}


def _limits(device_kind: Optional[str]) -> dict:
    kind = device_kind or "NVIDIA H100"
    for key, val in SM_LIMITS.items():
        if kind.startswith(key):
            return val
    raise KeyError(f"no SM limits for device {kind!r}: add the card's "
                   "figures to SM_LIMITS")


# ---------------------------------------------------------------------------
# shared memory and occupancy
# ---------------------------------------------------------------------------


def occupancy(spec: KernelSpec, regs: int, static_smem: int = 0,
              device_kind: Optional[str] = None) -> int:
    """CTAs of ``spec``'s instance an SM keeps resident, from its threads,
    its ``regs`` registers a thread and its static and dynamic shared
    memory: the least of the register file (allocated per warp in units
    of 256, whole warps in each of the SM's four sub-partitions), the
    shared memory (with the 1 KB the card reserves per CTA, in 128-byte
    units), the threads and the CTAs an SM holds."""
    lim = _limits(device_kind)
    warps = -(-spec.threads // 32)
    per_warp = -(-max(regs, 1) * 32 // lim["reg_unit"]) * lim["reg_unit"]
    # each of the SM's sub-partitions holds whole warps' registers
    sp = lim["sub_partitions"]
    by_regs = (sp * ((lim["regs"] // sp) // per_warp)) // warps
    unit = lim["smem_unit"]
    smem = -(-(spec.smem_bytes + static_smem + lim["smem_reserved"])
             // unit) * unit
    by_smem = lim["smem"] // smem
    by_threads = lim["threads"] // (warps * 32)
    return int(max(0, min(by_regs, by_smem, by_threads, lim["ctas"])))


def _smem_pass(spec: KernelSpec, budget: int,
               static_smem: int = 0) -> list:
    total = spec.smem_bytes + static_smem
    if total <= budget:
        return []
    return [make_finding(
        "kernel-vmem-overflow", path=spec.full_name,
        message=(f"shared memory per CTA {total} bytes ({spec.smem_bytes} "
                 f"dynamic + {static_smem} static) exceeds the card's "
                 f"{budget}-byte opt-in limit: the launch fails"),
        hint="fewer ring stages or keys per stage in the launcher's tile")]


# ---------------------------------------------------------------------------
# tile alignment
# ---------------------------------------------------------------------------

_MMA_K = {"bfloat16": 16, "float16": 16, "tf32": 8}


def _tiling_pass(spec: KernelSpec) -> list:
    out = []
    mma = spec.mma or {}
    if mma.get("op") == "wgmma":
        m, n, k = mma["m"], mma["n"], mma["k"]
        want_k = _MMA_K.get(mma.get("dtype"), 16)
        bad = []
        if m % 64:
            bad.append(f"M={m} is not a multiple of 64")
        if n % 8 or not 8 <= n <= 256:
            bad.append(f"N={n} is not a multiple of 8 in [8, 256]")
        if k != want_k:
            bad.append(f"K={k} is not {want_k} for {mma.get('dtype')}")
        if bad:
            out.append(make_finding(
                "kernel-tile-misaligned", path=spec.full_name,
                message="wgmma shape: " + "; ".join(bad)))
    for rows, inner in spec.tma:
        if rows > 256 or rows < 1 or inner % 16 or inner > 256:
            out.append(make_finding(
                "kernel-tile-misaligned", path=spec.full_name,
                message=(f"TMA box of {rows} rows x {inner} bytes: at most "
                         "256 rows, an inner extent a multiple of 16 bytes "
                         "(at most the 128-byte swizzle's 256)")))
    return out


# ---------------------------------------------------------------------------
# grid coverage and race
# ---------------------------------------------------------------------------


def _coverage_pass(spec: KernelSpec) -> list:
    items = spec.items or {}
    n, grid = int(items.get("n_items", 0)), int(spec.grid)
    out = []
    if grid < 1:
        out.append(make_finding("kernel-grid-oob", path=spec.full_name,
                                message=f"empty grid ({grid} CTAs)"))
        return out
    if items.get("per_cta") == "one" and grid != n:
        out.append(make_finding(
            "kernel-grid-oob", path=spec.full_name,
            message=(f"{grid} CTAs for {n} items of one CTA each: "
                     + ("items left unwritten" if grid < n else
                        "CTAs past the last item"))))
    if items.get("per_cta") == "persistent" and n and grid > n:
        # item i goes to CTA i mod grid: every item once; a CTA past the
        # last item takes none, and only costs its launch
        out.append(make_finding(
            "kernel-grid-oob", path=spec.full_name, severity="info",
            message=f"{grid - n} of {grid} persistent CTAs take no item"))
    return out


def _call_race_pass(specs: Sequence[KernelSpec]) -> list:
    """The launches of one call own disjoint outputs."""
    out = []
    by_call: Dict[tuple, list] = {}
    for s in specs:
        by_call.setdefault((s.entry, id(s.work)), []).append(s)
    for group in by_call.values():
        seen: Dict[str, str] = {}
        for s in group:
            for w in s.writes:
                if w in seen and seen[w] != s.full_name:
                    out.append(make_finding(
                        "kernel-block-race", path=s.full_name,
                        message=(f"{w} is written by {seen[w]} and by this "
                                 "launch of the same call")))
                seen[w] = s.full_name
    return out


# ---------------------------------------------------------------------------
# causal dead tiles
# ---------------------------------------------------------------------------


def _block_live(i, j, bq, bk, offset, include_fully_masked):
    """The kernels' causal walk: tile (i, j) runs when its last row sees
    its first key, or (``include_fully_masked``) when its first row sees
    no key at all (S_q > S_k: those rows still produce their output) —
    ``csrc/flash_bwd.cu`` ``block_live``, the reference's
    ``_causal_block_live``."""
    live = (i * bq + bq - 1 + offset) >= (j * bk)
    if include_fully_masked:
        live = live | ((i * bq + offset) < 0)
    return live


def dead_tile_stats(spec: KernelSpec) -> Optional[Dict[str, float]]:
    """Live and dead tiles of a causal walk and the share of the live
    tiles' operations spent on masked elements (None when not causal),
    over one head as the reference counts them."""
    if not spec.causal or not spec.causal.get("causal", True):
        return None
    import numpy as np

    c = spec.causal
    bq, bk, offset = c["bq"], c["bk"], c["offset"]
    nq, nk = c["nq"], c["nk"]
    i = np.arange(nq)[:, None]
    j = np.arange(nk)[None, :]
    live = np.asarray(_block_live(i, j, bq, bk, offset,
                                  bool(c.get("include_fully_masked"))))
    live_tiles = int(live.sum())
    rows = np.arange(bq)[None, None, :]
    allowed = np.clip(
        i[:, :, None] * bq + rows + offset + 1 - (j * bk)[:, :, None],
        0, bk).sum(axis=-1)
    unmasked = float((allowed * live).sum())
    executed = float(live_tiles) * bq * bk
    waste = 0.0 if executed == 0 else max(0.0, 1.0 - unmasked / executed)
    return {
        "total_tiles": float(nq * nk),
        "live_tiles": float(live_tiles),
        "dead_tiles": float(nq * nk - live_tiles),
        "waste_fraction": waste,
    }


def _dead_tile_pass(spec: KernelSpec, threshold: float):
    stats = dead_tile_stats(spec)
    if stats is None or stats["waste_fraction"] <= threshold:
        return [], stats
    return [make_finding(
        "kernel-dead-tiles", path=spec.full_name,
        message=(f"{stats['waste_fraction']:.0%} of the live tiles' "
                 "operations fall on causally masked elements "
                 f"({int(stats['live_tiles'])}/{int(stats['total_tiles'])} "
                 f"tiles live) — above the {threshold:.0%} bound"))], stats


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------


def _peaks(device_kind: Optional[str]) -> dict:
    from apex_tpu_torch.observability import meter

    kind = device_kind or "NVIDIA H100"
    return {"bytes": meter.peak_hbm_bandwidth_for(kind),
            "bf16_tensor": meter.peak_flops_for(kind),
            "tf32_tensor": meter.peak_tf32_flops_for(kind),
            "f32": meter.peak_f32_flops_for(kind)}


def bound(bytes_moved: float, ops: float, peak: str,
          device_kind: Optional[str] = None) -> Tuple[float, str]:
    """``(bound_ms, "bytes" | "operations")``: the larger of the bytes at
    the HBM rate and the operations at ``peak``'s rate ("bf16_tensor",
    "tf32_tensor", "f32")."""
    p = _peaks(device_kind)
    t_bytes = bytes_moved / p["bytes"] * 1e3
    t_ops = ops / p[peak] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def _executed_flops(spec: KernelSpec) -> float:
    """The operations the tiles execute: ``flops_per_cell`` per live tile
    and head (every tile when not causal)."""
    c = spec.causal
    if not c:
        return 0.0
    stats = dead_tile_stats(spec)
    tiles = stats["live_tiles"] if stats is not None else c["nq"] * c["nk"]
    return spec.flops_per_cell * tiles * c["heads"]


def roofline(spec: KernelSpec, device_kind: Optional[str] = None) -> dict:
    """The call's bound and intensity: ``bytes`` and ``ops`` (its work,
    each input read once and each output written once, the useful
    operations), ``bound_ms``/``bound_by`` (:func:`bound`),
    ``arithmetic_intensity``, and ``flops`` — the operations the tiles
    execute, the masked elements of live tiles included (the
    reference's ``roofline`` flops)."""
    w = spec.work
    ms, by = bound(w["bytes"], w["ops"], w["peak"], device_kind)
    return {
        "bytes": float(w["bytes"]),
        "ops": float(w["ops"]),
        "peak": w["peak"],
        "bound_ms": ms,
        "bound_by": by,
        "arithmetic_intensity": (w["ops"] / w["bytes"]) if w["bytes"]
        else float("inf"),
        "flops": _executed_flops(spec),
        "grid_cells": float(spec.grid),
    }


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


def analyze(specs, *, device_kind: Optional[str] = None,
            smem_budget: Optional[int] = None,
            dead_tile_threshold: float = 0.25,
            static_smem: Optional[Dict[str, int]] = None,
            name: str = "") -> Report:
    """Every kernel pass over one spec (or a call's list) into a
    :class:`~apex_tpu_torch.analysis.findings.Report` whose
    ``sections["kernels"]`` holds each launch's plan, shared memory,
    dead-tile accounting and roofline.  ``static_smem`` maps an
    instance's full name to its static shared memory, when known."""
    from apex_tpu_torch.observability import meter

    if isinstance(specs, KernelSpec):
        specs = [specs]
    specs = list(specs)
    budget = smem_budget if smem_budget is not None else \
        meter.smem_bytes_for(device_kind or "NVIDIA H100")
    static_smem = static_smem or {}
    report = Report(target=name or "+".join(s.full_name for s in specs),
                    rules_run=KERNEL_PASSES)
    timings = {p: 0.0 for p in KERNEL_PASSES}
    section = []
    for spec in specs:
        for pass_name, fn in (
                ("kernel-vmem", lambda s: _smem_pass(
                    s, budget, static_smem.get(s.full_name, 0))),
                ("kernel-tiling", _tiling_pass),
                ("kernel-coverage", _coverage_pass)):
            t0 = time.perf_counter()
            report.extend(fn(spec))
            timings[pass_name] += (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        found, stats = _dead_tile_pass(spec, dead_tile_threshold)
        report.extend(found)
        timings["kernel-dead-tiles"] += (time.perf_counter() - t0) * 1e3
        entry = {"name": spec.full_name, "entry": spec.entry,
                 "grid": spec.grid, "threads": spec.threads,
                 "smem_bytes": spec.smem_bytes, "smem_budget_bytes": budget,
                 "roofline": roofline(spec, device_kind)}
        if stats is not None:
            entry["dead_tiles"] = stats
        section.append(entry)
    t0 = time.perf_counter()
    report.extend(_call_race_pass(specs))
    timings["kernel-coverage"] += (time.perf_counter() - t0) * 1e3
    report.pass_timings.update(timings)
    report.sections["kernels"] = section
    return report


def predict_config(specs: Sequence[KernelSpec], *,
                   device_kind: Optional[str] = None,
                   smem_budget: Optional[int] = None) -> Dict[str, object]:
    """One candidate launch plan's verdict for a tuner, as the
    reference's: ``feasible`` (no ERROR finding from the passes),
    ``time_s`` and ``flops`` summed over the call's launches (a call runs
    them back to back; the time is each launch's ``bound_ms``),
    ``tflops`` and the report itself."""
    report = analyze(specs, device_kind=device_kind, smem_budget=smem_budget)
    time_s = flops = 0.0
    for entry in report.sections["kernels"]:
        time_s += entry["roofline"]["bound_ms"] / 1e3
        flops += entry["roofline"]["ops"]
    return {
        "feasible": not report.errors(),
        "time_s": time_s,
        "flops": flops,
        "tflops": (flops / time_s / 1e12) if time_s else 0.0,
        "report": report,
    }


def publish_kernel_report(report: Report) -> None:
    """Gauge a kernel report onto the observability board
    (``analysis/kernels/...``) beside the graph lint's counts: the
    errors, warnings and rule counters of
    :func:`apex_tpu_torch.analysis.publish_report`, and per launch its
    shared memory (``smem_bytes``, the reference's ``vmem_bytes``), the
    TFLOP/s its bound allows (``predicted_tflops``) and, for a causal
    walk, the dead-tile waste."""
    from apex_tpu_torch.analysis import publish_report
    from apex_tpu_torch.observability.metrics import board

    publish_report(report, prefix="analysis/kernels")
    for entry in report.sections.get("kernels", []):
        key = entry["name"]
        roof = entry["roofline"]
        board.set(f"analysis/kernels/{key}/smem_bytes", entry["smem_bytes"])
        tflops = (roof["ops"] / (roof["bound_ms"] / 1e3) / 1e12
                  if roof["bound_ms"] else 0.0)
        board.set(f"analysis/kernels/{key}/predicted_tflops",
                  round(tflops, 3))
        if "dead_tiles" in entry:
            board.set(f"analysis/kernels/{key}/dead_tile_waste",
                      round(entry["dead_tiles"]["waste_fraction"], 4))


def default_kernel_specs() -> List[Tuple[str, List[KernelSpec]]]:
    """``(label, specs)`` of every kernel at the main paths' shapes
    (``chip_smoke.py`` phase 4's rows): K3/K4 at GPT's training shape and
    at BERT's (padding bias, dropout), the fused K4 + K5 and K5 at the
    triangle shape, the f32 instances at the MSA row shape, K1/K2 at
    GPT's rows, K6 at the decode batch on bf16 and int8 pages."""
    import torch

    from apex_tpu_torch.ops import attention as attn
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import paged_attention as pa

    lengths = [0, 1, 17, 2048, 100, 555, 1024, 2047]
    return [
        ("flash_attention/gpt", attn.kernel_specs(128, 2048, 2048, 64,
                                                  defines=())),
        ("flash_attention/bert", attn.kernel_specs(
            2048, 128, 128, 64, causal=False, bias_shape=(128, 1),
            dropout=True, defines=())),
        ("flash_attention/triangle", attn.kernel_specs(
            1024, 256, 256, 32, causal=False, bias_shape=(1024, 256),
            modes=("fwd", "bwd", "dbias"), dbias=True, defines=())),
        ("flash_attention/msa_row_f32", attn.kernel_specs(
            512, 256, 256, 64, dtype=torch.float32, causal=False,
            bias_shape=(512, 256), modes=("fwd", "bwd", "dbias"))),
        ("layer_norm", ln.kernel_specs(16384, 1024)
         + ln.kernel_specs(16384, 1024, bwd=True)),
        ("paged_decode", pa.kernel_specs(8, 16, 64, page=16, np_=128,
                                         lengths=lengths)
         + pa.kernel_specs(8, 16, 64, page=16, np_=128,
                           kv_dtype=torch.int8, lengths=lengths)),
    ]


def analyze_default_kernels(*, device_kind: Optional[str] = None,
                            smem_budget: Optional[int] = None,
                            dead_tile_threshold: float = 0.25) -> Report:
    """:func:`analyze` over :func:`default_kernel_specs` into one report
    (``tools/kernel_lint.py``)."""
    merged: Optional[Report] = None
    section = []
    for label, specs in default_kernel_specs():
        rep = analyze(specs, device_kind=device_kind, smem_budget=smem_budget,
                      dead_tile_threshold=dead_tile_threshold, name=label)
        section += [{"config": label, **e} for e in rep.sections["kernels"]]
        merged = rep if merged is None else merged.merge(rep)
    merged.target = "kernels"
    merged.sections["kernels"] = section
    return merged

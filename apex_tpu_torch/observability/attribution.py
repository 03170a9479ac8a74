"""Step-time attribution — where a training step spends its time,
decomposed into compute / collective / host-stall fractions and
per-op-category buckets, from two sources that must agree.

Counterpart of ``apex_tpu/observability/attribution.py``.

1. **The cost model** (:func:`attribute_cost_model`): every node of a
   recorded step (:func:`apex_tpu_torch.analysis.passes.capture`'s
   :class:`~apex_tpu_torch.analysis.passes.StepRecord`: aten ops, each
   kernel launch as one node, each collective), costed by the shape
   arithmetic of :mod:`apex_tpu_torch.analysis.hlo` and bucketed by
   :func:`~apex_tpu_torch.observability.meter.categorize_op` into matmul /
   attention / norm-elementwise / collective / other.  It knows FLOPs and
   bytes and estimates time (a two-resource roofline a node); it cannot
   see the host, so its host-stall fraction is always 0.

2. **A measured profiler trace** (:func:`attribute_trace`): the Chrome
   trace a :class:`~apex_tpu_torch.observability.trace.TraceScheduler`
   window writes (``torch.profiler``, kineto's event categories).  Device
   time is the complete events of category ``kernel``, ``gpu_memcpy`` and
   ``gpu_memset``; events are selected by category, not by process
   names.  A collective is an NCCL kernel, or a copy launched inside a
   ``c10d``/gloo host span (gloo stages through the host).  Every other
   kernel is bucketed through the one kernel-name table
   :data:`KERNEL_GROUPS` (the port's kernels and cuBLAS) and then
   :func:`categorize_op`.  ``stall_ms`` is the span less the merged
   coverage of device events: the time no kernel explains.  A trace with
   no device events (a CPU run) is attributed from its top-level
   ``cpu_op`` events instead (source ``"host-ops"``).

A CUDA-graph replay is one ``cudaGraphLaunch`` runtime call;
:class:`TraceAttribution` counts those calls and the device events that
correlate with them, so a trace whose replays do not expand into kernel
events says so (``graph_launches`` > 0 with ``graph_kernel_events`` 0)
instead of inventing per-kernel times.

:func:`roofline_report` turns the merged view into a per-bucket roofline
on the meter's H100 peaks, and :func:`publish_attribution` lands the
fractions on the board, where
:class:`~apex_tpu_torch.observability.health.CollectiveFractionRule` and
:class:`~apex_tpu_torch.observability.health.HostStallRule` watch them.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

from apex_tpu_torch.observability.meter import (
    BUCKETS,
    categorize_op,
    peak_flops_for,
    peak_hbm_bandwidth_for,
    peak_ici_bandwidth_for,
)

__all__ = [
    "OpCost",
    "CostAttribution",
    "TraceAttribution",
    "RooflineRow",
    "KERNEL_GROUPS",
    "kernel_layer",
    "group_kernels",
    "attribute_cost_model",
    "attribute_trace",
    "attribute_trace_dir",
    "load_trace_dir",
    "device_events",
    "trace_step_period",
    "hlo_bucket_map",
    "roofline_report",
    "render_roofline",
    "publish_attribution",
]

#: top-level fraction keys — always sum to 1.0 (compute aggregates the
#: non-collective busy buckets)
FRACTION_KEYS = ("compute", "collective", "host_stall")

#: the one kernel-name table: (layer, name fragments, bucket).  The first
#: layer whose fragment a CUDA kernel's name contains owns its time
#: (``chip_smoke.py``'s per-layer profiles and the attribution's buckets
#: both read it)
KERNEL_GROUPS = (
    ("K3 flash_fwd", ("flash_fwd_kernel", "flash_fwd_wide_kernel"),
     "attention"),
    ("K4 flash_bwd", ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                      "flash_bwd_dkdv_wide_kernel",
                      "flash_bwd_dq_wide_kernel"), "attention"),
    # the fused call's dQ pass with the dbias epilogue (its dK/dV pass
    # counts under K4)
    ("K4+K5 dQ pass with dbias", ("flash_bwd_dq_dbias_kernel",),
     "attention"),
    ("K5 flash_dbias", ("flash_dbias_kernel",), "attention"),
    ("K3 flash_fwd_f32", ("flash_fwd_f32_kernel",
                          "flash_fwd_f32_wide_kernel"), "attention"),
    ("K4 flash_bwd_f32", ("flash_bwd_dkdv_f32_kernel",
                          "flash_bwd_dq_f32_kernel",
                          "flash_bwd_dkdv_f32_wide_kernel",
                          "flash_bwd_dq_f32_wide_kernel"), "attention"),
    ("K5 flash_dbias_f32", ("flash_dbias_f32_kernel",), "attention"),
    ("K6 paged_decode", ("paged_decode_kernel",), "attention"),
    ("K1 layer_norm_fwd", ("ln_fwd_kernel",), "norm_elementwise"),
    ("K2 layer_norm_bwd", ("ln_bwd_kernel",), "norm_elementwise"),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "xmma", "cutlass"), "matmul"),
    ("optimizer (foreach)", ("multi_tensor_apply",), "norm_elementwise"),
)

#: the device event categories of a kineto trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: host spans inside which a copy is a collective's staging (gloo)
_COLLECTIVE_HOST_HINTS = ("c10d::", "gloo", "nccl:", "record_param_comms")


def kernel_layer(name: str) -> Optional[Tuple[str, str]]:
    """``(layer, bucket)`` of a CUDA kernel name by :data:`KERNEL_GROUPS`,
    or None."""
    for layer, frags, bucket in KERNEL_GROUPS:
        if any(f in name for f in frags):
            return layer, bucket
    return None


def group_kernels(kernels) -> Dict[str, float]:
    """Device ms per layer of ``(name, device_us, count)`` rows: the
    layers of :data:`KERNEL_GROUPS`, then the rest (``"other"``:
    elementwise, copies, reductions)."""
    out = {layer: 0.0 for layer, _, _ in KERNEL_GROUPS}
    out["other"] = 0.0
    for key, us, _ in kernels:
        hit = kernel_layer(key)
        out[hit[0] if hit else "other"] += us / 1e3
    return out


class OpCost(NamedTuple):
    """One recorded node's modeled cost."""

    name: str
    opcode: str
    op_name: str
    bucket: str
    flops: float
    bytes: int


# ---------------------------------------------------------------------------
# source (a): the cost model over a recorded step
# ---------------------------------------------------------------------------


class CostAttribution:
    """Bucketed FLOPs/bytes/estimated time of recorded steps."""

    def __init__(self, ops: List[OpCost], peak_flops: float,
                 hbm_bw: float, ici_bw: float):
        self.ops = ops
        self.peak_flops = peak_flops
        self.hbm_bw = hbm_bw
        self.ici_bw = ici_bw
        self.buckets: Dict[str, Dict[str, float]] = {
            b: {"flops": 0.0, "bytes": 0.0, "est_time": 0.0}
            for b in BUCKETS
        }
        for op in ops:
            rec = self.buckets[op.bucket]
            rec["flops"] += op.flops
            rec["bytes"] += op.bytes
            if op.bucket == "collective":
                rec["est_time"] += op.bytes / ici_bw
            else:
                rec["est_time"] += max(
                    op.flops / peak_flops, op.bytes / hbm_bw
                )

    @property
    def total_flops(self) -> float:
        return sum(b["flops"] for b in self.buckets.values())

    @property
    def total_bytes(self) -> float:
        return sum(b["bytes"] for b in self.buckets.values())

    @property
    def est_step_time(self) -> float:
        """Roofline lower bound on the step (serial sum of per-node
        maxima — real schedules overlap, so achieved time >= this)."""
        return sum(b["est_time"] for b in self.buckets.values())

    def bucket_fractions(self) -> Dict[str, float]:
        """Each bucket's share of the estimated busy time."""
        total = self.est_step_time
        if total <= 0:
            return {b: 0.0 for b in BUCKETS}
        return {b: self.buckets[b]["est_time"] / total for b in BUCKETS}

    def fractions(self) -> Dict[str, float]:
        """compute/collective/host_stall (host_stall is always 0 here:
        the record cannot see the host)."""
        shares = self.bucket_fractions()
        coll = shares.get("collective", 0.0)
        return {
            "compute": 1.0 - coll if self.est_step_time > 0 else 0.0,
            "collective": coll,
            "host_stall": 0.0,
        }

    def bucket_map(self) -> Dict[str, str]:
        """Node name → bucket (the ``p<i>/`` prefixes of a multi-record
        model stripped)."""
        return {op.name.rsplit("/", 1)[-1]: op.bucket for op in self.ops}


#: attention kernels whose operations the record's scalars give:
#: (bh, sq, sk, d, groups, rows, scale, causal) lead their scalars, and
#: the forward runs two products of bh·sq·sk·d, the backward's recompute
#: five
_ATTENTION_PRODUCTS = {
    "flash_fwd": 2, "flash_fwd_f32": 2,
    "flash_bwd": 5, "flash_bwd_f32": 5, "flash_bwd_dbias": 5,
}


def _kernel_flops(instr: dict) -> float:
    """A kernel node's useful operations where its scalars give them
    (K3/K4); the other kernels (LayerNorm, the bias gradient, paged
    decode) are costed by their bytes."""
    products = _ATTENTION_PRODUCTS.get(instr.get("target", ""))
    scalars = instr.get("attrs", {}).get("scalars", ())
    if products is None or len(scalars) < 8:
        return 0.0
    bh, sq, sk, d = (int(v) for v in scalars[:4])
    causal = bool(scalars[7])
    work = 2.0 * products * bh * sq * sk * d
    return work / 2 if causal and sq == sk else work


def attribute_cost_model(
    records,
    *,
    device_kind: Optional[str] = None,
    peak_flops: Optional[float] = None,
    hbm_bw: Optional[float] = None,
    ici_bw: Optional[float] = None,
) -> CostAttribution:
    """Bucketed cost attribution of one or more recorded steps (pass
    every program a step runs — e.g. the gradient step and the update —
    and their costs merge into one step model).  Peaks default from the
    meter's tables for ``device_kind`` (default: this process's card)."""
    from apex_tpu_torch.analysis import hlo as H

    if not isinstance(records, (list, tuple)):
        records = [records]
    if device_kind is None:
        import torch

        device_kind = torch.cuda.get_device_name(0)
    peak_flops = peak_flops or peak_flops_for(device_kind)
    hbm_bw = hbm_bw or peak_hbm_bandwidth_for(device_kind)
    ici_bw = ici_bw or peak_ici_bandwidth_for(device_kind)

    ops: List[OpCost] = []
    for i, record in enumerate(records):
        comps, entry = H.parse_computations(record)
        prefix = f"p{i}/" if len(records) > 1 else ""
        for instr in comps[entry]:
            kind = instr["kind"]
            if kind == "collective":
                f, b = 0.0, int(instr["attrs"].get("bytes", 0))
                bucket = "collective"
            else:
                f = (_kernel_flops(instr) if kind == "kernel"
                     else H.instruction_flops(instr))
                b = H.instruction_bytes(instr)
                bucket = categorize_op(instr["opcode"], instr["op_name"])
                if kind == "kernel":
                    hit = kernel_layer(instr["target"] + "_kernel")
                    bucket = hit[1] if hit else bucket
            if f == 0.0 and b == 0:
                continue  # views and bookkeeping: invisible
            ops.append(OpCost(prefix + instr["name"], instr["opcode"],
                              instr["op_name"], bucket, f, b))
    return CostAttribution(ops, peak_flops, hbm_bw, ici_bw)


def hlo_bucket_map(records) -> Dict[str, str]:
    """Node name → bucket straight from recorded steps."""
    return attribute_cost_model(
        records, device_kind="", peak_flops=1.0, hbm_bw=1.0, ici_bw=1.0
    ).bucket_map()


# ---------------------------------------------------------------------------
# source (b): the measured profiler trace
# ---------------------------------------------------------------------------


class TraceAttribution:
    """Measured per-bucket time + host stall from a kineto trace.

    ``bucket_ms`` sums event durations per bucket (streams may overlap,
    so the sum can exceed wall coverage — fractions normalize by share,
    not by wall).  ``span_ms`` is first-event start to last-event end;
    ``stall_ms`` is the part of the span no event interval covers
    (merged-union gaps): launch latency, host syncs, input waits.
    ``layer_ms`` is the device time by :data:`KERNEL_GROUPS` layer.
    """

    def __init__(self, bucket_ms: Dict[str, float], span_ms: float,
                 covered_ms: float, events: int,
                 source: str = "device-ops", *,
                 layer_ms: Optional[Dict[str, float]] = None,
                 kernel_events: Optional[Dict[str, int]] = None,
                 graph_launches: int = 0, graph_kernel_events: int = 0):
        self.bucket_ms = {b: bucket_ms.get(b, 0.0) for b in BUCKETS}
        self.span_ms = span_ms
        self.covered_ms = min(covered_ms, span_ms) if span_ms > 0 else 0.0
        self.events = events
        self.source = source
        self.layer_ms = dict(layer_ms or {})
        #: device events by :data:`KERNEL_GROUPS` layer (counts)
        self.kernel_events = dict(kernel_events or {})
        #: ``cudaGraphLaunch`` calls, and the device events correlated
        #: with them (0 with launches > 0: the replays did not expand)
        self.graph_launches = graph_launches
        self.graph_kernel_events = graph_kernel_events

    @property
    def busy_ms(self) -> float:
        return sum(self.bucket_ms.values())

    @property
    def stall_ms(self) -> float:
        return max(0.0, self.span_ms - self.covered_ms)

    @property
    def compute_ms(self) -> float:
        """Busy time outside the collective bucket."""
        return self.busy_ms - self.bucket_ms["collective"]

    def bucket_fractions(self) -> Dict[str, float]:
        """Each bucket's share of measured busy time."""
        busy = self.busy_ms
        if busy <= 0:
            return {b: 0.0 for b in BUCKETS}
        return {b: t / busy for b, t in self.bucket_ms.items()}

    def fractions(self) -> Dict[str, float]:
        """compute / collective / host_stall, summing to 1.0: the stall
        share is measured from coverage gaps, and the busy remainder
        splits across buckets by their share of summed event time."""
        if self.span_ms <= 0:
            return {"compute": 0.0, "collective": 0.0, "host_stall": 0.0}
        stall = self.stall_ms / self.span_ms
        shares = self.bucket_fractions()
        coll = shares.get("collective", 0.0) * (1.0 - stall)
        return {
            "compute": max(0.0, 1.0 - stall - coll),
            "collective": coll,
            "host_stall": stall,
        }

    def bucket_time_fractions(self) -> Dict[str, float]:
        """Per-bucket share of the SPAN (busy shares scaled by
        1 − stall) — what the roofline uses to turn a measured step
        time into per-bucket seconds."""
        fr = self.fractions()
        busy_share = 1.0 - fr["host_stall"]
        return {
            b: s * busy_share for b, s in self.bucket_fractions().items()
        }

    def graph_note(self) -> Optional[str]:
        """What the trace says of CUDA-graph replays, or None without
        any."""
        if not self.graph_launches:
            return None
        if self.graph_kernel_events:
            return (f"{self.graph_launches} cudaGraphLaunch calls expanded "
                    f"into {self.graph_kernel_events} device events")
        return (f"{self.graph_launches} cudaGraphLaunch calls; their "
                "kernels are not in the trace (each replay is one launch)")


def _merged_coverage(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    total += cur_e - cur_s
    return total


def _complete(events) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("dur")]


def device_events(trace: Mapping) -> List[dict]:
    """The trace's device events: complete events of the categories
    ``kernel``, ``gpu_memcpy`` and ``gpu_memset``."""
    return [e for e in _complete(trace.get("traceEvents", []))
            if e.get("cat") in DEVICE_CATS]


def _top_level_host_ops(events: List[dict]) -> List[dict]:
    """``cpu_op`` events that no other ``cpu_op`` of their thread
    encloses (the ops a step called, not their internals)."""
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                 key=lambda e: (e.get("pid"), e.get("tid"),
                                float(e["ts"]), -float(e["dur"])))
    out: List[dict] = []
    end_by_thread: Dict[tuple, float] = {}
    for e in ops:
        key = (e.get("pid"), e.get("tid"))
        ts, te = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if ts < end_by_thread.get(key, float("-inf")):
            continue
        end_by_thread[key] = te
        out.append(e)
    return out


def _collective_copies(events: List[dict]) -> set:
    """Correlation ids of the copies launched inside a collective's host
    span (gloo staging a card tensor through the host)."""
    spans: Dict[tuple, List[Tuple[float, float]]] = {}
    for e in events:
        if e.get("cat") not in ("cpu_op", "user_annotation"):
            continue
        name = e.get("name", "").lower()
        if any(h in name for h in _COLLECTIVE_HOST_HINTS):
            spans.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    if not spans:
        return set()
    for ivs in spans.values():
        ivs.sort()
    out = set()
    for e in events:
        if e.get("cat") != "cuda_runtime" or "Memcpy" not in e.get("name", ""):
            continue
        ivs = spans.get((e.get("pid"), e.get("tid")))
        if not ivs:
            continue
        ts = float(e["ts"])
        i = bisect.bisect_right(ivs, (ts, float("inf"))) - 1
        if i >= 0 and ivs[i][0] <= ts <= ivs[i][1]:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                out.add(corr)
    return out


def _bucket_device_event(e: dict, staged: set) -> str:
    name = e.get("name", "")
    corr = (e.get("args") or {}).get("correlation")
    if corr is not None and corr in staged:
        return "collective"
    low = name.lower()
    if "nccl" in low:
        return "collective"
    if e.get("cat") == "kernel":
        hit = kernel_layer(name)
        if hit is not None:
            return hit[1]
    return categorize_op("", name)


def _select(trace: Mapping) -> Tuple[List[dict], str]:
    """Device events where there are any (``"device-ops"``), else the
    top-level host ops (``"host-ops"``)."""
    events = trace.get("traceEvents", [])
    dev = device_events(trace)
    if dev:
        return dev, "device-ops"
    return _top_level_host_ops(_complete(events)), "host-ops"


def trace_step_period(trace: Mapping) -> float:
    """Per-step seconds from the TRACE's own clock.  A profiled loop runs
    the same kernels in the same order every step, so the time-ordered
    sequence of event names repeats with a shift of one step's count of
    events; the median time between an event and its twin one shift later
    is the step time.  The shift is taken from the names that recur
    least (once a step: the gaps between their occurrences) and accepted
    when 90% of the sequence repeats under it.  Where every recurring
    name recurs once a step (the reference's per-instruction names) this
    is the reference's median period between consecutive occurrences.
    Returns 0.0 when nothing recurs (a one-step window)."""
    selected, _src = _select(trace)
    ev = sorted(selected, key=lambda e: float(e.get("ts", 0.0)))
    names = [e.get("name", "") for e in ev]
    ts = [float(e.get("ts", 0.0)) for e in ev]
    where: Dict[str, List[int]] = {}
    for i, name in enumerate(names):
        where.setdefault(name, []).append(i)
    recurring = [p for p in where.values() if len(p) >= 2]
    if not recurring:
        return 0.0
    fewest = min(len(p) for p in recurring)
    shifts = sorted({b - a for p in recurring if len(p) == fewest
                     for a, b in zip(p, p[1:])})
    for shift in shifts:
        pairs = len(names) - shift
        same = sum(names[i] == names[i + shift] for i in range(pairs))
        if same >= 0.9 * pairs:
            gaps = sorted(ts[i + shift] - ts[i] for i in range(pairs))
            return gaps[len(gaps) // 2] / 1e6  # us -> s
    return 0.0


def attribute_trace(trace: Mapping) -> TraceAttribution:
    """Bucketed time attribution of one loaded kineto trace."""
    events = trace.get("traceEvents", [])
    selected, source = _select(trace)
    staged = _collective_copies(events) if source == "device-ops" else set()
    graph_corr = {
        (e.get("args") or {}).get("correlation")
        for e in events
        if e.get("cat") == "cuda_runtime"
        and e.get("name", "").startswith("cudaGraphLaunch")
    }
    graph_corr.discard(None)
    bucket_ms: Dict[str, float] = {b: 0.0 for b in BUCKETS}
    layer_ms: Dict[str, float] = {}
    layer_events: Dict[str, int] = {}
    intervals: List[Tuple[float, float]] = []
    graph_events = 0
    tmin, tmax = float("inf"), float("-inf")
    for e in selected:
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        intervals.append((ts, ts + dur))
        tmin, tmax = min(tmin, ts), max(tmax, ts + dur)
        if source == "device-ops":
            bucket = _bucket_device_event(e, staged)
            if (e.get("args") or {}).get("correlation") in graph_corr:
                graph_events += 1
            hit = kernel_layer(e.get("name", "")) \
                if e.get("cat") == "kernel" else None
            layer = hit[0] if hit else "other"
            layer_ms[layer] = layer_ms.get(layer, 0.0) + dur / 1e3
            layer_events[layer] = layer_events.get(layer, 0) + 1
        else:
            bucket = categorize_op("", e.get("name", ""))
        bucket_ms[bucket] += dur / 1e3
    span_ms = (tmax - tmin) / 1e3 if tmax > tmin else 0.0
    covered_ms = _merged_coverage(intervals) / 1e3
    return TraceAttribution(
        bucket_ms, span_ms, covered_ms, len(selected), source,
        layer_ms=layer_ms, kernel_events=layer_events,
        graph_launches=len(graph_corr), graph_kernel_events=graph_events,
    )


def load_trace_dir(log_dir: str) -> dict:
    """Newest ``*.trace.json.gz`` under a profile dir, parsed."""
    paths = glob.glob(
        os.path.join(log_dir, "**", "*.trace.json.gz"), recursive=True
    )
    if not paths:
        raise FileNotFoundError(f"no *.trace.json.gz under {log_dir}")
    with gzip.open(max(paths, key=os.path.getmtime), "rt") as f:
        return json.load(f)


def attribute_trace_dir(log_dir: str) -> TraceAttribution:
    """:func:`attribute_trace` over the newest capture in a profile dir
    (a :class:`~apex_tpu_torch.observability.trace.TraceScheduler` window
    dir)."""
    return attribute_trace(load_trace_dir(log_dir))


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


class RooflineRow(NamedTuple):
    bucket: str
    flops: float
    bytes: float
    time_ms: float
    achieved_tflops: float  # flops / time
    pct_peak: float  # achieved / peak
    intensity: float  # flops / byte
    bound: str  # "compute" | "bandwidth" | "comm" | "-"


def roofline_report(
    cost: CostAttribution,
    *,
    step_time_s: float,
    measured: Optional[TraceAttribution] = None,
) -> List[RooflineRow]:
    """Per-bucket roofline rows + a ``total`` row whose ``pct_peak`` is
    the step's MFU on the SAME peak table as
    :class:`~apex_tpu_torch.observability.meter.StepMeter`.  Bucket times
    come from the measured trace's shares of ``step_time_s`` when
    available, else from the cost model's estimated shares; FLOPs/bytes
    always come from the cost model (the trace cannot count them)."""
    ridge = cost.peak_flops / cost.hbm_bw  # FLOP/byte at the roof corner
    shares = (
        measured.bucket_time_fractions()
        if measured is not None and measured.busy_ms > 0
        else cost.bucket_fractions()
    )
    rows: List[RooflineRow] = []
    for b in BUCKETS:
        f = cost.buckets[b]["flops"]
        by = cost.buckets[b]["bytes"]
        t = shares.get(b, 0.0) * step_time_s
        if f == 0 and by == 0 and t == 0:
            continue
        ai = f / by if by else 0.0
        if b == "collective":
            bound = "comm"
        elif f == 0:
            bound = "bandwidth"
        else:
            bound = "compute" if ai >= ridge else "bandwidth"
        achieved = f / t if t > 0 else 0.0
        rows.append(RooflineRow(
            b, f, by, t * 1e3, achieved / 1e12,
            achieved / cost.peak_flops, ai, bound,
        ))
    total_t = step_time_s
    achieved = cost.total_flops / total_t if total_t > 0 else 0.0
    rows.append(RooflineRow(
        "total", cost.total_flops, cost.total_bytes, total_t * 1e3,
        achieved / 1e12, achieved / cost.peak_flops,
        cost.total_flops / cost.total_bytes if cost.total_bytes else 0.0,
        "-",
    ))
    return rows


def render_roofline(rows: Sequence[RooflineRow]) -> str:
    """The terminal table (ridge/bound verdicts inline)."""
    out = [
        f"{'bucket':<18} {'GFLOP':>10} {'MiB':>9} {'time_ms':>9} "
        f"{'TFLOP/s':>9} {'%peak':>7} {'FLOP/B':>8}  bound"
    ]
    for r in rows:
        out.append(
            f"{r.bucket:<18} {r.flops / 1e9:>10.2f} "
            f"{r.bytes / 2**20:>9.1f} {r.time_ms:>9.3f} "
            f"{r.achieved_tflops:>9.3f} {100 * r.pct_peak:>6.2f}% "
            f"{r.intensity:>8.1f}  {r.bound}"
        )
    return "\n".join(out)


# ---------------------------------------------------------------------------
# publication (board + Reporter sinks) — what the watchdog rules read
# ---------------------------------------------------------------------------


def publish_attribution(
    attr,
    *,
    reporter=None,
    step: int = 0,
    prefix: str = "attribution",
) -> Dict[str, float]:
    """Land an attribution's fractions on the observability board
    (``attribution/<key>_fraction``, ``attribution/bucket/<name>``) and
    — when a :class:`~apex_tpu_torch.observability.export.Reporter` is
    passed — as bench-schema lines on its sinks.  Returns the fraction
    dict.  :class:`~apex_tpu_torch.observability.health.
    CollectiveFractionRule` / ``HostStallRule`` read these keys."""
    from apex_tpu_torch.observability.metrics import board

    fractions = attr.fractions() if hasattr(attr, "fractions") else dict(attr)
    records = {}
    for key in FRACTION_KEYS:
        val = float(fractions.get(key, 0.0))
        board.set(f"{prefix}/{key}_fraction", val)
        records[f"{prefix}/{key}_fraction"] = val
    if hasattr(attr, "bucket_fractions"):
        for b, share in attr.bucket_fractions().items():
            board.set(f"{prefix}/bucket/{b}", float(share))
            records[f"{prefix}/bucket/{b}"] = float(share)
    if reporter is not None:
        from apex_tpu_torch.observability.export import bench_record

        for name, val in records.items():
            rec = bench_record(
                name, val, "fraction of step time", None, step=int(step)
            )
            for sink in reporter.sinks:
                sink.write(rec)
    return {k: records[f"{prefix}/{k}_fraction"] for k in FRACTION_KEYS}

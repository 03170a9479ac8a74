"""Peak-memory estimate of a captured step, and the budget gate.

Counterpart of ``apex_tpu/analysis/memory.py``: a linear scan of live
ranges, here over the recorded run (:class:`~apex_tpu_torch.analysis.
passes.StepRecord`) instead of scheduled HLO.  It counts

- **arguments** (the weights, the KV pool, the optimizer state, the
  inputs, any tensor the step read from outside) at their storage's
  size, live from entry to the end;
- **results**: each storage an op allocated, from that op to its last
  use — an op that reads it or a view of it, or a kernel launch whose
  pointer lands in it; a result of the step stays live to the end;
- **views, in-place ops and aliases** at 0 (they allocate nothing);
- each allocation rounded up as the caching allocator rounds it
  (:data:`~apex_tpu_torch.analysis.passes.ALLOC_ROUND`, 512 bytes).

It is a model: the allocator frees a block when Python drops the tensor,
which may be later than its last use, and keeps no record of cuBLAS's
workspace.  What it is for is the 2x of a dropped donation, a pool that
never fit, an activation that outlives its layer — not the last few
percent.  ``observability/memstats.py`` holds it against the allocator's
live peak.

Surfaces: :func:`estimate_peak` (the estimate and its top-K buffers),
:func:`memory_pass` (the ``memory-budget`` rule, against
``StepGraph.hbm_budget``), :func:`publish_peak` (the board gauges that
``memstats.crosscheck`` reads).
"""

from __future__ import annotations

import re
from typing import Dict, List

from apex_tpu_torch.analysis.findings import Finding, make_finding

__all__ = [
    "BUFFER_CATEGORIES",
    "categorize_buffer",
    "estimate_peak",
    "memory_pass",
    "publish_peak",
]

#: attribution buckets, in the order reports print them (the reference's)
BUFFER_CATEGORIES = (
    "params", "optimizer", "kv_cache", "inputs", "args",
    "activations", "collective", "constants",
)

_OPT_RE = re.compile(
    r"opt|adam|lamb|momentum|velocity|master|\bm\b|\bv\b|nu\b|mu\b",
    re.IGNORECASE,
)
_PARAM_RE = re.compile(
    r"param|weight|kernel|embed|wte|wpe|scale|bias|\bw\b|\bb\b",
    re.IGNORECASE,
)
_KV_RE = re.compile(r"kv|cache|pages|pool", re.IGNORECASE)
_INPUT_RE = re.compile(
    r"batch|input|tokens|ids|\bx\b|\by\b|label", re.IGNORECASE
)

_ALLOC_ROUND = 512


def categorize_buffer(kind: str, name: str) -> str:
    """One of :data:`BUFFER_CATEGORIES`: an argument (``kind``
    ``"parameter"``, as the reference's opcode) by its path, an
    unnamed external tensor as a constant, a collective's result as
    collective scratch, anything else an op allocated as activations."""
    if kind == "parameter":
        path = name or ""
        if not path:
            return "constants"
        if _OPT_RE.search(path):
            return "optimizer"
        if _KV_RE.search(path):
            return "kv_cache"
        if _PARAM_RE.search(path):
            return "params"
        if _INPUT_RE.search(path):
            return "inputs"
        return "args"
    if kind == "constant":
        return "constants"
    if kind.startswith(("all-", "reduce-scatter", "collective-")):
        return "collective"
    return "activations"


def _rounded(n: int) -> int:
    return -(-int(n) // _ALLOC_ROUND) * _ALLOC_ROUND if n > 0 else 0


def estimate_peak(record, top_k: int = 10) -> dict:
    """Linear-scan live-range peak over the record.

    Returns ``{"peak_bytes", "peak_index", "param_bytes",
    "by_category": {category: bytes at the peak}, "buffers": [{"name",
    "bytes", "category", "op_name", "defined", "freed"}, ...]}`` —
    ``buffers`` the top K live at the peak op, largest first.
    ``param_bytes`` is the arguments' total."""
    ops = record.ops
    end = max(len(ops) - 1, 0)
    last: Dict[int, int] = {}
    collective: set = set()
    for op in ops:
        for r in op.ins:
            last[r.buf] = op.index
        for r in op.outs:
            last[r.buf] = max(last.get(r.buf, op.index), op.index)
        if op.kind == "collective":
            collective.update(op.fresh)
    outputs = set(record.outputs)
    rows = []  # (name, bytes, category, op_name, defined, freed)
    for b in record.buffers.values():
        size = _rounded(b.nbytes)
        if b.defined < 0:
            rows.append((b.name or f"external#{b.id}", size,
                         categorize_buffer("parameter", b.name), b.name,
                         -1, end))
            continue
        freed = end if b.id in outputs else last.get(b.id, b.defined)
        kind = "all-reduce" if b.id in collective else "activation"
        rows.append((f"%{b.defined}", size, categorize_buffer(kind, ""),
                     b.producer, b.defined, max(freed, b.defined)))
    allocs: Dict[int, List[int]] = {}
    frees: Dict[int, List[int]] = {}
    live = 0
    live_set = set()
    for i, r in enumerate(rows):
        if r[4] < 0:
            live += r[1]
            live_set.add(i)
        else:
            allocs.setdefault(r[4], []).append(i)
        frees.setdefault(r[5], []).append(i)
    peak, peak_idx, peak_set = live, -1, set(live_set)
    for i in range(len(ops)):
        for r in allocs.get(i, ()):
            live += rows[r][1]
            live_set.add(r)
        if live > peak:
            peak, peak_idx, peak_set = live, i, set(live_set)
        for r in frees.get(i, ()):
            if rows[r][4] >= 0 or i == end:
                live -= rows[r][1]
                live_set.discard(r)
    at_peak = sorted((rows[r] for r in peak_set), key=lambda r: -r[1])
    by_cat: Dict[str, int] = {}
    for _n, size, cat, _o, _d, _f in at_peak:
        by_cat[cat] = by_cat.get(cat, 0) + size
    return {
        "peak_bytes": int(peak),
        "peak_index": int(peak_idx),
        "param_bytes": int(sum(r[1] for r in rows if r[4] < 0)),
        "by_category": by_cat,
        "buffers": [
            {"name": n, "bytes": int(s), "category": c, "op_name": o,
             "defined": d, "freed": f}
            for n, s, c, o, d, f in at_peak[:top_k]
        ],
    }


def memory_pass(graph) -> List[Finding]:
    """The budget gate: with ``hbm_budget`` (bytes) on the
    :class:`~apex_tpu_torch.analysis.passes.StepGraph`, an estimated peak
    above it is a ``memory-budget`` ERROR naming the top live buffers."""
    if graph.ops is None or graph.hbm_budget is None:
        return []
    budget = int(graph.hbm_budget)
    est = estimate_peak(graph.ops)
    if est["peak_bytes"] <= budget:
        return []
    top = ", ".join(
        f"{b['category']}:{b['name']}={b['bytes'] / (1 << 20):.1f}MiB"
        for b in est["buffers"][:5]
    )
    return [make_finding(
        "memory-budget",
        path=f"op #{est['peak_index']}",
        message=(
            f"estimated peak memory {est['peak_bytes'] / (1 << 20):.1f} MiB "
            f"exceeds the {budget / (1 << 20):.1f} MiB budget "
            f"(top live buffers: {top})"
        ),
    )]


def publish_peak(est: dict, prefix: str = "analysis") -> None:
    """Gauge an estimate onto the board (``<prefix>/peak_hbm_bytes`` and
    ``<prefix>/peak_hbm/<category>``): what
    :func:`apex_tpu_torch.observability.memstats.crosscheck` and the
    ``--metrics-out`` JSONL read."""
    from apex_tpu_torch.observability.metrics import board

    board.set(f"{prefix}/peak_hbm_bytes", est["peak_bytes"])
    for cat, size in est["by_category"].items():
        board.set(f"{prefix}/peak_hbm/{cat}", size)

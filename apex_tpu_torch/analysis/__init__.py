"""Checks of a built program (counterpart of :mod:`apex_tpu.analysis`).

The reference proves structural properties of a compiled step from its
jaxpr and HLO.  The port records one run of the step instead
(:func:`.passes.capture`: every aten op, kernel launch and collective, in
order) and runs the same passes over the record:

- **transfer lint** — no host round trip inside the step (``.item()``, a
  data-dependent shape, a copy from the card to the host);
- **promotion lint** — no silent widening past the ``amp`` policy, no
  f64;
- **donation lint** — every argument declared in place (the KV pool, an
  optimizer state) comes back in its own storage;
- **collective consistency** — the step's collectives match the comm
  engine's promise (count, bytes, wire dtype), and the declared per-axis
  plan (``expect_plan``, the reshard rule);
- **memory budget** — the live-range peak of the record, with top-K
  attribution, against a budget (:mod:`.memory`);
- **kernel passes** — the CUDA kernels' launch plans themselves
  (:mod:`.kernels`): shared memory per CTA, tile alignment, the
  persistent grid's coverage, causal dead tiles, the roofline;
- the source lints — lock discipline (:mod:`.concurrency`) and replay
  purity (:mod:`.purity`) — over ``StepGraph.sources``;
- the retrace sentinel (:mod:`.retrace`) and the trainer's rule tables
  (:mod:`.sharding`).

Surfaces::

    from apex_tpu_torch import analysis

    report = analysis.check(step_fn, state, batch, policy=torch.bfloat16,
                            donate_argnums=(0,))
    assert report.ok(), report.render()

plus ``tools/graph_lint.py``, ``tools/kernel_lint.py``, the serving
engine's build checks (``ServeConfig(verify=True)``) and
:func:`publish_report`, which puts the counts on the observability board.
"""

from __future__ import annotations

import time
from typing import Optional

from apex_tpu_torch.analysis import concurrency, purity, retrace  # noqa: F401
from apex_tpu_torch.analysis import hlo, kernels, memory  # noqa: F401
from apex_tpu_torch.analysis.findings import (  # noqa: F401
    RULES,
    make_finding,
)
from apex_tpu_torch.analysis.passes import _paths
from apex_tpu_torch.analysis.passes import (  # noqa: F401
    PASSES,
    StepGraph,
    StepRecord,
    capture,
    iter_ops,
    named_scope,
)
from apex_tpu_torch.analysis.retrace import (  # noqa: F401
    RetraceSentinel,
    abstract_signature,
)
from apex_tpu_torch.analysis.sharding import (  # noqa: F401
    ERROR,
    INFO,
    WARNING,
    Finding,
    P,
    PartitionSpec,
    Report,
    match_partition_rules,
    spec_dim_factors,
    tree_paths,
)

__all__ = [
    "check",
    "lint_graph",
    "lint_package",
    "publish_report",
    "attach_shard_sections",
    "Finding",
    "Report",
    "RULES",
    "ERROR",
    "WARNING",
    "INFO",
    "make_finding",
    "RetraceSentinel",
    "abstract_signature",
    "StepGraph",
    "StepRecord",
    "PASSES",
    "capture",
    "iter_ops",
    "named_scope",
    "concurrency",
    "hlo",
    "kernels",
    "memory",
    "purity",
    "sharding",
    "match_partition_rules",
]

#: passes whose substrate is the record (``StepGraph.ops``)
_RECORD_ONLY = ("transfer", "promotion", "donation", "collective",
                "reshard", "memory")
#: passes whose substrate is source text (``StepGraph.sources``)
_SOURCE_ONLY = ("concurrency", "purity")


def _select(rules) -> tuple:
    if rules is None:
        return tuple(PASSES)
    unknown = [r for r in rules if r not in PASSES]
    if unknown:
        raise ValueError(
            f"unknown analysis pass(es) {unknown}; have {sorted(PASSES)}")
    return tuple(rules)


def _run(graph: StepGraph, rules, target: str) -> Report:
    selected = _select(rules)
    if graph.ops is None:
        # a pass that cannot run must not be reported as run
        selected = tuple(r for r in selected if r not in _RECORD_ONLY)
    if graph.sources is None:
        selected = tuple(r for r in selected if r not in _SOURCE_ONLY)
    report = Report(target=target, rules_run=selected)
    for name in selected:
        t0 = time.perf_counter()
        report.extend(PASSES[name](graph))
        report.pass_timings[name] = (time.perf_counter() - t0) * 1e3
    return report


def check(fn, *args, rules=None, policy=None, donate_argnums=None,
          donated_paths=(), named=None, expect_collectives=None,
          expect_plan=None, hbm_budget=None, publish: bool = False,
          name: Optional[str] = None, **kwargs) -> Report:
    """Run ``fn(*args, **kwargs)`` ONCE under the recorder and the
    selected passes over the record; return a :class:`Report` whose
    ``record`` is the :class:`StepRecord` and ``result`` what ``fn``
    returned.  The step really runs: pass copies of arguments the caller
    needs unchanged.

    ``policy`` (an amp policy or a dtype) arms the promotion-widen rule;
    ``donate_argnums`` (or ``donated_paths``, argument paths such as
    ``"kv_cache"``) arms the donation rule; ``named`` names trees the
    step reads besides its arguments (its weights); ``expect_collectives``
    arms collective consistency (the reference's schema), ``expect_plan``
    (the trainer's per-axis plan) the reshard rule, ``hbm_budget``
    (bytes) the memory gate.  The reference's ``expect_sharding`` has no
    counterpart: one card compiles no shardings, and the trainer checks
    its shards itself.  ``publish=True`` gauges the counts onto the
    board."""
    result, record = capture(fn, *args, named=named, **kwargs)
    donated = None
    if donate_argnums is not None:
        donated = sum(len(_paths(args[i], f"arg{i}"))
                      for i in donate_argnums)
    graph = StepGraph(ops=record, policy=policy, donated=donated,
                      donated_argnums=tuple(donate_argnums or ()),
                      donated_paths=tuple(donated_paths),
                      expect_collectives=expect_collectives,
                      expect_plan=expect_plan, hbm_budget=hbm_budget)
    target = name or getattr(fn, "__name__", None) or repr(fn)
    report = _run(graph, rules, target)
    report.record = record
    report.result = result
    if publish:
        publish_report(report)
    return report


def lint_graph(record: StepRecord, *, policy=None, donated_paths=(),
               hbm_budget=None, expect_collectives=None, rules=None,
               name: str = "") -> Report:
    """Run the passes over a record the caller already made
    (``lint_jaxpr``'s counterpart: the serving engine records its
    warm-ups and lints them here).  Default rules: transfer, promotion,
    and donation, memory and collective consistency when their intent is
    given."""
    graph = StepGraph(ops=record, policy=policy,
                      donated_paths=tuple(donated_paths),
                      hbm_budget=hbm_budget,
                      expect_collectives=expect_collectives)
    wanted = rules if rules is not None else (
        "transfer", "promotion", "donation", "collective", "memory")
    report = _run(graph, wanted, name or "step")
    report.record = record
    return report


def lint_package(root: Optional[str] = None,
                 rules=("concurrency", "purity"),
                 name: str = "apex_tpu_torch") -> Report:
    """The source passes (lock discipline, replay purity) over the
    package's source tree (``StepGraph.sources``, default: the installed
    ``apex_tpu_torch``), timed and reported as every graph pass."""
    graph = StepGraph(sources=purity.collect_sources(root))
    report = _run(graph, rules, name)
    report.sections["files_scanned"] = len(graph.sources)
    return report


def attach_shard_sections(report: Report, programs,
                          publish: bool = True) -> Report:
    """Fill the report's ``sections`` with the memory picture of one or
    more recorded programs (``[(name, record), ...]``):
    ``peak_hbm_bytes`` (the largest: the programs run one after
    another), ``peak_hbm_by_program`` and the largest's
    ``peak_hbm_by_category``; ``shard_plan`` lists each program's
    argument leaves with their bytes (the reference's GSPMD plan table
    has no counterpart on one card).  ``publish=True`` gauges the peak
    as ``analysis/peak_hbm_bytes``."""
    peaks, cats, rows = {}, {}, []
    report.programs = list(programs)
    for prog_name, record in report.programs:
        if record is None:
            continue
        est = memory.estimate_peak(record)
        peaks[prog_name] = est["peak_bytes"]
        if est["peak_bytes"] == max(peaks.values()):
            cats = est["by_category"]
        for path, bid in sorted(record.arguments.items()):
            b = record.buffers[bid]
            rows.append({"program": prog_name, "path": path,
                         "bytes": b.nbytes, "dtype": b.dtype,
                         "verdict": "whole"})
    peak = max(peaks.values()) if peaks else 0
    report.sections["peak_hbm_bytes"] = peak
    report.sections["peak_hbm_by_program"] = peaks
    report.sections["peak_hbm_by_category"] = cats
    report.sections["shard_plan"] = rows
    if publish:
        memory.publish_peak({"peak_bytes": peak, "by_category": cats})
        from apex_tpu_torch.observability.metrics import board

        board.set("analysis/shard_plan/rows", len(rows))
    return report


def publish_report(report: Report, prefix: str = "analysis") -> None:
    """Gauge a report's counts onto the observability board
    (``<prefix>/errors``, ``/warnings``, ``/rule/<id>``,
    ``/pass_ms/<name>``), deduplicated by (rule, location) as the
    reference's."""
    from apex_tpu_torch.observability.metrics import board

    unique = report.deduped()
    board.set(f"{prefix}/target", report.target)
    board.set(f"{prefix}/errors",
              sum(1 for f in unique if f.severity == ERROR))
    board.set(f"{prefix}/warnings",
              sum(1 for f in unique if f.severity == WARNING))
    counts = {}
    for f in unique:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    for rule, count in counts.items():
        board.set(f"{prefix}/rule/{rule}", count)
    for name, ms in report.pass_timings.items():
        board.set(f"{prefix}/pass_ms/{name}", round(ms, 3))

"""Shard report — the human-readable sharding plan + memory breakdown
of a recorded step program.

Counterpart of ``tools/shard_report.py``.  Where
``apex_tpu_torch.tools.graph_lint`` answers "is the plan violated?" with
findings and an exit code, this renders the plan itself, from one
recorded run of each program (:func:`apex_tpu_torch.analysis.capture`):

- one row per parameter of the step (the state's leaves and the batch):
  the shape this rank holds, the global bytes, the tiling the rank's
  shard shows against the global shape (``replicated`` or ``tiled
  [f0,f1,...]``: the shards per dimension), the spec the target's rule
  table declares and the conformance verdict (the reference's ``ok`` /
  ``replicated`` / ``mismatch`` / ``unchecked``);
- the collective schedule of each program, per mesh axis, from the
  call log (:mod:`apex_tpu_torch.parallel.comm`);
- the static peak estimate with top-K attribution
  (:func:`apex_tpu_torch.analysis.memory.estimate_peak`) beside the
  allocator's ``max_memory_allocated`` over the same run (on the card).

Targets (the same builders as ``graph_lint``):

  --target resilient   the resilient example's two programs
                       (``compute_grads``, ``apply_update``), against its
                       own rule table and DDP plan, in this process.
  --target serve       the serve example's engine: its smallest prefill
                       bucket and its decode step.
  --target train       the composable trainer's demo
                       (``train.demo.build_demo``) at --dp x --tp, on
                       dp x tp gloo ranks (``tools/_ranks.py``), against
                       the trainer's own rule table and collective plan;
                       rank 0's report.

The reference's ``--hlo FILE`` (any optimized-HLO dump) has no
counterpart: the port compiles no program text to read, and its records
live only in the process that ran the step.  Nor has ``--donated N``, the
declared donated-leaf count that only the ``--hlo`` mode reads.

Options: ``--budget BYTES`` (the peak budget: the headroom line, and exit
1 when exceeded), ``--top K`` (buffers at the peak, default 10), ``--wire``
/ ``--accum`` (forwarded to the builders), ``--json FILE`` (the report's
JSON: the findings and the ``peak_hbm_bytes`` / ``peak_hbm_by_program`` /
``peak_hbm_by_category`` / ``shard_plan`` sections), ``--expect JSON``
(collective expectations, the resilient target's), ``--device`` (the
card by default; ``cpu`` runs the plain versions)::

    python -m apex_tpu_torch.tools.shard_report --target train --dp 2

Exit code: 0 clean, 1 any ERROR finding (incl. budget overflow), 2 usage
error.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:,.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"  # pragma: no cover - fallthrough


def _table(rows, headers):
    widths = [
        max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows
        else len(str(h))
        for i, h in enumerate(headers)
    ]
    line = "  ".join(str(h).ljust(w) for h, w in zip(headers, widths))
    out = [line, "-" * len(line)]
    for r in rows:
        out.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    return "\n".join(out)


def render(report, top: int, budget=None) -> str:
    """Text report from a lint Report whose sections were filled by
    :func:`attach_programs` (``report.programs``: per program its
    collective schedule and memory estimate, read from its record)."""
    sec = report.sections
    out = [f"shard report: {report.target}"]

    plan = sec.get("shard_plan") or []
    if plan:
        out.append("\n== parameter shard plan "
                   "(compiled sharding vs declared spec)")
        out.append(_table(
            [
                (
                    r["program"].rsplit("/", 1)[-1], r["name"],
                    r["shape"], _fmt_bytes(r["global_bytes"]),
                    r["sharding"], r["intended"] or "-", r["verdict"],
                )
                for r in plan
            ],
            ("program", "param", "local shape", "global",
             "compiled sharding", "declared", "verdict"),
        ))

    for prog_name, prog in getattr(report, "programs", []):
        if not prog:
            continue
        colls = prog["collectives"]
        if colls:
            out.append(f"\n== collective schedule ({prog_name})")
            out.append(_table(
                [
                    (
                        c["kind"], c["group_size"] or "-",
                        _fmt_bytes(c["bytes"]),
                        "/".join(sorted(c["dtypes"])) or "-",
                        (c["op_name"] or c["name"])[-60:],
                    )
                    for c in colls
                ],
                ("kind", "group", "bytes", "dtypes", "op"),
            ))
        est = prog["memory"]
        out.append(
            f"\n== memory ({prog_name}): static peak "
            f"{_fmt_bytes(est['peak_bytes'])} at instruction "
            f"#{est['peak_index']}"
        )
        if prog.get("measured_peak_bytes") is not None:
            out.append(f"   measured: max_memory_allocated "
                       f"{_fmt_bytes(prog['measured_peak_bytes'])}")
        cats = ", ".join(
            f"{k}={_fmt_bytes(v)}"
            for k, v in sorted(
                est["by_category"].items(), key=lambda kv: -kv[1]
            )
        )
        out.append(f"   at-peak by category: {cats}")
        out.append(_table(
            [
                (
                    b["category"], b["name"], _fmt_bytes(b["bytes"]),
                    f"[{b['defined']}, {b['freed']}]",
                    (b["op_name"] or "")[-50:],
                )
                for b in est["buffers"][:top]
            ],
            ("category", "buffer", "bytes", "live", "op"),
        ))

    peak = sec.get("peak_hbm_bytes", 0)
    if budget is not None:
        headroom = budget - peak
        verdict = "WITHIN" if headroom >= 0 else "EXCEEDS"
        out.append(
            f"\nbudget: peak {_fmt_bytes(peak)} {verdict} "
            f"{_fmt_bytes(budget)} "
            f"(headroom {_fmt_bytes(headroom)})"
        )
    if report.findings:
        out.append("\n== findings")
        for f in report.findings:
            out.append("  " + f.render())
    else:
        out.append("\nfindings: none — the declared plan holds")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# the plan rows and the program views
# ---------------------------------------------------------------------------

_SHORT = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
          "float64": "f64", "int64": "s64", "int32": "s32", "int16": "s16",
          "int8": "s8", "uint8": "u8", "bool": "pred"}


def spec_text(spec) -> str:
    """A spec as the reference prints a JAX ``PartitionSpec``:
    ``PartitionSpec(None, 'tp')``, ``PartitionSpec('dp',)``."""
    return "PartitionSpec" + tuple.__repr__(tuple(spec))


def shape_text(shape, dtype) -> str:
    name = str(dtype).replace("torch.", "")
    return f"{_SHORT.get(name, name)}[{','.join(str(d) for d in shape)}]"


def plan_rows(program: str, named, mesh: dict) -> list:
    """The shard plan of one program: ``named`` is ``[(name, local
    tensor, global shape or None, declared spec or None), ...]``."""
    from apex_tpu_torch.analysis.sharding import spec_dim_factors

    rows = []
    for i, (name, leaf, gshape, spec) in enumerate(named):
        local = tuple(leaf.shape)
        gshape = local if gshape is None else tuple(gshape)
        have = [g // l if l else 1 for g, l in zip(gshape, local)]
        sharding = ("replicated" if all(f == 1 for f in have)
                    else f"tiled [{','.join(str(f) for f in have)}]")
        want, verdict = None, "unchecked"
        if spec is not None:
            want = spec_dim_factors(spec, mesh, len(local))
            if all(f == 1 for f in want):
                verdict = "ok" if sharding == "replicated" else "mismatch"
            elif sharding == "replicated":
                verdict = "replicated"
            else:
                verdict = "ok" if have == want else "mismatch"
        rows.append({
            "program": program,
            "param": i,
            "name": name,
            "shape": shape_text(local, leaf.dtype),
            "global_bytes": int(math.prod(gshape)) * leaf.element_size(),
            "sharding": sharding,
            "intended": spec_text(spec) if spec is not None else None,
            "factors": want,
            "verdict": verdict,
        })
    return rows


def program_view(record, mesh: dict, top: int, measured=None) -> dict:
    """What :func:`render` reads of one recorded program: its collective
    schedule (one row a call, in order: kind, the axis's size, bytes,
    dtypes, ``axis: scope``), its memory estimate (top ``top`` buffers)
    and the allocator's peak over the same run (None off the card)."""
    from apex_tpu_torch.analysis import memory

    colls = []
    for op in record.ops:
        if op.kind != "collective":
            continue
        axis = op.meta.get("axis")
        colls.append({
            "kind": op.name,
            "group_size": mesh.get(axis),
            "bytes": int(op.meta.get("bytes", 0)),
            "dtypes": [op.meta["dtype"]] if op.meta.get("dtype") else [],
            "op_name": f"{axis}: {op.scope or '<step>'}",
            "name": f"%{op.index}",
        })
    return {"collectives": colls,
            "memory": memory.estimate_peak(record, top_k=top),
            "measured_peak_bytes": measured}


def attach_programs(report, programs, rows, mesh: dict, top: int,
                    measured=None) -> None:
    """Fill ``report``'s sections (the reference's four: the peaks by
    program and category, and ``shard_plan`` = ``rows``) and its
    ``programs`` (name, view) from ``programs`` = ``[(name, record)]``;
    ``measured`` maps a program to its allocator peak."""
    from apex_tpu_torch import analysis

    analysis.attach_shard_sections(report, programs)
    report.sections["shard_plan"] = rows
    for key in ("plan", "memory"):  # the trainer's own, shown above
        report.sections.pop(key, None)
    report.programs = [(name, program_view(rec, mesh, top,
                                           (measured or {}).get(name)))
                       for name, rec in programs]


def _measured(dev):
    import torch

    return (int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else None)


# ---------------------------------------------------------------------------
# the targets
# ---------------------------------------------------------------------------


def lint_resilient(args, device):
    """The resilient example's ``compute_grads`` (on a real batch of its
    own ``batch_fn``) and ``apply_update`` (on the first's outputs), each
    recorded once and held to the example's DDP plan (the update: no
    collective at all)."""
    import torch

    from apex_tpu_torch import analysis
    from apex_tpu_torch.analysis.passes import _paths
    from apex_tpu_torch.analysis.sharding import P
    from apex_tpu_torch.examples import train_resilient

    t = train_resilient.build_training(accum=args.accum, wire=args.wire,
                                       device=str(device))
    state, batch = t["state"], t["batch_fn"](0)
    dp = t["dp"]
    mesh = {"dp": dp}
    plan = t["expect_plan"]
    measured = {}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    report = analysis.check(
        t["compute_grads"], state["params"], state["scaler"], batch,
        expect_collectives=args.expect, expect_plan=plan,
        hbm_budget=args.budget, name="resilient/compute_grads")
    measured["resilient/compute_grads"] = _measured(device)
    loss, scaled = report.result
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    up = analysis.check(
        t["apply_update"], scaled, state, loss,
        expect_plan={"mesh": plan.get("mesh", mesh), "collectives": []},
        hbm_budget=args.budget, name="resilient/apply_update")
    measured["resilient/apply_update"] = _measured(device)
    # the example's rule table (train/guarded.py): replicated params and
    # scaler, the batch's rows over dp; one process holds the whole batch
    specs = {"params": P(), "scaler": P(), "batch": P(None, "dp")}
    named = [(path, leaf, None, specs[prefix])
             for prefix, tree in (("params", state["params"]),
                                  ("scaler", state["scaler"]),
                                  ("batch", batch))
             for path, leaf in _paths(tree, prefix)]
    programs = [("resilient/compute_grads", report.record),
                ("resilient/apply_update", up.record)]
    attach_programs(report, programs,
                    plan_rows("resilient/compute_grads", named, mesh),
                    mesh, args.top, measured)
    report.merge(up)
    report.target = "resilient"
    return report


def lint_serve(args, device):
    """The serve example's engine (random weights from a seed), its
    smallest prefill bucket and its decode step (``engine.lint()``)."""
    import torch

    from apex_tpu_torch.analysis.passes import _paths
    from apex_tpu_torch.examples import serve_gpt
    from apex_tpu_torch.models.gpt import GptModel

    cfg = serve_gpt.model_config(device)
    model = GptModel(cfg, device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    engine = serve_gpt.build_serving(
        cfg, model, kv_wire="int8" if args.wire == "int8" else "f32",
        verify=False, hbm_budget_bytes=args.budget, device=device)
    report = engine.lint()
    named = [(path, leaf, None, None) for path, leaf in
             _paths(engine._arguments()[0], "")]
    programs = list(report.programs)
    attach_programs(report, programs, plan_rows(programs[0][0], named, {}),
                    {}, args.top)
    report.target = "serve"
    return report


def _train_rank(rank, world, dp, tp, wire, budget, top, device):
    """One rank of the train target: the demo at (dp, tp), its verify's
    record, and rank 0's report as JSON-able parts."""
    import torch

    from apex_tpu_torch.analysis.sharding import (
        P,
        flatten_up_to,
        tree_leaves,
        tree_paths,
    )
    from apex_tpu_torch.train import demo, sharding as tsh
    from apex_tpu_torch.train.trainer import PerRank, _slice_mine

    step = demo.build_demo(dp, tp, wire=wire, verify="off",
                           hbm_budget=budget, device=device)
    dev = step.device
    report = step.verify()
    report.target = f"train/dp{dp}tp{tp}/{step.mode}"
    mesh = step.config.mesh_dict()
    named = []
    for part in ("opt", "params"):
        tree = step.state[part]
        tree = tree.tree if isinstance(tree, PerRank) else tree
        for (path, leaf), shape, spec in zip(
                tree_paths(tree), tree_leaves(step.global_shapes[part]),
                tsh._spec_leaves(step.state_specs[part], tree)):
            if isinstance(leaf, torch.Tensor):
                named.append((f"state/{part}/{path}", leaf,
                              tuple(shape.shape), spec))
    batch = step.example_batch
    specs = ([step.batch_specs] if isinstance(step.batch_specs, P)
             else flatten_up_to(batch, step.batch_specs))
    for i, (g, s) in enumerate(zip(tree_leaves(batch), specs)):
        named.append((f"batch/{i}", _slice_mine(g, s), tuple(g.shape), s))
    measured = report.sections.get("memory", {}).get("peak_bytes") \
        if dev.type == "cuda" else None
    name = f"{step.name}/{step.mode}"
    attach_programs(report, [(name, report.record)],
                    plan_rows(name, named, mesh), mesh, top,
                    {name: measured})
    return {"json": report.to_json(), "programs": report.programs}


def lint_train(args, device):
    """The demo trainer at --dp x --tp on dp x tp ranks (gloo; NCCL where
    every rank has a card); rank 0's report."""
    from apex_tpu_torch.analysis.findings import Finding, Report
    from apex_tpu_torch.tools._ranks import run_ranks

    world = args.dp * args.tp
    out = run_ranks(world, _train_rank, dict(
        dp=args.dp, tp=args.tp, wire=args.wire, budget=args.budget,
        top=args.top, device=device.type), device=device.type)[0]
    js = out["json"]
    report = Report([Finding(**f) for f in js["findings"]],
                    target=js["target"], rules_run=tuple(js["rules_run"]))
    report.pass_timings = dict(js["pass_timings"])
    for key in ("peak_hbm_bytes", "peak_hbm_by_program",
                "peak_hbm_by_category", "shard_plan"):
        report.sections[key] = js[key]
    report.programs = out["programs"]
    return report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="human-readable shard plan + memory breakdown")
    ap.add_argument("--target", choices=["resilient", "serve", "train"],
                    required=True)
    ap.add_argument("--wire", default="f32",
                    choices=["f32", "bf16", "int8"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--dp", type=int, default=2,
                    help="train-target dp axis size (default 2)")
    ap.add_argument("--tp", type=int, default=2,
                    help="train-target tp axis size (default 2)")
    ap.add_argument("--budget", type=int, default=None, metavar="BYTES")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--json", metavar="FILE", default=None)
    ap.add_argument("--expect", type=json.loads, default=None,
                    metavar="JSON", help="collective expectations "
                    "(the resilient target's)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from apex_tpu_torch import analysis
    from apex_tpu_torch.ops._dispatch import resolve_device

    device = resolve_device(args.device)
    if args.target == "serve":
        report = lint_serve(args, device)
    elif args.target == "train":
        report = lint_train(args, device)
    else:
        report = lint_resilient(args, device)
    analysis.publish_report(report)
    peak = report.sections.get("peak_hbm_bytes", 0)
    if args.budget is not None and peak > args.budget and not any(
            f.rule == "memory-budget" for f in report.findings):
        from apex_tpu_torch.analysis.findings import make_finding

        report.extend([make_finding(
            "memory-budget", report.target,
            f"static peak {peak} bytes over the {args.budget}-byte "
            "budget")])
    print(render(report, top=args.top, budget=args.budget))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_json(), f, indent=2)
            f.write("\n")
        print(f"[shard_report] wrote {args.json}", file=sys.stderr)
    return 0 if report.ok() else 1


if __name__ == "__main__":
    sys.exit(main())

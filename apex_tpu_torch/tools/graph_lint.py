"""Lint the port's step programs from one recorded run each.

Counterpart of ``tools/graph_lint.py``: the passes of
:mod:`apex_tpu_torch.analysis` (host transfers, promotion, in-place
donation, collectives, the memory estimate against a budget) over

- ``--target serve``: the serving engine of
  :mod:`apex_tpu_torch.examples.serve_gpt` (random weights from a seed),
  its smallest prefill bucket and its decode step (``engine.lint()``);
- ``--target train``: the dp x tp demo trainer at world 1
  (``train.demo.build_demo``), its step's verify (shapes, plan, the graph
  passes, the estimate beside the measured peak).

::

    python -m apex_tpu_torch.tools.graph_lint --target serve --device cpu
    python -m apex_tpu_torch.tools.graph_lint --target train --json t.json

Exit code: 0 clean, 1 an ERROR finding (or a WARNING with
``--fail-on warning``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch


def lint_serve(args):
    from apex_tpu_torch.examples import serve_gpt
    from apex_tpu_torch.models.gpt import GptModel
    from apex_tpu_torch.ops._dispatch import resolve_device

    device = resolve_device(args.device)
    cfg = serve_gpt.model_config(device)
    model = GptModel(cfg, device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    engine = serve_gpt.build_serving(
        cfg, model, kv_wire=args.wire, verify=False,
        hbm_budget_bytes=args.budget, device=device)
    return engine.lint()


def lint_train(args):
    from apex_tpu_torch.train import demo

    step = demo.build_demo(1, 1, verify="off", hbm_budget=args.budget,
                           device=args.device)
    return step.verify()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", choices=["serve", "train"], default="serve")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--wire", default="f32", choices=["f32", "int8"],
                    help="the serving engine's KV wire")
    ap.add_argument("--budget", type=int, default=None, metavar="BYTES",
                    help="memory budget of each program (the memory pass)")
    ap.add_argument("--json", metavar="FILE", default=None)
    ap.add_argument("--fail-on", choices=["error", "warning"],
                    default="error")
    args = ap.parse_args(argv)
    report = lint_serve(args) if args.target == "serve" else lint_train(args)
    print(report.render())
    for key in ("peak_hbm_by_program", "memory"):
        if key in report.sections:
            print(f"  {key}: {report.sections[key]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_json(), f, indent=2, default=str)
    return 0 if report.ok(args.fail_on) else 1


if __name__ == "__main__":
    sys.exit(main())

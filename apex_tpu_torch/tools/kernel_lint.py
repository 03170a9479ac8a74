"""Lint the CUDA kernels' launch plans and print their rooflines.

Counterpart of ``tools/kernel_lint.py``: the static analysis of
:mod:`apex_tpu_torch.analysis.kernels` over every ``kernel_specs``
instance at the main paths' shapes (K1-K6, bf16 and f32, int8 pages):
shared memory per CTA against the card's opt-in limit, tile alignment,
grid coverage and races, causal dead tiles, the roofline bound.  Nothing
is built or launched, so it runs anywhere::

    python -m apex_tpu_torch.tools.kernel_lint
    python -m apex_tpu_torch.tools.kernel_lint --json kernels.json \\
        --max-dead-tile 0.15

Exit code: 0 clean, 1 an ERROR finding (or the dead-tile bound passed).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from apex_tpu_torch.analysis import kernels


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device-kind", default="NVIDIA H100",
                    help="the card whose limits and peaks to judge against")
    ap.add_argument("--smem-budget", type=int, default=None,
                    help="shared memory per CTA, bytes (default: the card's)")
    ap.add_argument("--max-dead-tile", type=float, default=None,
                    help="fail when a causal walk wastes more than this "
                    "share of its live tiles")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="write the report as JSON")
    ap.add_argument("--fail-on", choices=["error", "warning"],
                    default="error")
    args = ap.parse_args(argv)
    report = kernels.analyze_default_kernels(
        device_kind=args.device_kind, smem_budget=args.smem_budget,
        dead_tile_threshold=(args.max_dead_tile
                             if args.max_dead_tile is not None else 0.25))
    print(report.render())
    for e in report.sections["kernels"]:
        r = e["roofline"]
        waste = e.get("dead_tiles", {}).get("waste_fraction")
        print(f"  {e['config']:28} {e['name']:52} grid {e['grid']:6} "
              f"smem {e['smem_bytes']:6} bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})"
              + ("" if waste is None else f" dead-tile waste {waste:.3f}"))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_json(), f, indent=2)
    if args.max_dead_tile is not None and report.by_rule("kernel-dead-tiles"):
        return 1
    return 0 if report.ok(args.fail_on) else 1


if __name__ == "__main__":
    sys.exit(main())

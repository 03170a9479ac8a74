"""Concurrency & replay-purity lint CLI — the host-side static half of
the concurrency story.

Counterpart of ``tools/concurrency_lint.py``.  Runs two AST passes over
the ``apex_tpu_torch`` package source — no torch, no imports of the code
under analysis:

- :mod:`apex_tpu_torch.analysis.concurrency` — lock-discipline lint:
  per-class maps of attributes mutated under ``with self._lock`` vs.
  outside, thread entrypoints (``threading.Thread(target=...)``,
  ``http.server`` handler classes) + a lightweight call graph; an
  attribute reachable from both a thread body and the main path and
  written without the lock is ``race-unlocked-shared-state`` (or
  ``race-nonatomic-counter`` when every site is a read-modify-write);
  a lock held across a bounded-queue ``put``/``join``/``result()``
  whose consumer thread needs the same lock is
  ``race-lock-across-blocking``.
- :mod:`apex_tpu_torch.analysis.purity` — replay-purity lint over the
  declared replay-critical modules (``purity.REPLAY_CRITICAL``):
  wall-clock reads, unseeded RNG, iteration over sets feeding
  scheduling, env reads outside construction (``replay-*`` rules).

Waiver syntax (same line as the finding, reason required by review)::

    t = time.time()  # lint: allow(replay-wall-clock): display only

Usage::

    python -m apex_tpu_torch.tools.concurrency_lint                 # table
    python -m apex_tpu_torch.tools.concurrency_lint --json out.json
    python -m apex_tpu_torch.tools.concurrency_lint --root PKG_DIR

Exit code: 0 clean, 1 findings at/above ``--fail-on`` (default:
error), 2 usage error.

The passes and the rule catalog (``findings.py``) are stdlib-only at
module level; this tool loads them standalone, by file path, under
their real dotted names, so the lint runs where torch is not installed
(a lint stage, a pre-commit hook) and touches no device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import types

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS = os.path.join(_PKG, "analysis")


def _load_analysis_modules():
    """The analysis trio (findings -> purity -> concurrency) under their
    full dotted names WITHOUT importing ``apex_tpu_torch.analysis``
    (whose ``__init__`` pulls torch).  A stub package module holds the
    namespace; the leaf modules are the real files, so the lazy
    ``from apex_tpu_torch.analysis.findings import make_finding`` inside
    the passes resolves against exactly what was loaded.  Returns the
    three modules and the ``sys.modules`` names this call added."""
    added = []
    for pkg, path in (("apex_tpu_torch", _PKG),
                      ("apex_tpu_torch.analysis", _ANALYSIS)):
        if pkg not in sys.modules:
            mod = types.ModuleType(pkg)
            mod.__path__ = [path]  # mark as package
            sys.modules[pkg] = mod
            added.append(pkg)
    loaded = {}
    for name in ("findings", "purity", "concurrency"):
        dotted = f"apex_tpu_torch.analysis.{name}"
        if dotted in sys.modules:
            loaded[name] = sys.modules[dotted]
            continue
        spec = importlib.util.spec_from_file_location(
            dotted, os.path.join(_ANALYSIS, f"{name}.py")
        )
        mod = importlib.util.module_from_spec(spec)
        sys.modules[dotted] = mod
        added.append(dotted)
        spec.loader.exec_module(mod)
        loaded[name] = mod
    return loaded["findings"], loaded["purity"], loaded["concurrency"], added


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="host-side concurrency + replay-purity static lint"
    )
    ap.add_argument("--root", default=None, metavar="DIR",
                    help="package directory to lint (default: the "
                    "repo's apex_tpu_torch/)")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="write the report as one JSON object")
    ap.add_argument("--fail-on", choices=["error", "warning"],
                    default="error")
    args = ap.parse_args(argv)

    findings_mod, purity, concurrency, added = _load_analysis_modules()
    try:
        root = args.root or _PKG
        sources = purity.collect_sources(root)
        found = []
        found.extend(concurrency.lint_sources(sources))
        found.extend(purity.lint_sources(sources))
        found.sort(key=lambda f: (f.path, f.rule))

        report = findings_mod.Report(
            target=os.path.basename(os.path.normpath(root)),
            findings=found,
            rules_run=("concurrency", "purity"),
        )
        report.sections["files_scanned"] = len(sources)
    finally:
        # leave no stub behind for a later import in this process
        for name in reversed(added):
            sys.modules.pop(name, None)

    print(report.render())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"report: {args.json}")

    return 0 if report.ok(fail_on=args.fail_on) else 1


if __name__ == "__main__":
    sys.exit(main())

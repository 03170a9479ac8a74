"""Repo lint: the source-level complement of the graph lint, over
``apex_tpu_torch/``.

Counterpart of ``tools/repo_lint.py``, with its rule structure and its
printed lines.  Some defects are cheaper to catch at the source line than
in a recorded step:

- **step paths** (:data:`JITTED_PATHS`, the reference's list: code that
  runs inside a training or serving step, and so inside the CUDA graphs
  the decode step and the speculative round capture):

  - ``time.time()`` / ``datetime.now``: a graph replays the value read
    at capture, as a traced step bakes in the value read at trace time;
  - ``torch.float64`` / ``torch.double`` / ``.double()``: the card's
    f64 rate is a small fraction of its f32 rate (the recorded step's
    ``promotion-f64`` rule catches the consequence, this the source);

- **host syncs**, everywhere but :data:`HOST_SIDE` (``observability/``,
  ``checkpoint/``, ``tools/``, ``analysis/``): ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()`` block the host until the card drains its
  queue, as the reference's bare ``jax.device_get`` does;
- ``kernel-hardcoded-block`` on step paths: a literal ``block_rows=`` (or
  ``block_q=`` / ``block_k=``), or a literal tile define
  (``APEX_FLASH_FWD_BLOCK_K=64``) at a call site bypasses the tuning
  cache (``APEX_TPU_TUNE_CACHE``);
- ``replay-wall-clock``: wall clocks in the replay-critical modules,
  whose list and patterns are :mod:`apex_tpu_torch.analysis.purity`'s
  (``REPLAY_CRITICAL``, ``WALL_CLOCK_PATTERNS``).

The reference's sharding rules (``in_shardings=None`` and a missing
``with_sharding_constraint`` at ``pjit``/``shard_map`` call sites) have no
PyTorch call site: the port shards by hand through its process groups,
and the trainer holds each shard to its rule table at build.

A line carrying ``repo-lint: allow`` is waived, and ``# lint:
allow(<rule>): <reason>`` waives that rule on its line (the rules'
names: ``step-wall-clock``, ``step-f64``, ``host-sync``,
``kernel-hardcoded-block``, ``replay-wall-clock``); give the reason in
the line's comment.  The scan reads the source only (the rule catalog
and the purity constants are loaded from their files, no ``torch``)::

    python -m apex_tpu_torch.tools.repo_lint [--root PKG_DIR]

``--device`` (``cuda`` by default, like every tool of the port) is
checked for a card before the scan; ``--device cpu`` scans without one.
Exit code: 0 clean, 1 on any violation, 2 no CUDA device.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

from apex_tpu_torch.tools.concurrency_lint import _load_analysis_modules

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: packages whose code runs (at least partly) inside a step — wall clocks
#: and f64 literals are banned here (the reference's list)
JITTED_PATHS = (
    "ops", "models", "optimizers", "parallel", "transformer", "amp",
    "contrib", "mlp", "fused_dense", "RNN", "multi_tensor_apply",
    "reparameterization", "fp16_utils", "normalization",
)

#: (rule, regex, why, fix) applied only under JITTED_PATHS
JITTED_RULES = (
    ("step-wall-clock", re.compile(r"\btime\.time\(\)"),
     "wall clock in a step path freezes when a CUDA graph captures it",
     "hoist to the host loop or observability.MetricRegistry.timing"),
    ("step-wall-clock", re.compile(r"\bdatetime\.now\b"),
     "wall clock in a step path freezes when a CUDA graph captures it",
     "hoist to the host loop"),
    ("step-f64",
     re.compile(r"\btorch\.(?:float64|double)\b|\.double\(\)"),
     "f64 literal in a step path (the card's f64 rate is a fraction of "
     "its f32 rate; see analysis rule promotion-f64)",
     "use float32 or the amp policy's compute dtype"),
)

#: the host-side subsystems, where a host sync is their job
HOST_SIDE = ("observability" + os.sep, "checkpoint" + os.sep,
             "tools" + os.sep, "analysis" + os.sep)

#: (rule, regex, why, fix, allowed path fragments) applied everywhere
GLOBAL_RULES = (
    ("host-sync", re.compile(r"\.(?:item|cpu|tolist|numpy)\(\)"),
     "a device->host read (.item()/.cpu()/.tolist()/.numpy()) blocks the "
     "host until the card drains its queue",
     "keep the value on the card, or fetch it through "
     "observability.MetricRegistry (async, on a cadence)",
     HOST_SIDE),
)

WAIVER = "repo-lint: allow"

#: literal tile sizes at kernel call sites: block_rows=64 / block_q=128 /
#: block_k_dq=... with a DIGIT on the right-hand side, or a tile define
#: with a literal value (variable plumbing and None defaults never match)
_HARDCODED_BLOCK_RE = re.compile(
    r"\bblock_(?:rows|[qk](?:_dq)?)\s*=\s*\d"
    r"|\bAPEX_[A-Z0-9_]*(?:BLOCK|STAGES|TILE)[A-Z0-9_]*=\d")

_MODULES = None


def _analysis():
    """``(RULES, purity)``: the rule catalog and the purity pass's
    constants, loaded standalone from their files (stdlib only)."""
    global _MODULES
    if _MODULES is None:
        findings, purity, _, added = _load_analysis_modules()
        for name in reversed(added):
            sys.modules.pop(name, None)
        _MODULES = (findings.RULES, purity)
    return _MODULES


def _waived(line: str, rule: str, waiver_re) -> bool:
    if WAIVER in line:
        return True
    m = waiver_re.search(line)
    return m is not None and m.group(1) == rule


def _kernel_violations(rel: str, lines, jitted: bool):
    """Rule ``kernel-hardcoded-block`` over one file's lines."""
    if not jitted:
        return []
    catalog, purity = _analysis()
    out = []
    for lineno, line in enumerate(lines, 1):
        if line.lstrip().startswith("#") or _waived(
                line, "kernel-hardcoded-block", purity.WAIVER_RE):
            continue
        if _HARDCODED_BLOCK_RE.search(line):
            _sev, why, fix = catalog["kernel-hardcoded-block"]
            out.append((rel, lineno, line.strip(), why, fix))
    return out


def _replay_clock_violations(rel: str, lines):
    """Wall clocks in the replay-critical modules (rule
    ``replay-wall-clock``): which modules, and what counts as a wall
    clock, come from the purity pass."""
    catalog, purity = _analysis()
    if not purity.is_replay_critical(rel.replace(os.sep, "/")):
        return []
    patterns = [re.compile(p) for p in purity.WALL_CLOCK_PATTERNS]
    out = []
    for lineno, line in enumerate(lines, 1):
        if line.lstrip().startswith("#") or _waived(
                line, "replay-wall-clock", purity.WAIVER_RE):
            continue
        if any(rx.search(line) for rx in patterns):
            _sev, why, fix = catalog["replay-wall-clock"]
            out.append((rel, lineno, line.strip(), why, fix))
    return out


def _iter_sources(root: str = PKG):
    for base, dirs, files in os.walk(root):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for fn in sorted(files):
            if fn.endswith(".py"):
                yield os.path.join(base, fn)


def lint(root: str = PKG) -> list:
    """``[(path relative to root, line number, line, why, fix), ...]``."""
    _, purity = _analysis()
    violations = []
    for path in _iter_sources(root):
        rel = os.path.relpath(path, root)
        top = rel.split(os.sep, 1)[0]
        jitted = top in JITTED_PATHS
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
        for lineno, line in enumerate(lines, 1):
            if WAIVER in line:
                continue
            if jitted:
                for rule, rx, why, fix in JITTED_RULES:
                    if rx.search(line) and not _waived(line, rule,
                                                       purity.WAIVER_RE):
                        violations.append(
                            (rel, lineno, line.strip(), why, fix))
            for rule, rx, why, fix, allowed in GLOBAL_RULES:
                if any(a in rel for a in allowed):
                    continue
                if rx.search(line) and not _waived(line, rule,
                                                   purity.WAIVER_RE):
                    violations.append(
                        (rel, lineno, line.strip(), why, fix))
        violations.extend(_kernel_violations(rel, lines, jitted))
        violations.extend(_replay_clock_violations(rel, lines))
    return violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=PKG, metavar="DIR",
                    help="package directory to scan (default: the "
                    "repo's apex_tpu_torch/)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: a card must be present) or cpu")
    args = ap.parse_args(argv)
    if args.device != "cpu":
        import torch

        if not torch.cuda.is_available():
            print("repo lint: no CUDA device is available; pass --device "
                  "cpu to scan without one", file=sys.stderr)
            return 2
    violations = lint(args.root)
    if not violations:
        print(f"repo lint: apex_tpu_torch/ clean "
              f"({len(list(_iter_sources(args.root)))} files)")
        return 0
    print(f"repo lint: {len(violations)} violation(s)")
    for rel, lineno, text, why, fix in violations:
        print(f"  apex_tpu_torch/{rel}:{lineno}: {why}\n"
              f"    {text}\n"
              f"    fix: {fix}")
    return 1


if __name__ == "__main__":
    sys.exit(main())

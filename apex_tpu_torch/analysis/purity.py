"""Replay-purity pass — source-level determinism lint for the host side.

Counterpart of ``apex_tpu/analysis/purity.py``.  The serving, goodput
and fleet drills rest on **bit-identical replay**: the same request
stream, chaos storm or fleet drill must give the same decisions, the
same losses and the same timeline on every run.  This pass proves the
host half of that at the source line, before anything runs, by walking
the AST of the declared replay-critical modules (:data:`REPLAY_CRITICAL`)
and flagging the four ways host code picks up run-to-run-varying state:

- ``replay-wall-clock`` — ``time.time()`` / ``datetime.now()`` where
  only ``time.monotonic`` or the drills' virtual clock are legal;
- ``replay-unseeded-rng`` — module-level ``random.*`` /
  ``np.random.*`` draws from hidden global RNG state (seeded generator
  objects pass; a ``torch.Generator`` is an object, not a module call);
- ``replay-set-order`` — iteration over a ``set`` feeding scheduling or
  ordering decisions (hash-seed dependent order);
- ``replay-env-read`` — ``os.environ`` reads inside step/tick bodies
  (construction-time reads — ``__init__`` / ``from_env`` /
  ``resolve_*`` — are configuration, and pass).

An audited site is waived in line with
``# lint: allow(<rule-id>): <reason>`` on the offending line; the
reason is mandatory by convention.

The module is stdlib-only at module level (the findings are imported
inside the functions), so a tool can load it standalone.  The graph
form (:func:`purity_pass`) runs over a
:class:`~apex_tpu_torch.analysis.passes.StepGraph`'s ``sources``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import List, Optional, Set, Tuple

__all__ = [
    "REPLAY_CRITICAL",
    "WALL_CLOCK_PATTERNS",
    "WAIVER_RE",
    "is_replay_critical",
    "collect_sources",
    "lint_source",
    "lint_sources",
    "purity_pass",
]

#: replay-critical module prefixes, relative to the package root
#: (``apex_tpu_torch/``), "/"-separated.  A prefix ending in "/" covers
#: the whole subpackage.  The port's counterparts of the reference's:
#: ``serve/``, ``goodput/stream.py``, ``resilience/runner.py`` and
#: ``fleetctl/``.
REPLAY_CRITICAL: Tuple[str, ...] = (
    "serve/",
    "goodput/stream.py",
    "resilience/runner.py",
    "fleetctl/",
)

#: the source-level wall-clock fingerprints, for a line-regex scan of
#: the same modules (the AST walk below is the authoritative detector)
WALL_CLOCK_PATTERNS: Tuple[str, ...] = (
    r"\btime\.time\(\)",
    r"\bdatetime\.(?:now|utcnow|today)\b",
)

#: ``# lint: allow(rule-id): reason`` waives that rule on that line
WAIVER_RE = re.compile(r"lint:\s*allow\(([a-z0-9-]+)\)")

#: wall-clock dotted calls (resolved through plain-name attribute
#: chains; ``time.monotonic`` / ``time.perf_counter`` are the legal
#: duration clocks and never match)
_WALL_CLOCK_CALLS = {
    "time.time",
    "datetime.now",
    "datetime.utcnow",
    "datetime.today",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "datetime.datetime.today",
}

#: np.random constructors that yield SEEDED generator objects — calls
#: THROUGH these are fine, calls to any other np.random.* function hit
#: the hidden global RNG
_SEEDED_NP_CTORS = {
    "default_rng",
    "RandomState",
    "Generator",
    "SeedSequence",
    "Philox",
    "PCG64",
    "PCG64DXSM",
    "MT19937",
}

#: random-module names that are seeded-object constructors, not draws
_SEEDED_RANDOM_CTORS = {"Random", "SystemRandom", "seed"}

#: enclosing-function shapes where an os.environ read is construction-
#: time configuration, not a per-step dependency
_ENV_OK_FUNCS = ("__init__", "from_env", "main")
_ENV_OK_PREFIXES = ("resolve", "_resolve")


def is_replay_critical(rel: str) -> bool:
    """True when ``rel`` (package-relative path, either separator) is
    inside a :data:`REPLAY_CRITICAL` prefix."""
    rel = rel.replace(os.sep, "/")
    return any(
        rel == p or (p.endswith("/") and rel.startswith(p))
        for p in REPLAY_CRITICAL
    )


def collect_sources(
    root: Optional[str] = None, only_replay: bool = False,
) -> List[Tuple[str, str]]:
    """``[(package-relative path, source text), ...]`` for every ``.py``
    under the package (``apex_tpu_torch/`` unless ``root`` is given) —
    what both source passes walk.  ``only_replay=True`` keeps just the
    :data:`REPLAY_CRITICAL` files."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            if only_replay and not is_replay_critical(rel):
                continue
            with open(path, encoding="utf-8") as f:
                out.append((rel, f.read()))
    return out


def _finding(rule: str, rel: str, lineno: int, message: str):
    # lazy: keeps this module loadable standalone (no package import)
    from apex_tpu_torch.analysis.findings import make_finding

    return make_finding(rule, f"apex_tpu_torch/{rel}:{lineno}", message)


def _waived(lines: List[str], lineno: int, rule: str) -> bool:
    if not 1 <= lineno <= len(lines):
        return False
    return rule in WAIVER_RE.findall(lines[lineno - 1])


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a plain Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_set_expr(node: ast.AST, set_names: Set[str]) -> bool:
    if isinstance(node, ast.Set):
        return True
    if isinstance(node, ast.Call):
        fn = _dotted(node.func)
        return fn in ("set", "frozenset")
    name = _dotted(node)
    return name is not None and name in set_names


class _PurityVisitor(ast.NodeVisitor):
    def __init__(self, rel: str, lines: List[str]):
        self.rel = rel
        self.lines = lines
        self.findings: list = []
        #: names statically known to hold a set in the current scope
        #: (locals assigned set()/``{...}``; ``self.x = set()`` anywhere
        #: in the file contributes ``self.x``)
        self.set_names: Set[str] = set()
        self.func_stack: List[str] = []

    # -- helpers -----------------------------------------------------------
    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        if _waived(self.lines, node.lineno, rule):
            return
        self.findings.append(
            _finding(rule, self.rel, node.lineno, message)
        )

    def _env_context_ok(self) -> bool:
        if not self.func_stack:
            return True  # module level = import-time configuration
        name = self.func_stack[-1]
        return (
            name in _ENV_OK_FUNCS
            or name.startswith(_ENV_OK_PREFIXES)
            or "env" in name
        )

    # -- scope tracking ----------------------------------------------------
    def visit_FunctionDef(self, node):
        self.func_stack.append(node.name)
        outer = set(self.set_names)
        self.generic_visit(node)
        # locals die with the scope; self.* survive (prefixed names)
        self.set_names = outer | {
            n for n in self.set_names if "." in n
        }
        self.func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node):
        for tgt in node.targets:
            name = _dotted(tgt)
            if name is None:
                continue
            if _is_set_expr(node.value, self.set_names):
                self.set_names.add(name)
            else:
                self.set_names.discard(name)
        self.generic_visit(node)

    # -- the rules ---------------------------------------------------------
    def visit_Call(self, node):
        fn = _dotted(node.func)
        if fn:
            if fn in _WALL_CLOCK_CALLS:
                self._emit(
                    "replay-wall-clock", node,
                    f"wall-clock read '{fn}()' in replay-critical "
                    f"module apex_tpu_torch/{self.rel} — only time.monotonic"
                    "/the virtual clock are replay-pure",
                )
            self._check_rng(fn, node)
            if fn in ("os.getenv", "os.environ.get"):
                self._check_env(fn, node)
        self.generic_visit(node)

    def _check_rng(self, fn: str, node: ast.Call) -> None:
        parts = fn.split(".")
        if parts[0] == "random" and len(parts) == 2:
            if parts[1] not in _SEEDED_RANDOM_CTORS:
                self._emit(
                    "replay-unseeded-rng", node,
                    f"'{fn}()' draws from the module-level RNG — "
                    "hidden global state breaks bit-identical replay",
                )
        elif (
            len(parts) == 3
            and parts[0] in ("np", "numpy")
            and parts[1] == "random"
            and parts[2] not in _SEEDED_NP_CTORS
        ):
            self._emit(
                "replay-unseeded-rng", node,
                f"'{fn}()' draws from numpy's global RNG — thread a "
                "seeded default_rng(seed) generator instead",
            )

    def _check_env(self, fn: str, node: ast.AST) -> None:
        if self._env_context_ok():
            return
        self._emit(
            "replay-env-read", node,
            f"os.environ read ('{fn}') inside "
            f"'{self.func_stack[-1]}' — per-step env reads make "
            "replay depend on live process state",
        )

    def visit_Subscript(self, node):
        if _dotted(node.value) == "os.environ":
            self._check_env("os.environ[...]", node)
        self.generic_visit(node)

    def _check_iter(self, iter_node: ast.AST) -> None:
        if _is_set_expr(iter_node, self.set_names):
            what = _dotted(iter_node) or "a set expression"
            self._emit(
                "replay-set-order", iter_node,
                f"iteration over set '{what}' — hash-seed-dependent "
                "order feeding host logic in a replay-critical module",
            )

    def visit_For(self, node):
        self._check_iter(node.iter)
        self.generic_visit(node)

    visit_AsyncFor = visit_For

    def visit_comprehension(self, node):
        self._check_iter(node.iter)
        self.generic_visit(node)


def _collect_self_sets(tree: ast.AST) -> Set[str]:
    """``self.x`` names assigned a set anywhere in the file — a set
    attribute built in ``__init__`` and iterated in ``step()`` must
    still flag, so attribute set-ness is file-global."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                name = _dotted(tgt)
                if name and name.startswith("self.") and _is_set_expr(
                    node.value, set()
                ):
                    names.add(name)
    return names


def lint_source(src: str, rel: str) -> list:
    """Purity findings for one replay-critical module's source text.
    ``rel`` is the package-relative path (used for the finding path and
    the :func:`is_replay_critical` gate — a non-critical path returns
    no findings)."""
    if not is_replay_critical(rel):
        return []
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [_finding(
            "replay-wall-clock", rel, e.lineno or 0,
            f"unparseable replay-critical module: {e.msg}",
        )]
    visitor = _PurityVisitor(rel, src.splitlines())
    visitor.set_names |= _collect_self_sets(tree)
    visitor.visit(tree)
    return visitor.findings


def lint_sources(sources) -> list:
    """Findings over ``[(rel, src), ...]`` (only replay-critical
    entries contribute)."""
    out = []
    for rel, src in sources:
        out.extend(lint_source(src, rel))
    return out


def purity_pass(graph) -> list:
    """The pass over a :class:`~.passes.StepGraph`'s ``sources``
    (registered in :data:`.passes.PASSES`; quiet without them)."""
    if getattr(graph, "sources", None) is None:
        return []
    return lint_sources(graph.sources)

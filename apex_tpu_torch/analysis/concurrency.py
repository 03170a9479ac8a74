"""Lock-discipline pass — static race/deadlock lint for threaded classes.

Counterpart of ``apex_tpu/analysis/concurrency.py``.  Several classes
of the port run real threads (the ``AsyncCheckpointEngine`` writer, the
``DevicePrefetcher`` worker, the observability servers) and share plain
attributes with the main path.  The GIL makes single bytecodes atomic
and nothing else: ``self.n += 1`` from two threads loses increments,
and a multi-field update observed half-done is a torn read.  This pass
proves lock discipline at the source, per class:

1. **thread entrypoints** — ``threading.Thread(target=self._m)``
   targets, plus ``http.server``-style nested handler classes calling
   methods through a ``name = self`` alias, mark methods as thread
   bodies;
2. **a lightweight call graph** — ``self.m()`` edges close thread- and
   main-reachability over the class (main entry points are the public
   and dunder methods; ``__init__`` is construction, before the object
   is shared, and never counts as a mutation site);
3. **attribute census** — every ``self.x`` read/write per method, with
   ``with self._lock:`` nesting tracked (any attribute constructed as
   ``threading.Lock/RLock/Condition`` or ``TrackedLock`` counts, as
   does any ``self.*lock*`` name), read-modify-write shape
   (``+=`` / ``x = x op ...``) noted, and simple local aliases
   (``st = self._stats; st[k] += 1``) resolved back to the attribute.

An attribute reachable from both a thread body and the main path with
an unlocked write (outside ``__init__``) is ``race-unlocked-shared-
state``; when every offending write is a read-modify-write it is the
sharper ``race-nonatomic-counter``.  A ``with self.<lock>:`` region in
a main-path method that calls a blocking hand-off (``.put()`` /
``.join()`` / ``.result()``) while some thread body acquires the same
lock is the two-party deadlock shape, ``race-lock-across-blocking``.

Only classes that start threads are judged.  Waive an audited site with
``# lint: allow(<rule-id>): <reason>`` on the line of the flagged write
(the purity pass's syntax).  The runtime counterpart is
:class:`apex_tpu_torch.observability.TrackedLock`.  The module is
stdlib-only at module level; the graph form (:func:`concurrency_pass`)
runs over a :class:`~apex_tpu_torch.analysis.passes.StepGraph`'s
``sources``.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "LOCK_CTORS",
    "BLOCKING_CALLS",
    "analyze_class",
    "lint_source",
    "lint_sources",
    "concurrency_pass",
]

#: constructor names whose assignment marks an attribute as a lock
LOCK_CTORS = {
    "Lock", "RLock", "Condition",
    "threading.Lock", "threading.RLock", "threading.Condition",
    "TrackedLock",
}

#: method names whose call is a blocking hand-off when made under a
#: held lock (bounded-queue put, queue/thread join, future result)
BLOCKING_CALLS = {"put", "join", "result"}

from apex_tpu_torch.analysis.purity import WAIVER_RE, _dotted  # noqa: E402
# (purity is stdlib-only at module level)


def _lazy_finding(rule: str, rel: str, lineno: int, message: str):
    from apex_tpu_torch.analysis.findings import make_finding

    return make_finding(rule, f"apex_tpu_torch/{rel}:{lineno}", message)


@dataclasses.dataclass
class _Write:
    attr: str
    lineno: int
    locked: bool
    rmw: bool


@dataclasses.dataclass
class _Method:
    name: str
    writes: List[_Write] = dataclasses.field(default_factory=list)
    reads: Set[str] = dataclasses.field(default_factory=set)
    calls: Set[str] = dataclasses.field(default_factory=set)
    #: lock attrs this method acquires (with-block or .acquire())
    locks_used: Set[str] = dataclasses.field(default_factory=set)
    #: (lock attr, call text, lineno) — blocking calls under a lock
    blocking_under_lock: List[Tuple[str, str, int]] = dataclasses.field(
        default_factory=list
    )
    thread_entry: bool = False


def _call_name(node: ast.Call) -> Optional[str]:
    return _dotted(node.func)


def _is_lock_ctor(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    name = _call_name(value)
    return name is not None and (
        name in LOCK_CTORS or name.split(".")[-1] in LOCK_CTORS
    )


class _MethodVisitor(ast.NodeVisitor):
    """One method's attribute census, with lock nesting and aliasing."""

    def __init__(self, cls: "_ClassModel", method: _Method):
        self.cls = cls
        self.m = method
        self.lock_depth: List[str] = []  # stack of held lock attrs
        #: local name -> attr it aliases (``st = self._stats``)
        self.aliases: Dict[str, str] = {}
        #: local names bound to ``self`` (``ops = self``) — the
        #: http.server nested-handler discovery hook
        self.self_aliases: Set[str] = {"self"}

    # -- lock nesting ------------------------------------------------------
    def _lock_attr_of(self, expr: ast.AST) -> Optional[str]:
        name = _dotted(expr)
        if name is None:
            return None
        parts = name.split(".")
        if len(parts) != 2 or parts[0] not in self.self_aliases:
            return None
        attr = parts[1]
        if attr in self.cls.lock_attrs or "lock" in attr.lower():
            return attr
        return None

    def visit_With(self, node):
        held = []
        for item in node.items:
            attr = self._lock_attr_of(item.context_expr)
            if attr is not None:
                held.append(attr)
                self.m.locks_used.add(attr)
        self.lock_depth.extend(held)
        for stmt in node.body:
            self.visit(stmt)
        for _ in held:
            self.lock_depth.pop()

    visit_AsyncWith = visit_With

    # -- writes/reads ------------------------------------------------------
    def _self_attr(
        self, node: ast.AST, for_write: bool = False,
    ) -> Optional[str]:
        """``self.x`` (or through a self-alias / a recorded local
        alias) -> attribute name, else None.  Subscripts resolve to
        their base (``self.x[k]`` mutates ``x``).  For writes, a bare
        local name never counts (rebinding ``st`` is not a write to
        ``self._stats``) — only subscripted aliases mutate through."""
        subscripted = False
        while isinstance(node, ast.Subscript):
            subscripted = True
            node = node.value
        if isinstance(node, ast.Attribute) and isinstance(
            node.value, ast.Name
        ) and node.value.id in self.self_aliases:
            return node.attr
        if isinstance(node, ast.Name):
            if for_write and not subscripted:
                return None
            return self.aliases.get(node.id)
        return None

    def _record_write(self, target: ast.AST, lineno: int, rmw: bool):
        attr = self._self_attr(target, for_write=True)
        if attr is None:
            return
        self.m.writes.append(_Write(
            attr=attr, lineno=lineno, locked=bool(self.lock_depth),
            rmw=rmw,
        ))

    def visit_Assign(self, node):
        # alias tracking first: ``st = self._stats`` / ``ops = self``
        if len(node.targets) == 1 and isinstance(
            node.targets[0], ast.Name
        ):
            local = node.targets[0].id
            if isinstance(node.value, ast.Name) and \
                    node.value.id in self.self_aliases:
                self.self_aliases.add(local)
            else:
                src_attr = self._self_attr(node.value) if isinstance(
                    node.value, ast.Attribute
                ) else None
                if src_attr is not None:
                    self.aliases[local] = src_attr
                else:
                    self.aliases.pop(local, None)
        for tgt in node.targets:
            attr = self._self_attr(tgt, for_write=True)
            if attr is None:
                continue
            # x = self.x + 1 is a read-modify-write in assign clothing
            reads_self = any(
                self._self_attr(n) == attr
                for n in ast.walk(node.value)
                if isinstance(n, (ast.Attribute, ast.Subscript))
            )
            self._record_write(tgt, node.lineno, rmw=reads_self)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._record_write(node.target, node.lineno, rmw=True)
        self.generic_visit(node)

    def visit_Attribute(self, node):
        if isinstance(node.value, ast.Name) and \
                node.value.id in self.self_aliases:
            self.m.reads.add(node.attr)
        self.generic_visit(node)

    # -- calls -------------------------------------------------------------
    def visit_Call(self, node):
        name = _call_name(node)
        if name is not None:
            parts = name.split(".")
            if len(parts) == 2 and parts[0] in self.self_aliases:
                self.m.calls.add(parts[1])
            # thread entry: threading.Thread(target=self._m)
            if parts[-1] == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        tname = _dotted(kw.value)
                        tparts = (tname or "").split(".")
                        if len(tparts) == 2 and \
                                tparts[0] in self.self_aliases:
                            self.cls.thread_targets.add(tparts[1])
            # self.<lock>.acquire() counts as using the lock
            if parts[-1] == "acquire" and len(parts) == 3 and \
                    parts[0] in self.self_aliases:
                lk = parts[1]
                if lk in self.cls.lock_attrs or "lock" in lk.lower():
                    self.m.locks_used.add(lk)
            # blocking hand-off under a held lock
            if parts[-1] in BLOCKING_CALLS and self.lock_depth:
                self.m.blocking_under_lock.append(
                    (self.lock_depth[-1], name, node.lineno)
                )
        self.generic_visit(node)

    # -- nested defs/classes -----------------------------------------------
    def visit_FunctionDef(self, node):
        # a closure inside the method: same thread context, keep
        # walking (e.g. a helper defined in save())
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        # the http.server shape: a handler class nested in a method,
        # whose methods run on SERVER threads and reach back through a
        # ``name = self`` alias — every ``alias.m()`` call inside it
        # marks ``m`` as a thread entrypoint
        outer_aliases = self.self_aliases - {"self"}
        if not outer_aliases:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = _call_name(sub)
                if name is None:
                    continue
                parts = name.split(".")
                if len(parts) == 2 and parts[0] in outer_aliases:
                    self.cls.thread_targets.add(parts[1])


class _ClassModel:
    def __init__(self, node: ast.ClassDef, rel: str, lines: List[str]):
        self.name = node.name
        self.rel = rel
        self.lines = lines
        self.lock_attrs: Set[str] = set()
        self.thread_targets: Set[str] = set()
        self.methods: Dict[str, _Method] = {}
        self._node = node

    def build(self) -> "_ClassModel":
        # pass 1: lock attributes (any method may create one)
        for sub in ast.walk(self._node):
            if isinstance(sub, ast.Assign) and _is_lock_ctor(sub.value):
                for tgt in sub.targets:
                    name = _dotted(tgt)
                    if name and name.startswith("self."):
                        self.lock_attrs.add(name.split(".", 1)[1])
        # pass 2: per-method census (also discovers thread targets)
        for stmt in self._node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                m = _Method(name=stmt.name)
                self.methods[stmt.name] = m
                _MethodVisitor(self, m).visit(stmt)
        for tname in self.thread_targets:
            if tname in self.methods:
                self.methods[tname].thread_entry = True
        return self

    # -- reachability ------------------------------------------------------
    def _closure(self, seeds: Set[str]) -> Set[str]:
        out, frontier = set(seeds), list(seeds)
        while frontier:
            m = self.methods.get(frontier.pop())
            if m is None:
                continue
            for callee in m.calls:
                if callee in self.methods and callee not in out:
                    out.add(callee)
                    frontier.append(callee)
        return out

    def thread_reachable(self) -> Set[str]:
        return self._closure({
            n for n, m in self.methods.items() if m.thread_entry
        })

    def main_reachable(self) -> Set[str]:
        # main entry points: public methods and dunders (the API the
        # constructing thread calls); private helpers join via the
        # call-graph closure.  __init__ runs before the object is
        # shared, so its writes never count — but it IS main path for
        # reachability of what it calls.
        seeds = {
            n for n in self.methods
            if not n.startswith("_")
            or (n.startswith("__") and n.endswith("__"))
        }
        return self._closure(seeds)

    # -- judgement ---------------------------------------------------------
    def findings(self) -> list:
        if not any(m.thread_entry for m in self.methods.values()):
            return []
        threaded = self.thread_reachable()
        mainside = self.main_reachable()
        out = []
        out.extend(self._race_findings(threaded, mainside))
        out.extend(self._blocking_findings(threaded, mainside))
        return out

    def _accesses(self, attr: str, methods: Set[str]) -> bool:
        for name in methods:
            m = self.methods[name]
            if name != "__init__" and (
                attr in m.reads
                or any(w.attr == attr for w in m.writes)
            ):
                return True
        return False

    def _waived(self, lineno: int, rule: str) -> bool:
        if not 1 <= lineno <= len(self.lines):
            return False
        return rule in WAIVER_RE.findall(self.lines[lineno - 1])

    def _race_findings(self, threaded, mainside) -> list:
        # attr -> unlocked writes outside __init__
        unlocked: Dict[str, List[Tuple[str, _Write]]] = {}
        for name, m in self.methods.items():
            if name == "__init__":
                continue
            for w in m.writes:
                if not w.locked and w.attr not in self.lock_attrs:
                    unlocked.setdefault(w.attr, []).append((name, w))
        out = []
        for attr in sorted(unlocked):
            if not (
                self._accesses(attr, threaded)
                and self._accesses(attr, mainside)
            ):
                continue
            sites = unlocked[attr]
            if all(self._waived(w.lineno, "race-nonatomic-counter")
                   or self._waived(w.lineno, "race-unlocked-shared-state")
                   for _, w in sites):
                continue
            all_rmw = all(w.rmw for _, w in sites)
            rule = (
                "race-nonatomic-counter" if all_rmw
                else "race-unlocked-shared-state"
            )
            where = ", ".join(
                f"{n}():{w.lineno}" for n, w in sites[:4]
            ) + ("..." if len(sites) > 4 else "")
            t_entry = sorted(
                n for n, m in self.methods.items() if m.thread_entry
            )
            out.append(_lazy_finding(
                rule, self.rel, sites[0][1].lineno,
                f"{self.name}.{attr} is written without a lock at "
                f"{where} but is reachable from both the thread "
                f"body ({'/'.join(t_entry)}) and the main path"
                + (" (read-modify-write)" if all_rmw else ""),
            ))
        return out

    def _blocking_findings(self, threaded, mainside) -> list:
        # locks the thread side needs to make progress
        consumer_locks: Set[str] = set()
        for name in threaded:
            consumer_locks |= self.methods[name].locks_used
        out = []
        for name in sorted(mainside):
            for lock, call, lineno in \
                    self.methods[name].blocking_under_lock:
                if lock not in consumer_locks:
                    continue
                if self._waived(lineno, "race-lock-across-blocking"):
                    continue
                out.append(_lazy_finding(
                    "race-lock-across-blocking", self.rel, lineno,
                    f"{self.name}.{name}() holds self.{lock} across "
                    f"blocking '{call}()' while the thread side also "
                    f"acquires self.{lock} — a wedged consumer "
                    "deadlocks the holder",
                ))
        return out


def analyze_class(node: ast.ClassDef, rel: str, lines: List[str]) -> list:
    return _ClassModel(node, rel, lines).build().findings()


def lint_source(src: str, rel: str) -> list:
    """Lock-discipline findings for one module's source text."""
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return []
    lines = src.splitlines()
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            out.extend(analyze_class(node, rel, lines))
    return out


def lint_sources(sources) -> list:
    """Findings over ``[(rel, src), ...]`` — every module, every
    class; single-threaded classes judge to zero by construction."""
    out = []
    for rel, src in sources:
        out.extend(lint_source(src, rel))
    return out


def concurrency_pass(graph) -> list:
    """The pass over a :class:`~.passes.StepGraph`'s ``sources``
    (registered in :data:`.passes.PASSES`; quiet without them)."""
    if getattr(graph, "sources", None) is None:
        return []
    return lint_sources(graph.sources)

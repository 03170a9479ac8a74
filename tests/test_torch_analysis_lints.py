"""apex_tpu_torch.analysis's source lints, findings and retrace sentinel
vs the JAX package's.

- the rule catalog: every rule id of the reference with its severity
  and hint, ``make_finding``'s refusal of an uncataloged id, and
  ``Report``'s surface (``ok``, ``deduped``, ``merge``, ``counts``,
  ``to_json``, ``render``) on the same findings;
- every planted-source case of ``tests/test_concurrency_analysis.py``
  (the lock-discipline and replay-purity rules, their clean twins and
  waivers), the same source string fed to both packages'
  ``lint_source``: the same rule ids at the same lines, the port's paths
  under ``apex_tpu_torch/``;
- ``REPLAY_CRITICAL`` and ``is_replay_critical``; ``collect_sources``
  over the port; the graph forms refuse, naming ROADMAP item 9;
- the port's own tree lints clean (no finding at all, so no waiver is
  doing the work), and a wall-clock read planted into a copy of
  ``serve/engine.py``'s source is caught at its line;
- ``RetraceSentinel`` against the reference's on the same sequence of
  shapes, dtypes, tree structures and static values: the same
  verdicts, signature counts, retraces and differing leaves.
"""

import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.analysis import concurrency as jconc
from apex_tpu.analysis import findings as jfind
from apex_tpu.analysis import purity as jpure
from apex_tpu.analysis import retrace as jretrace
from apex_tpu_torch.analysis import concurrency, findings, purity, retrace

# ---------------------------------------------------------------------------
# the catalog and the report
# ---------------------------------------------------------------------------


def test_rule_catalog_is_the_references():
    assert list(findings.RULES) == list(jfind.RULES)
    for rule, (sev, _, hint) in jfind.RULES.items():
        assert findings.RULES[rule][0] == sev
        assert findings.RULES[rule][2] == hint
    with pytest.raises(KeyError):
        findings.make_finding("not-a-rule", "x", "y")


def _both_findings(mod):
    return [
        mod.make_finding("retrace", "step call #2", "changed"),
        mod.make_finding("replay-set-order", "a.py:3", "set",
                         severity=mod.WARNING),
        mod.make_finding("retrace", "step call #2", "again"),
        mod.make_finding("race-nonatomic-counter", "b.py:9", "n += 1",
                         hint="lock it"),
    ]


def test_report_surface_is_the_references():
    port = findings.Report(_both_findings(findings), target="t",
                           rules_run=("a",))
    ref = jfind.Report(_both_findings(jfind), target="t", rules_run=("a",))
    for r in (port, ref):
        r.pass_timings["a"] = 1.5
        other_cls = type(r)
        other = other_cls(r.findings[:1], target="u", rules_run=("b",))
        other.pass_timings["b"] = 2.0
        r.merge(other)
    assert port.rule_ids() == ref.rule_ids()
    assert port.counts() == ref.counts()
    assert port.ok() == ref.ok() and port.ok("error") is False
    assert [f.to_json() for f in port.deduped()] == [
        f.to_json() for f in ref.deduped()]
    assert port.to_json() == ref.to_json()
    assert port.render() == ref.render()
    assert repr(port) == repr(ref)
    assert [f.render() for f in port.warnings()] == [
        f.render() for f in ref.warnings()]
    sectioned = findings.Report(target="s", sections={"plan": {"n": 1}})
    assert sectioned.to_json()["plan"] == {"n": 1}


# ---------------------------------------------------------------------------
# the planted sources (tests/test_concurrency_analysis.py), both lints
# ---------------------------------------------------------------------------

CONCURRENCY_CASES = {
    "unlocked_shared_state": """
        import threading

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self._status = "idle"
                self._t = threading.Thread(target=self._worker)
                self._t.start()

            def _worker(self):
                self._status = "running"

            def status(self):
                return self._status
    """,
    "nonatomic_counter": """
        import threading

        class Counter:
            def __init__(self):
                self.n = 0
                threading.Thread(target=self._tick).start()

            def _tick(self):
                self.n += 1

            def value(self):
                return self.n
    """,
    "stats_alias_rmw": """
        import threading

        class Ledger:
            def __init__(self):
                self._stats = {"saves": 0.0}
                threading.Thread(target=self._worker).start()

            def _worker(self):
                st = self._stats
                st["saves"] += 1.0

            def stats(self):
                return dict(self._stats)
    """,
    "alias_rebind_is_not_a_write": """
        import threading

        class Ok:
            def __init__(self):
                self._stats = {}
                threading.Thread(target=self._worker).start()

            def _worker(self):
                st = self._stats
                st = {}
                st["k"] = 1

            def stats(self):
                return dict(self._stats)
    """,
    "http_handler_alias": """
        import http.server

        class Server:
            def __init__(self):
                self.scrapes = 0

            def scrape(self):
                self.scrapes += 1
                return "ok"

            def start(self):
                ops = self

                class Handler(http.server.BaseHTTPRequestHandler):
                    def do_GET(self):
                        ops.scrape()
    """,
    "lock_across_blocking": """
        import queue
        import threading

        class Pipeline:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue(maxsize=1)
                threading.Thread(target=self._worker).start()

            def _worker(self):
                item = self._q.get()
                with self._lock:
                    self._handle(item)

            def _handle(self, item):
                pass

            def submit(self, item):
                with self._lock:
                    self._q.put(item)
    """,
    "clean_locked_class": """
        import queue
        import threading

        class Clean:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue(maxsize=1)
                self._stats = {"n": 0.0}
                self._status = "idle"
                threading.Thread(target=self._worker).start()

            def _worker(self):
                item = self._q.get()
                with self._lock:
                    self._stats["n"] += 1.0
                    self._status = "running"

            def submit(self, item):
                self._q.put(item)
                with self._lock:
                    self._stats["n"] += 1.0

            def stats(self):
                with self._lock:
                    return dict(self._stats)
    """,
    "single_threaded_class": """
        class Plain:
            def bump(self):
                self.n += 1

            def read(self):
                return self.n
    """,
    "race_waiver": """
        import threading

        class Waived:
            def __init__(self):
                self.n = 0
                threading.Thread(target=self._tick).start()

            def _tick(self):
                self.n += 1  # lint: allow(race-nonatomic-counter): test-only approximate counter

            def value(self):
                return self.n
    """,
}

PURITY_CASES = {
    "wall_clock": """
        import time

        def tick():
            return time.time()
    """,
    "datetime_now": """
        import datetime

        def stamp():
            return datetime.datetime.now()
    """,
    "unseeded_rng": """
        import random
        import numpy as np

        def jitter():
            return random.random() + np.random.rand()
    """,
    "seeded_rng": """
        import random
        import numpy as np

        def make(seed):
            rng = np.random.default_rng(seed)
            r = random.Random(seed)
            return rng.normal(), r.random()
    """,
    "set_order": """
        class Router:
            def __init__(self):
                self._peers = set()

            def pick(self):
                for p in self._peers:
                    return p
    """,
    "sorted_set_iteration": """
        class Router:
            def __init__(self):
                self._peers = []

            def pick(self):
                for p in self._peers:
                    return p
    """,
    "env_read": """
        import os

        class Engine:
            def step(self):
                return os.environ["APEX_TPU_MODE"]
    """,
    "env_read_in_init": """
        import os

        class Engine:
            def __init__(self):
                self.mode = os.environ.get("APEX_TPU_MODE", "run")

        def resolve_depth():
            return os.getenv("APEX_TPU_DEPTH")
    """,
    "purity_waiver": """
        import time

        def banner():
            return time.time()  # lint: allow(replay-wall-clock): display-only timestamp
    """,
}


def _key(found, prefix):
    out = []
    for f in found:
        path, _, line = f.path.rpartition(":")
        assert path.startswith(prefix), f.path
        out.append((f.rule, f.severity, path[len(prefix):], int(line)))
    return sorted(out)


@pytest.mark.parametrize("case", sorted(CONCURRENCY_CASES))
def test_concurrency_lint_equals_the_reference(case):
    src = textwrap.dedent(CONCURRENCY_CASES[case])
    port = concurrency.lint_source(src, "goodput/planted.py")
    ref = jconc.lint_source(src, "goodput/planted.py")
    assert _key(port, "apex_tpu_torch/") == _key(ref, "apex_tpu/")
    assert [f.message for f in port] == [f.message for f in ref]
    clean = case in ("alias_rebind_is_not_a_write", "clean_locked_class",
                     "single_threaded_class", "race_waiver")
    assert (port == []) == clean


@pytest.mark.parametrize("case", sorted(PURITY_CASES))
@pytest.mark.parametrize("rel", ["serve/planted.py", "goodput/stream.py",
                                 "observability/meter.py"])
def test_purity_lint_equals_the_reference(case, rel):
    src = textwrap.dedent(PURITY_CASES[case])
    port = purity.lint_source(src, rel)
    ref = jpure.lint_source(src, rel)
    assert _key(port, "apex_tpu_torch/") == _key(ref, "apex_tpu/")
    clean = case in ("seeded_rng", "sorted_set_iteration",
                     "env_read_in_init", "purity_waiver")
    assert (port == []) == (clean or not purity.is_replay_critical(rel))


def test_replay_critical_modules():
    assert purity.REPLAY_CRITICAL == jpure.REPLAY_CRITICAL
    assert purity.WALL_CLOCK_PATTERNS == jpure.WALL_CLOCK_PATTERNS
    for rel in ("serve/engine.py", "serve/scheduler.py", "goodput/stream.py",
                "resilience/runner.py", "fleetctl/router.py"):
        assert purity.is_replay_critical(rel)
    for rel in ("goodput/async_ckpt.py", "resilience/retry.py",
                "resilience/chaos.py", "observability/meter.py"):
        assert not purity.is_replay_critical(rel)


@pytest.mark.parametrize("case", ["nonatomic_counter", "wall_clock"])
def test_graph_forms_wait_for_item_9(case):
    """Item 9 has landed: the graph forms of both lints run over a
    ``StepGraph``'s sources (as the reference's do,
    ``apex_tpu/analysis/concurrency.py:466-471``) and report what the
    source forms report; without sources they are quiet."""
    from apex_tpu_torch.analysis import PASSES, StepGraph

    src = textwrap.dedent(CONCURRENCY_CASES.get(case)
                          or PURITY_CASES[case])
    rel = "serve/engine.py"
    graph = StepGraph(sources=[(rel, src)])
    assert PASSES["concurrency"] is concurrency.concurrency_pass
    assert PASSES["purity"] is purity.purity_pass
    got = concurrency.concurrency_pass(graph) + purity.purity_pass(graph)
    want = concurrency.lint_sources([(rel, src)]) + \
        purity.lint_sources([(rel, src)])
    assert got == want and got
    for fn in (concurrency.concurrency_pass, purity.purity_pass):
        assert fn(StepGraph()) == []


def test_port_tree_lints_clean():
    """The counterpart of the reference's
    ``test_shipped_package_is_lint_clean``: the lock-discipline and
    replay-purity lints report nothing over ``apex_tpu_torch/``."""
    sources = purity.collect_sources()
    rels = {rel for rel, _ in sources}
    assert len(sources) > 100
    assert {"serve/engine.py", "goodput/stream.py", "resilience/runner.py",
            "goodput/async_ckpt.py", "data/__init__.py"} <= rels
    report = findings.Report(
        concurrency.lint_sources(sources) + purity.lint_sources(sources),
        target="apex_tpu_torch", rules_run=("concurrency", "purity"))
    assert report.findings == [], report.render()
    assert len(purity.collect_sources(only_replay=True)) >= 8


def test_a_planted_wall_clock_in_the_engine_is_caught():
    """The lint reads the port's real replay-critical sources: a
    ``time.time()`` appended to ``serve/engine.py``'s source is caught at
    its line, with no other finding."""
    src = dict(purity.collect_sources(only_replay=True))["serve/engine.py"]
    planted = src + "\n\ndef _stamp():\n    import time\n    return time.time()\n"
    found = purity.lint_source(planted, "serve/engine.py")
    line = len(planted.splitlines())
    assert [(f.rule, f.path) for f in found] == [
        ("replay-wall-clock", f"apex_tpu_torch/serve/engine.py:{line}")]


# ---------------------------------------------------------------------------
# the retrace sentinel
# ---------------------------------------------------------------------------

#: one call a step: (shape of x, dtype, structure of the state, a static
#: python value)
SEQUENCE = [((8, 4), "float32", "flat", 1),
            ((8, 4), "float32", "flat", 1),
            ((8, 4), "float32", "flat", 1),
            ((7, 4), "float32", "flat", 1),   # a ragged last batch
            ((8, 4), "float32", "flat", 1),   # back: an old signature
            ((8, 4), "bfloat16", "flat", 1),  # a dtype change
            ((8, 4), "float32", "nested", 1),  # the tree changed
            ((8, 4), "float32", "flat", 2)]   # a static value changed


def _call(mod, shape, dtype, tree, static):
    if mod == "port":
        x = torch.zeros(shape, dtype=getattr(torch, dtype))
    else:
        x = jnp.zeros(shape, getattr(jnp, dtype))
    state = {"x": x} if tree == "flat" else {"x": x, "extra": [x]}
    return (state,), {"k": static}


@pytest.mark.parametrize("allowed", [1, 2, 3])
def test_retrace_sentinel_equals_the_reference(allowed):
    port = retrace.RetraceSentinel(allowed=allowed, name="train_step")
    ref = jretrace.RetraceSentinel(allowed=allowed, name="train_step")
    for entry in SEQUENCE:
        pa, pk = _call("port", *entry)
        ra, rk = _call("ref", *entry)
        pf, rf = port.observe(*pa, **pk), ref.observe(*ra, **rk)
        assert (pf is None) == (rf is None), entry
        if pf is not None:
            assert (pf.rule, pf.severity, pf.path) == (rf.rule, rf.severity,
                                                       rf.path)
            # the same leaves named as changed
            for part in rf.message.split("; "):
                if part.startswith("leaf ") and ":" in part:
                    assert part.split(":")[0] in pf.message
        assert (port.signatures, port.retraces, port.calls) == (
            ref.signatures, ref.retraces, ref.calls)
    assert len(port.findings) == len(ref.findings) > 0
    with pytest.raises(ValueError):
        retrace.RetraceSentinel(allowed=0)


def test_signature_reads_the_device_not_weak_type():
    a = torch.zeros(2, 3)
    sig = retrace.abstract_signature(a, n=3)
    assert sig[1] == ("tensor", (2, 3), "float32", "cpu")
    assert sig[2] == ("static", "3")
    assert retrace.abstract_signature(a.clone(), n=3) == sig
    assert retrace.abstract_signature(a.double(), n=3) != sig
    np.testing.assert_equal(len(sig), 3)

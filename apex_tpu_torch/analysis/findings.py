"""Findings — the structured currency of every analysis pass.

Counterpart of ``apex_tpu/analysis/findings.py``.  A pass never prints:
it returns :class:`Finding` records (rule id, severity, path, message,
fix hint) that a :class:`Report` aggregates.  The trainer's build checks
(:mod:`apex_tpu_torch.train`), the source lints
(:mod:`.concurrency`, :mod:`.purity`) and the retrace sentinel
(:mod:`.retrace`) all report in this one schema.

The rule catalog (:data:`RULES`) is the single source of truth for rule
ids, default severities and fix hints.  It keeps every rule id of the
reference, so no pass adds an id; a pass emitting an uncataloged rule id
is a bug (:func:`make_finding` raises).  The hints name the reference's
tools where the port has no counterpart yet.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

__all__ = [
    "ERROR",
    "WARNING",
    "INFO",
    "RULES",
    "Finding",
    "Report",
    "make_finding",
]

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITY_ORDER = {ERROR: 2, WARNING: 1, INFO: 0}

#: rule id -> (default severity, what it means, how to fix it).
#: Rule ids are namespaced ``<pass>-<defect>``; ``rules=("transfer",)``
#: selects every rule of the transfer pass.
RULES: Dict[str, Tuple[str, str, str]] = {
    "transfer-callback": (
        ERROR,
        "host callback primitive traced into the step "
        "(jax.debug.print / pure_callback / io_callback): every "
        "execution round-trips device->host",
        "move host I/O out of the jitted step; accumulate device-side "
        "via observability.MetricRegistry and fetch on a cadence",
    ),
    "transfer-hlo-host": (
        ERROR,
        "compiled HLO contains a host transfer op (infeed/outfeed, "
        "host send/recv, or a python-callback custom-call)",
        "the step program must be self-contained on device; feed data "
        "as arguments and read results from outputs",
    ),
    "promotion-f64": (
        ERROR,
        "an op inside the step produces float64 — on TPU every f64 op "
        "is emulated and silently doubles memory and wire bytes",
        "drop the f64 literal / enable-x64 dependence; use f32 "
        "(or the amp policy's compute dtype) explicitly",
    ),
    "promotion-widen": (
        WARNING,
        "value widened past the active amp policy's compute dtype "
        "(e.g. bf16 -> f32) — a silent promotion defeats the policy's "
        "memory/MXU savings",
        "if accidental, keep literals weakly typed (python floats) or "
        "cast them to the compute dtype; if intentional accumulation, "
        "wrap the region in jax.named_scope containing 'f32' "
        "(e.g. 'f32_accum') to mark it policy-exempt",
    ),
    "donation-dropped": (
        ERROR,
        "buffers declared in donate_argnums were NOT aliased by XLA "
        "in the compiled buffer assignment — the step silently holds "
        "two copies (e.g. doubled optimizer memory)",
        "make donated inputs match an output's shape/dtype/layout "
        "exactly (return the updated buffer, keep dtypes stable), or "
        "drop them from donate_argnums",
    ),
    "retrace": (
        ERROR,
        "the step recompiled mid-run: its abstract signature (tree "
        "structure / shapes / dtypes / static values) changed across "
        "calls, paying a full XLA compile each time",
        "pad inputs to a fixed shape, hoist changing python values out "
        "of the step or mark them static, and keep the state tree "
        "structure constant",
    ),
    "collective-count": (
        ERROR,
        "compiled collective count differs from the comm engine's "
        "promise (e.g. a chunked sync should compile to exactly 2K "
        "collectives)",
        "check wire/chunks knobs against docs/comm.md; a fused or "
        "duplicated collective means XLA restructured the sync",
    ),
    "collective-bytes": (
        ERROR,
        "collective payload bytes differ from the promised wire plan "
        "(quantized wires must shrink bytes, not just relabel dtypes)",
        "verify the wire format actually applied (int8 payloads carry "
        "codes+scales); compare against comm.ring_wire_bytes",
    ),
    "collective-dtype": (
        ERROR,
        "a collective moves a wider dtype than the configured wire "
        "format (e.g. f32 payloads where wire='int8' was requested)",
        "ensure encode happens before the collective; a stray cast "
        "upstream re-widens the payload",
    ),
    "sharding-replicated": (
        ERROR,
        "a large param/optimizer-state leaf the plan shards compiled "
        "FULLY REPLICATED — GSPMD silently replicates anything "
        "propagation can't decide, and every device pays the whole "
        "tensor",
        "pass the leaf's NamedSharding via in_shardings (build the "
        "tree with analysis.sharding.match_partition_rules) and make "
        "sure no with_sharding_constraint downstream contradicts it",
    ),
    "sharding-mismatch": (
        ERROR,
        "a leaf's compiled tiling disagrees with its declared "
        "PartitionSpec — the plan did not survive compilation (wrong "
        "axis, transposed factors, or a constraint overrode it)",
        "align the rule table with the in_shardings actually passed; "
        "check with_sharding_constraint calls inside the step for "
        "conflicting specs",
    ),
    "sharding-unverified": (
        WARNING,
        "the plan names a multi-device mesh but the module compiled "
        "single-partition — conformance cannot be proven on this "
        "compile (a clean verdict here would be a lie)",
        "compile on the real mesh (or mock it: "
        "XLA_FLAGS=--xla_force_host_platform_device_count=N) before "
        "trusting the plan",
    ),
    "reshard-unplanned": (
        ERROR,
        "the step body contains a collective the declared plan does "
        "not predict — the signature of a weight all-gather or "
        "reshard XLA inserted because a spec didn't survive "
        "propagation (a 'sharded' run secretly paying replicated "
        "wire traffic every step)",
        "trace the named op back to its source; either fix the "
        "sharding so the gather disappears, or declare it in the "
        "plan if the reshard is intentional",
    ),
    "reshard-plan": (
        ERROR,
        "a planned collective's compiled count/bytes/wire dtype "
        "drifted from the declaration (e.g. a K-chunk int8 sync that "
        "compiled to f32 payloads, or twice the promised bytes)",
        "compare against the engine's declared plan "
        "(DistributedDataParallel.collective_plan / the ZeRO "
        "optimizers'); check wire/chunks knobs against docs/comm.md",
    ),
    "memory-budget": (
        ERROR,
        "the static peak-HBM estimate of the compiled step exceeds "
        "the configured budget — the program OOMs before the first "
        "step produces a number",
        "shard the top-attributed buffers (the finding names them), "
        "donate the update buffers, lower the batch/context, or "
        "raise the budget if the device really has the headroom",
    ),
    "sharding-implicit-replication": (
        WARNING,
        "a pjit/jit call site passes in_shardings=None — every array "
        "arrives fully replicated and GSPMD must re-derive (or "
        "silently skip) the partitioning the caller intended",
        "pass explicit in_shardings (build the spec tree with "
        "analysis.sharding.match_partition_rules) so the plan is "
        "declared, and lintable, at the call site",
    ),
    "sharding-missing-constraint": (
        WARNING,
        "a pjit/shard_map region with large contractions never pins "
        "an intermediate with with_sharding_constraint — GSPMD must "
        "guess activation layouts, and a wrong guess inserts "
        "resharding collectives mid-step",
        "pin the big intermediates (post-attention, post-MLP) with "
        "jax.lax.with_sharding_constraint; verify with "
        "tools/shard_report.py",
    ),
    "kernel-vmem-overflow": (
        ERROR,
        "a Pallas kernel config's static VMEM footprint "
        "(double-buffered input/output blocks + scratch + in-kernel "
        "intermediates at true dtype widths) exceeds the backend's "
        "on-chip VMEM — Mosaic either fails to lower or spills, and "
        "either way the config is dead on arrival",
        "shrink block_q/block_k (the f32 score tile is the dominant "
        "term: bytes ~ 4*block_q*block_k); tools/attn_tune.py --prune "
        "drops such cells before they waste a compile",
    ),
    "kernel-tile-misaligned": (
        ERROR,
        "a kernel block shape violates the TPU tile quantum (last dim "
        "a 128-lane multiple, second-to-last a dtype-sublane "
        "multiple, full-axis blocks exempt), leaves a ragged tail the "
        "kernel has no masking for, or feeds the 128x128 MXU a "
        "non-128 contraction extent (sub-tile passes do dead work)",
        "pick power-of-two tiles >= 128 that divide the padded "
        "sequence; the caller-side padding contracts are "
        "ops.attention._seq_pad / _pad_head_dim",
    ),
    "kernel-grid-oob": (
        ERROR,
        "a kernel BlockSpec index map, evaluated over the full grid, "
        "produces a block offset outside the operand's block grid — "
        "the DMA would read or write out of the array's bounds",
        "fix the index map's arithmetic (or the grid extent that "
        "drives it); the finding names the first offending grid cell",
    ),
    "kernel-block-race": (
        ERROR,
        "two grid cells that differ along a PARALLEL grid dimension "
        "write the same output block — parallel dims carry no "
        "ordering or accumulation semantics, so the result depends on "
        "scheduling (revisits along 'arbitrary' dims accumulating in "
        "scratch are the sanctioned pattern and do not flag)",
        "make the racing grid axis 'arbitrary' in dimension_semantics "
        "and accumulate in VMEM scratch with a final-iteration write, "
        "or give each parallel cell a distinct output block",
    ),
    "kernel-dead-tiles": (
        WARNING,
        "a causal kernel config wastes more than the configured "
        "fraction of its live-tile FLOPs on masked elements — tiles "
        "straddling the causal boundary pay full matmuls for a "
        "triangle of zeros (a whole-seq tile wastes ~50%)",
        "smaller (or rectangular) tiles track the causal boundary "
        "more tightly; weigh against per-tile grid overhead with "
        "tools/attn_tune.py --prune --dry-run's predicted ranking",
    ),
    "kernel-hardcoded-block": (
        WARNING,
        "a call site passes a literal block_q=/block_k= tile size, "
        "bypassing the tuned-tile lookup (APEX_TPU_TUNE_CACHE -> "
        "_TUNED_TILES -> heuristic) — the number was right on one "
        "chip/shape and silently wrong everywhere else",
        "drop the literal so dispatch consults the tuning cache, or "
        "commit the measured winner via tools/attn_tune.py "
        "--cache-out / the _TUNED_TILES table",
    ),
    "race-unlocked-shared-state": (
        ERROR,
        "an attribute reachable from both a thread body and the main "
        "path is written without holding the class's lock — a torn or "
        "stale read is a scheduling accident away, and the GIL only "
        "protects single bytecodes, not invariants spanning fields",
        "guard every mutation with the class's lock (use "
        "observability.TrackedLock so the runtime sanitizer sees it); "
        "keep blocking calls (queue put/join) OUTSIDE the held region",
    ),
    "race-nonatomic-counter": (
        ERROR,
        "a read-modify-write counter (x += 1 and friends) is updated "
        "from both a thread body and the main path without a lock — "
        "the load/store pair is not atomic, so concurrent updates "
        "silently lose increments",
        "wrap the update in the class's lock (a TrackedLock keeps the "
        "sanitizer's lock-order graph complete), or move the counter "
        "to the single owning thread",
    ),
    "race-lock-across-blocking": (
        ERROR,
        "a lock is held across a blocking hand-off (bounded-queue "
        "put/join, future result) while a consumer thread needs the "
        "same lock to make progress — the classic two-party deadlock "
        "shape: the holder waits on the queue, the drainer waits on "
        "the lock",
        "shrink the critical section so the blocking call happens "
        "after release; snapshot what the hand-off needs under the "
        "lock, then put/join outside it",
    ),
    "replay-wall-clock": (
        ERROR,
        "a wall-clock read (time.time / datetime.now) in a "
        "replay-critical module — bit-identical replay (the SERVE/"
        "GOODPUT/FLEET gates) requires every time source to be "
        "time.monotonic or the drill's virtual clock; wall time "
        "diverges across runs and hosts",
        "use time.monotonic() (durations) or the injected virtual "
        "clock (scheduling); waive an audited telemetry-only site "
        "with '# lint: allow(replay-wall-clock): <reason>'",
    ),
    "replay-unseeded-rng": (
        ERROR,
        "module-level RNG (random.*, np.random.*) in a replay-critical "
        "module draws from hidden global state — two replays of the "
        "same request stream sample different numbers, breaking "
        "bit-identical replay",
        "thread an explicit seeded generator (np.random.default_rng("
        "seed), random.Random(seed), or jax.random keys) through the "
        "call path; never the module-level functions",
    ),
    "replay-set-order": (
        ERROR,
        "iteration over a set feeds a scheduling/ordering decision in "
        "a replay-critical module — set order is hash-seed dependent "
        "(PYTHONHASHSEED), so admission/eviction order differs across "
        "processes and replay diverges",
        "iterate sorted(the_set) (or keep an explicitly ordered "
        "list/dict — dicts preserve insertion order) wherever the "
        "order can influence scheduling",
    ),
    "replay-env-read": (
        ERROR,
        "os.environ is read inside a step/tick body of a "
        "replay-critical module — per-step environment reads make the "
        "replayed run depend on live process state instead of the "
        "recorded configuration",
        "resolve env knobs ONCE at construction (__init__ / from_env /"
        " a resolve_* helper) and carry the value; the step path "
        "reads only captured config",
    ),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect: rule id + severity + where + what + how to fix."""

    rule: str
    severity: str
    path: str  # op path: name_stack, HLO op name, or file:line
    message: str
    hint: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        loc = f" @ {self.path}" if self.path else ""
        hint = f"\n    fix: {self.hint}" if self.hint else ""
        return (f"[{self.severity.upper()}] {self.rule}{loc}: "
                f"{self.message}{hint}")


def make_finding(
    rule: str,
    path: str,
    message: str,
    severity: Optional[str] = None,
    hint: Optional[str] = None,
) -> Finding:
    """Build a :class:`Finding` with catalog defaults for severity/hint.

    Raises ``KeyError`` on a rule id missing from :data:`RULES` — passes
    may not invent rules the catalog (and docs) don't know.
    """
    default_sev, _desc, default_hint = RULES[rule]
    return Finding(
        rule=rule,
        severity=severity or default_sev,
        path=path,
        message=message,
        hint=default_hint if hint is None else hint,
    )


class Report:
    """Ordered collection of findings from one ``check()`` run."""

    def __init__(
        self,
        findings: Optional[List[Finding]] = None,
        target: str = "",
        rules_run: Tuple[str, ...] = (),
        sections: Optional[Dict[str, object]] = None,
    ):
        self.findings: List[Finding] = list(findings or [])
        self.target = target
        self.rules_run = tuple(rules_run)
        #: pass name -> milliseconds spent, filled by the check runner
        #: (one entry per rules_run pass, pinned in tests)
        self.pass_timings: Dict[str, float] = {}
        #: extra top-level sections (the trainer's ``plan`` and
        #: ``memory``, a lint's ``files_scanned``) merged into
        #: :meth:`to_json`
        self.sections: Dict[str, object] = dict(sections or {})

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    def merge(self, other: "Report") -> "Report":
        """Fold another report's findings AND bookkeeping (pass
        timings summed per pass, rules_run unioned) into this one —
        what a check over several programs uses instead of a bare
        ``extend``, which would drop the second report's timing and
        pass record."""
        self.findings.extend(other.findings)
        for name in other.rules_run:
            if name not in self.rules_run:
                self.rules_run = self.rules_run + (name,)
        for name, ms in other.pass_timings.items():
            self.pass_timings[name] = self.pass_timings.get(name, 0.0) + ms
        return self

    def deduped(self) -> List[Finding]:
        """Findings unique by (rule, location) — two passes (or two
        substrates of one pass) reporting the same defect at the same
        site count once.  Order preserved; first occurrence wins."""
        seen, out = set(), []
        for f in self.findings:
            key = (f.rule, f.path)
            if key in seen:
                continue
            seen.add(key)
            out.append(f)
        return out

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    def rule_ids(self):
        return sorted({f.rule for f in self.findings})

    def ok(self, fail_on: str = ERROR) -> bool:
        """True when no finding reaches ``fail_on`` severity."""
        bar = _SEVERITY_ORDER[fail_on]
        return not any(
            _SEVERITY_ORDER[f.severity] >= bar for f in self.findings
        )

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_json(self) -> dict:
        out = {
            "target": self.target,
            "rules_run": list(self.rules_run),
            "errors": len(self.errors()),
            "warnings": len(self.warnings()),
            "pass_timings": dict(self.pass_timings),
            "findings": [f.to_json() for f in self.findings],
        }
        for key, value in self.sections.items():
            out.setdefault(key, value)
        return out

    def to_json_line(self) -> str:
        return json.dumps(self.to_json())

    def render(self) -> str:
        head = (f"graph lint: {self.target or '<step>'} — "
                f"{len(self.errors())} error(s), "
                f"{len(self.warnings())} warning(s)")
        if not self.findings:
            return head + " — clean"
        return "\n".join([head] + [f"  {f.render()}" for f in self.findings])

    def __repr__(self):
        return (
            f"Report(target={self.target!r}, errors={len(self.errors())}, "
            f"warnings={len(self.warnings())}, rules={self.rule_ids()})"
        )

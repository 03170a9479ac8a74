"""Retrace sentinel — catches silent re-captures across steps.

Counterpart of ``apex_tpu/analysis/retrace.py``.  A captured program (a
CUDA graph, such as the serving engine's decode step, or a compiled
function) is valid for one *abstract signature* of its inputs: each
tensor's shape, dtype and device, the tree structure, and the value of
every non-tensor leaf.  When the signature changes the program is
captured again (or its bucket misses), which in a loop is almost always
a bug: a ragged last batch, a Python int threaded through the step, a
state tree whose structure depends on a flag.

:class:`RetraceSentinel` keeps the abstract signature of every observed
call and emits a ``retrace`` finding the moment a NEW signature appears
past the allowed budget (by default the first signature is free and
every later one flags).  It reads only host-side metadata, never device
data, so it is safe on every step.  On the card it watches the calls
that feed the decode graph and the prefill buckets.

JAX's ``weak_type`` has no PyTorch counterpart, so the signature drops
it; the device is in it instead (a tensor moved to another device is a
new capture).

    sentinel = RetraceSentinel()
    for step in range(n):
        batch = next(it)
        f = sentinel.observe(state, batch)   # None or a Finding
        state = train_step(state, batch)
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from apex_tpu_torch.analysis.findings import Finding, make_finding

__all__ = ["abstract_signature", "RetraceSentinel"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(node, leaves: list) -> str:
    """The structure string of ``node`` (dicts with sorted keys, lists,
    tuples, NamedTuples; None an empty subtree), its leaves appended to
    ``leaves`` in ``jax.tree_util``'s order."""
    if node is None:
        return "None"
    if isinstance(node, dict):
        keys = sorted(node)
        inner = ", ".join(f"{k!r}: {_flatten(node[k], leaves)}" for k in keys)
        return "{" + inner + "}"
    if _is_namedtuple(node):
        inner = ", ".join(_flatten(v, leaves) for v in node)
        return f"{type(node).__name__}({inner})"
    if isinstance(node, (list, tuple)):
        inner = ", ".join(_flatten(v, leaves) for v in node)
        return ("[" + inner + "]") if isinstance(node, list) else (
            "(" + inner + ")")
    leaves.append(node)
    return "*"


def _leaf_key(leaf: Any) -> Tuple:
    if isinstance(leaf, torch.Tensor):
        return ("tensor", tuple(leaf.shape), str(leaf.dtype).replace(
            "torch.", ""), str(leaf.device))
    # a non-tensor leaf is a static value: its VALUE is part of the
    # signature (a changing python scalar re-captures every call)
    return ("static", repr(leaf))


def abstract_signature(*args, **kwargs) -> Tuple:
    """Hashable abstract signature of a call: the tree structure plus
    (shape, dtype, device) per tensor leaf and ``repr`` per static leaf
    — exactly the things whose change forces a new capture."""
    leaves: list = []
    structure = _flatten((args, kwargs), leaves)
    return (structure,) + tuple(_leaf_key(leaf) for leaf in leaves)


class RetraceSentinel:
    """Flags calls whose abstract signature changed after the budget.

    ``allowed`` is the number of DISTINCT signatures that are expected
    (default 1: one capture, then steady state).  A ragged last batch
    can legitimately add one (``allowed=2``); a serving engine's prefill
    buckets add one each.
    """

    def __init__(self, allowed: int = 1, name: str = "step"):
        if allowed < 1:
            raise ValueError("allowed must be >= 1")
        self.allowed = allowed
        self.name = name
        self._signatures: List[Tuple] = []
        self.findings: List[Finding] = []
        self.calls = 0

    @property
    def signatures(self) -> int:
        """Distinct abstract signatures seen so far."""
        return len(self._signatures)

    @property
    def retraces(self) -> int:
        """Signatures beyond the allowed budget (each one a capture)."""
        return max(0, len(self._signatures) - self.allowed)

    def observe(self, *args, **kwargs) -> Optional[Finding]:
        """Record one call's signature; return a ``retrace`` finding if
        it is a NEW signature past the allowed budget, else None."""
        self.calls += 1
        sig = abstract_signature(*args, **kwargs)
        if sig in self._signatures:
            return None
        self._signatures.append(sig)
        if len(self._signatures) <= self.allowed:
            return None
        # name the leaves that differ from the previous signature so the
        # finding points at the culprit, not just "something changed"
        prev, cur = self._signatures[-2], sig
        diffs = []
        if prev[0] != cur[0]:
            diffs.append("tree structure changed")
        for i, (a, b) in enumerate(zip(prev[1:], cur[1:])):
            if a != b:
                diffs.append(f"leaf {i}: {a} -> {b}")
        if len(prev) != len(cur):
            diffs.append(f"leaf count {len(prev) - 1} -> {len(cur) - 1}")
        finding = make_finding(
            "retrace",
            path=f"{self.name} call #{self.calls}",
            message=(
                f"abstract signature #{len(self._signatures)} (allowed "
                f"{self.allowed}) — this call RE-CAPTURES: "
                + ("; ".join(diffs[:4]) or "signature changed")
            ),
        )
        self.findings.append(finding)
        return finding

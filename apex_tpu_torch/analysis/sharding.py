"""Rule tables over parameter trees, and the findings a check reports.

Counterpart of the parts of ``apex_tpu/analysis/sharding.py`` (and of
``analysis/findings.py``) that the trainer reads:

- :class:`PartitionSpec` (exported as ``P``): a tuple with one entry per
  dimension, an axis name, a tuple of axis names or None.  A JAX
  ``PartitionSpec`` converts with ``P(*tuple(spec))``;
- :func:`tree_paths` — ``[(path, leaf), ...]`` of a tree of dicts,
  lists, tuples and NamedTuples whose leaves are tensors (or anything
  else that is not a container), dict keys in sorted order and None an
  empty subtree, as ``jax.tree_util`` flattens them;
- :func:`match_partition_rules` (first regex that ``re.search``-matches
  the ``/``-joined path wins; scalars and one-element leaves are never
  partitioned; a leaf no rule covers raises naming its path) and
  :func:`spec_dim_factors`;
- :class:`Finding` / :class:`Report`, re-exported from
  :mod:`apex_tpu_torch.analysis.findings` (the one schema): what
  :meth:`apex_tpu_torch.train.TrainStep.verify` returns.

The reference's GSPMD sharding and reshard passes read compiled
shardings, which have no counterpart on one card: the trainer checks its
shards against these tables and its plan against the collective call log
of :mod:`apex_tpu_torch.parallel.comm` (the recorded step's memory and
graph passes live in :mod:`.memory` and :mod:`.passes`).
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Sequence, Tuple

from apex_tpu_torch.analysis.findings import (  # noqa: F401
    ERROR,
    INFO,
    WARNING,
    Finding,
    Report,
)

__all__ = [
    "PartitionSpec",
    "P",
    "ERROR",
    "WARNING",
    "INFO",
    "Finding",
    "Report",
    "tree_paths",
    "tree_leaves",
    "tree_map",
    "tree_unflatten",
    "match_partition_rules",
    "spec_dim_factors",
]

class PartitionSpec(tuple):
    """How a leaf's dimensions map onto mesh axes: one entry per leading
    dimension (an axis name, a tuple of names, or None); dimensions past
    the last entry are not partitioned."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# trees: dicts (sorted keys), lists, tuples, NamedTuples; None is empty
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """``[(key, child), ...]`` of a container node, or None for a leaf."""
    if isinstance(node, PartitionSpec):
        return None
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def tree_paths(tree, sep: str = "/") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]``: dict keys, sequence indices and NamedTuple
    field names joined by ``sep``, in ``jax.tree_util``'s order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, parts):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((sep.join(parts), node))
            return
        for key, child in kids:
            walk(child, parts + [key])

    walk(tree, [])
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def _rebuild(node, leaf_fn):
    if node is None:
        return None
    if isinstance(node, PartitionSpec):
        return leaf_fn(node)
    if isinstance(node, dict):
        return {k: _rebuild(node[k], leaf_fn) for k in sorted(node)}
    if _is_namedtuple(node):
        return type(node)(*(_rebuild(v, leaf_fn) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, leaf_fn) for v in node)
    return leaf_fn(node)


def tree_unflatten(structure, leaves: Sequence[Any]):
    """``structure`` with its leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)
    out = _rebuild(structure, lambda _: next(it))
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over after unflattening")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the leaves at the same
    places of ``rest``, flattened up to ``tree``'s structure)."""
    leaves = tree_leaves(tree)
    others = [flatten_up_to(tree, r) for r in rest]
    return tree_unflatten(tree, [fn(*args) for args in zip(leaves, *others)])


def flatten_up_to(structure, tree) -> list:
    """The subtrees of ``tree`` at the places of ``structure``'s leaves
    (``structure`` a prefix of ``tree``'s structure)."""
    out: list = []

    def walk(s, t):
        if s is None:
            return
        kids = _children(s)
        if kids is None:
            out.append(t)
            return
        tk = _children(t)
        if tk is None or [k for k, _ in tk] != [k for k, _ in kids]:
            raise ValueError(f"tree structures differ: {s!r:.80} vs "
                             f"{t!r:.80}")
        for (_, a), (_, b) in zip(kids, tk):
            walk(a, b)

    walk(structure, tree)
    return out


# ---------------------------------------------------------------------------
# rule tables
# ---------------------------------------------------------------------------


def _numel(leaf) -> int:
    return int(math.prod(tuple(getattr(leaf, "shape", ()))))


def match_partition_rules(rules, params, sep: str = "/"):
    """A tree of :class:`PartitionSpec` over ``params`` from
    ``[(regex, spec), ...]``: the first rule whose regex
    ``re.search``-matches the leaf's path wins; a scalar or one-element
    leaf is never partitioned (``P()``); a leaf no rule covers raises
    ``ValueError("partition rule not found for param: <path>")``."""

    def pick(path: str, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or _numel(leaf) == 1:
            return P()
        for rule, spec in rules:
            if re.search(rule, path) is not None:
                return spec if isinstance(spec, PartitionSpec) else P(*spec)
        raise ValueError(f"partition rule not found for param: {path}")

    return tree_unflatten(params, [pick(path, leaf)
                                   for path, leaf in tree_paths(params, sep)])


def spec_dim_factors(spec, mesh: Dict[str, int], rank: int) -> List[int]:
    """Shards per dimension ``spec`` implies on a rank-``rank`` leaf under
    ``mesh`` (axis -> size): ``P(None, "tp")`` on rank 2 with tp = 4 is
    ``[1, 4]``; tuple entries multiply."""
    entries: Sequence = tuple(spec) if spec is not None else ()
    factors = []
    for d in range(rank):
        e = entries[d] if d < len(entries) else None
        if e is None:
            factors.append(1)
        elif isinstance(e, (tuple, list)):
            f = 1
            for axis in e:
                f *= int(mesh.get(axis, 1))
            factors.append(f)
        else:
            factors.append(int(mesh.get(e, 1)))
    return factors

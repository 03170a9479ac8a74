"""Rule tables and the update-sharding heuristic.

Counterpart of ``apex_tpu/train/sharding.py``, feeding
:class:`apex_tpu_torch.train.Trainer`:

1. **Rule-table resolution** — the config's regex -> PartitionSpec table
   becomes a spec tree for the params, the optimizer state and the batch
   (:func:`apex_tpu_torch.analysis.sharding.match_partition_rules`, so a
   leaf no rule covers fails naming its path).  The resolved specs round
   trip into an exact entry-anchored rule table
   (:func:`exact_entry_rules`), the expectation the built step's shapes
   are verified against.  :func:`slice_local` cuts a rank's shard out of
   a global tensor, :func:`local_shape` says what shape that shard has.

2. **The update-sharding decision** (:func:`decide_update_sharding`) —
   the framework decides whether the optimizer update shards across dp
   replicas (the ZeRO structure of
   :mod:`apex_tpu_torch.parallel.distributed_fused_optimizers`):

   - ``dp == 1`` -> **replicate**;
   - a custom optimizer object -> **replicate** (only the named
     optimizers have a distributed twin);
   - explicit ``update_sharding="shard"|"replicate"`` -> that, always;
   - otherwise **shard iff** the f32 param bytes reach
     ``zero_min_bytes`` AND the ZeRO wire plan
     (:func:`apex_tpu_torch.parallel.comm.zero_plan`) moves at most 2x
     the bytes of the DDP sync plan (:func:`~apex_tpu_torch.parallel.
     comm.sync_plan`) under the configured wire.

   The decision records the plan bytes and the optimizer-state bytes
   sharding saves, and :meth:`UpdateShardingDecision.render` prints the
   reference's sentence.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, List, Sequence, Tuple

from apex_tpu_torch.analysis.sharding import (
    P,
    flatten_up_to,
    match_partition_rules,
    spec_dim_factors,
    tree_leaves,
    tree_map,
    tree_paths,
)
from apex_tpu_torch.parallel import comm

__all__ = [
    "ZERO_TWINS",
    "UpdateShardingDecision",
    "decide_update_sharding",
    "resolve_param_specs",
    "resolve_batch_specs",
    "mirror_optimizer_specs",
    "exact_entry_rules",
    "local_shape",
    "slice_local",
    "plan_wire_bytes",
]


#: named optimizers with a distributed (ZeRO) twin — the one source the
#: heuristic, the trainer and the ``optimizers.by_name`` registry point at
ZERO_TWINS = ("adam", "lamb")


# ---------------------------------------------------------------------------
# rule-table resolution
# ---------------------------------------------------------------------------


def resolve_param_specs(rules, params):
    """PartitionSpec tree for ``params`` from the config rule table; an
    uncovered leaf raises ``ValueError("partition rule not found for
    param: <path>")`` instead of silently replicating."""
    return match_partition_rules(list(rules), params)


def resolve_batch_specs(batch_rules, batch):
    """PartitionSpec tree for the batch; the default rule table shards
    every leaf's leading axis over ``dp``."""
    rules = list(batch_rules) if batch_rules else [(r".*", P("dp"))]
    return match_partition_rules(rules, batch)


def mirror_optimizer_specs(opt_state, params, param_specs):
    """Spec tree for a functional optimizer state (the port's
    ``FusedAdamState``/``FusedLAMBState``: a count and moment dicts keyed
    by the params' ``tree_paths``): a field that mirrors the params
    (same paths, same shapes) inherits their specs leaf for leaf; a
    scalar field replicates; anything else is a loud error — an
    optimizer leaf without a sharding is a silent replication."""
    paths = tree_paths(params)
    shapes = {p: tuple(getattr(l, "shape", ())) for p, l in paths}
    specs = dict(zip([p for p, _ in paths],
                     flatten_up_to(params, param_specs)))

    def assign(path, sub):
        if isinstance(sub, dict) and set(sub) == set(shapes) and all(
                tuple(getattr(sub[k], "shape", ())) == shapes[k]
                for k in sub):
            return {k: specs[k] for k in sub}
        if all(getattr(l, "ndim", 0) == 0 for l in tree_leaves(sub)):
            return tree_map(lambda _: P(), sub)
        raise ValueError(
            f"cannot infer a sharding for optimizer state field "
            f"{path!r}: it neither mirrors the params tree nor is "
            "scalar — pass explicit rules or a named optimizer"
        )

    if hasattr(opt_state, "_fields"):  # NamedTuple
        return type(opt_state)(*(
            assign(f, getattr(opt_state, f)) for f in opt_state._fields
        ))
    if isinstance(opt_state, dict):
        return {k: assign(k, v) for k, v in opt_state.items()}
    if isinstance(opt_state, (list, tuple)):
        return type(opt_state)([assign(str(i), v)
                                for i, v in enumerate(opt_state)])
    return assign("<state>", opt_state)


def _spec_leaves(specs, tree):
    """Spec leaves aligned with ``tree_paths(tree)`` order."""
    return flatten_up_to(tree, specs)


def exact_entry_rules(sections) -> List[Tuple[str, Any]]:
    """Exact (escaped, anchored) entry rule table from resolved specs.

    ``sections`` is ``[(arg_name, tree, spec_tree), ...]`` — one entry
    per step argument.  The result matches ``/``-joined paths, e.g.
    ``state/params/w1`` or ``batch/0``, each mapped to the EXACT spec
    the trainer sliced with, plus a replicated catch-all so bookkeeping
    leaves stay covered.
    """
    rules: List[Tuple[str, Any]] = []
    for name, tree, specs in sections:
        paths = [p for p, _ in tree_paths(tree)]
        spec_flat = _spec_leaves(specs, tree)
        for path, spec in zip(paths, spec_flat):
            full = f"{name}/{path}" if path else name
            rules.append((rf"^{re.escape(full)}$", spec))
    rules.append((r".*", P()))
    return rules


# ---------------------------------------------------------------------------
# local-shape arithmetic (each rank holds its shard)
# ---------------------------------------------------------------------------


def local_shape(shape, spec, mesh: dict) -> tuple:
    """Per-device shape of a leaf under ``spec`` on ``mesh``."""
    factors = spec_dim_factors(spec, mesh, len(shape))
    out = []
    for dim, f in zip(shape, factors):
        if dim % f:
            raise ValueError(
                f"dim {dim} of shape {tuple(shape)} not divisible by "
                f"its sharding factor {f} under {spec}"
            )
        out.append(dim // f)
    return tuple(out)


def slice_local(leaf, spec, axis: str, index: int, size: int):
    """``leaf``'s shard along every dim ``spec`` assigns to ``axis``
    (rank ``index`` of ``size``), a view — how each rank cuts its tp
    shards (and its dp rows of the batch) out of the global tree."""
    out = leaf
    entries = tuple(spec) if spec is not None else ()
    for d in range(getattr(leaf, "ndim", 0)):
        e = entries[d] if d < len(entries) else None
        names = e if isinstance(e, (tuple, list)) else (e,)
        if axis in [n for n in names if n is not None]:
            if len([n for n in names if n is not None]) > 1:
                raise NotImplementedError(
                    f"mixed-axis dim sharding {e!r} is not supported by "
                    "the trainer's ZeRO path"
                )
            n = out.shape[d] // size
            out = out.narrow(d, index * n, n)
    return out


# ---------------------------------------------------------------------------
# the update-sharding heuristic
# ---------------------------------------------------------------------------


def plan_wire_bytes(entries: Sequence[dict]) -> int:
    """Upper-bound wire bytes of a collective-plan entry list (the
    ``bytes`` bounds :func:`comm.sync_plan`/:func:`comm.zero_plan`
    emit) — the common currency the heuristic compares plans in."""
    total = 0
    for e in entries:
        b = e.get("bytes")
        if b is None:
            continue
        total += int(b[1] if isinstance(b, (list, tuple)) else b)
    return total


@dataclasses.dataclass(frozen=True)
class UpdateShardingDecision:
    """What the framework decided about the weight update, and why."""

    shard: bool
    reason: str
    param_bytes: int
    ddp_wire_bytes: int
    zero_wire_bytes: int
    #: optimizer-state bytes the sharded layout saves per device
    #: ((dp-1)/dp · 3 · param_bytes: m, v, master)
    state_bytes_saved: int

    @property
    def mode(self) -> str:
        return "zero" if self.shard else "ddp"

    def render(self) -> str:
        mib = 1 << 20
        return (
            f"update-sharding: {self.mode} ({self.reason}; params "
            f"{self.param_bytes / mib:.1f}MiB, wire ddp≤"
            f"{self.ddp_wire_bytes / mib:.1f}MiB zero≤"
            f"{self.zero_wire_bytes / mib:.1f}MiB, state saved "
            f"{self.state_bytes_saved / mib:.1f}MiB/device)"
        )


def decide_update_sharding(
    params,
    config,
    param_specs=None,
) -> UpdateShardingDecision:
    """Apply the documented heuristic (module docstring) to a param
    tree under ``config`` (a :class:`apex_tpu_torch.train.TrainConfig`).

    Sizing uses the LOCAL (tp-sharded) leaf sizes when ``param_specs``
    is given — the dp sync moves local shards, so that is the honest
    wire accounting.
    """
    mesh = config.mesh_dict()
    dp = config.dp
    if param_specs is not None:
        sizes = []
        specs = _spec_leaves(param_specs, params)
        for leaf, spec in zip(tree_leaves(params), specs):
            sizes.append(
                int(math.prod(local_shape(leaf.shape, spec, mesh)) or 1)
            )
    else:
        sizes = [int(l.numel()) for l in tree_leaves(params)]
    n_elements = sum(sizes)
    param_bytes = n_elements * 4  # f32 accounting: the master copy

    ddp_wire = plan_wire_bytes(comm.sync_plan(
        sizes, dp, wire=config.wire, chunks=config.chunks,
        block=config.block, min_size=config.min_sync_size,
    ))
    zero_wire = plan_wire_bytes(comm.zero_plan(
        n_elements, dp, wire=config.wire, param_wire=config.param_wire,
        chunks=config.chunks, block=config.block,
    ))
    saved = (dp - 1) * 3 * param_bytes // max(dp, 1)

    def make(shard, reason):
        return UpdateShardingDecision(
            shard=shard, reason=reason, param_bytes=param_bytes,
            ddp_wire_bytes=ddp_wire, zero_wire_bytes=zero_wire,
            state_bytes_saved=saved if shard else 0,
        )

    zero_capable = config.optimizer_name() in ZERO_TWINS
    if config.update_sharding == "shard":
        if dp <= 1:
            raise ValueError(
                "update_sharding='shard' needs a dp axis >= 2 — there "
                "are no replicas to shard the update across"
            )
        if not zero_capable:
            raise ValueError(
                "update_sharding='shard' requires an optimizer with a "
                f"distributed (ZeRO) twin (have {ZERO_TWINS})"
            )
        return make(True, "explicit override")
    if config.update_sharding == "replicate":
        return make(False, "explicit override")
    # -- auto -----------------------------------------------------------
    if dp <= 1:
        return make(False, "dp=1: no replicas to shard across")
    if not zero_capable:
        return make(False, "optimizer has no distributed (ZeRO) twin")
    if param_bytes < config.zero_min_bytes:
        return make(
            False,
            f"params under the {config.zero_min_bytes >> 20} MiB "
            "zero_min_bytes floor",
        )
    if zero_wire > 2 * max(ddp_wire, 1):
        return make(
            False,
            "ZeRO wire plan exceeds 2x the ddp sync plan "
            "(tiny-leaf-dominated tree)",
        )
    return make(True, "auto: param bytes over the floor at comparable wire")

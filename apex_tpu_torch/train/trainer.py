"""`apex_tpu_torch.train.Trainer` — one composable data- and
tensor-parallel train step.

Counterpart of ``apex_tpu/train/trainer.py``.  ``Trainer(config).build(
loss_fn, params, example_batch)`` returns a :class:`TrainStep` over the
``(dp, tp)`` process grid of :mod:`apex_tpu_torch.parallel_state` (one
process per rank) with:

- this rank's shards cut out of the GLOBAL ``params`` (the same nested
  dict of tensors on every rank) by the config's regex ->
  PartitionSpec rule table over ``tree_paths`` (a leaf no rule covers
  fails the build naming its path), and its rows of every batch by the
  batch rules;
- the gradient sync through :mod:`apex_tpu_torch.parallel.comm`
  (``wire``/``chunks``/``block``/``min_sync_size``);
- the weight update sharded across dp when the heuristic says it pays
  (:func:`apex_tpu_torch.train.sharding.decide_update_sharding`: the
  port's ``DistributedFusedAdam``/``DistributedFusedLAMB``), else the
  replicated functional optimizer of :func:`apex_tpu_torch.optimizers.
  by_name`;
- a :class:`~apex_tpu_torch.observability.MetricRegistry` fold on the
  device (``registry.update`` on device tensors, fetched on the
  registry's cadence: no host read a step) and :meth:`TrainStep.fit`
  over :func:`apex_tpu_torch.resilience.run_resilient` with goodput
  accounting.

A step is ``state, aux = step(state, batch)``: ``state`` is
``{"params": <local shards>, "opt": <optimizer state>}`` (the ZeRO state
wrapped in :class:`apex_tpu_torch.checkpoint.PerRank`: each rank saves
its own shard) and ``aux`` holds the dp-mean ``loss`` (a device scalar),
``grad_norm`` when tracked and the folded ``metrics``.  ``loss_fn(params,
batch)`` sees this rank's shards and rows; tensor-parallel collectives
inside it (the ``transformer.tensor_parallel`` mappings) run on the tp
group.  :func:`module_loss` turns a loss over an ``nn.Module`` into such
a function (binding the shards into the module's parameter slots).

**Self-verifying builds.**  The reference runs its HLO analysis over the
compiled step.  :meth:`TrainStep.verify` runs one step on a copy of the
state (the RNG forked, so the run itself is untouched) and makes three
checks, each with findings in an :class:`~apex_tpu_torch.analysis.
sharding.Report`:

- **plan** — the step's collective call log (``comm.collective_log``)
  against ``expect_plan`` (``comm.sync_plan``/``comm.zero_plan`` plus
  the model's declared collectives, ``allow_unplanned_bytes`` of
  slack);
- **sharding** — every state leaf's shape against ``local_shape`` of its
  spec; a leaf the rules shard but the state holds whole, above
  ``min_shard_bytes``, is an ERROR;
- **memory** — on the card ``torch.cuda.max_memory_allocated`` over the
  step against ``hbm_budget``; on the CPU the state's bytes.

``verify="error"`` raises :class:`TrainBuildError` with the rendered
report, ``"warn"`` prints it, ``"off"`` skips the checks.
"""

from __future__ import annotations

import copy
import math
import sys
from typing import Any, Callable

import torch

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.analysis.sharding import (
    ERROR,
    WARNING,
    Finding,
    P,
    Report,
    flatten_up_to,
    spec_dim_factors,
    tree_leaves,
    tree_map,
    tree_paths,
    tree_unflatten,
)
from apex_tpu_torch.analysis import memory
from apex_tpu_torch.analysis import passes as analysis_passes
from apex_tpu_torch.analysis.findings import make_finding
from apex_tpu_torch.checkpoint import PerRank
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.parallel import comm
from apex_tpu_torch.train import sharding as tsh
from apex_tpu_torch.train.config import TrainConfig
from apex_tpu_torch.train.sharding import ZERO_TWINS  # noqa: F401

__all__ = ["Trainer", "TrainStep", "TrainBuildError", "ZERO_TWINS",
           "module_loss", "module_params"]

_DP = ps.DATA_PARALLEL_AXIS
_TP = ps.TENSOR_PARALLEL_AXIS


class TrainBuildError(RuntimeError):
    """A trainer build that failed its own verification (or whose config
    cannot be realized on this process group)."""


# ---------------------------------------------------------------------------
# nn.Module <-> a params tree
# ---------------------------------------------------------------------------


def module_params(module: torch.nn.Module) -> dict:
    """The module's parameters as a flat dict keyed by ``/``-joined
    paths (``"blocks/0/attn/qkv/weight"``), detached: the ``params``
    tree :meth:`Trainer.build` and :func:`module_loss` take."""
    return {name.replace(".", "/"): p.detach()
            for name, p in module.named_parameters()}


def module_loss(module: torch.nn.Module, fn: Callable) -> Callable:
    """``loss_fn(params, batch)`` computing ``fn(module, batch)`` on
    ``params`` (a :func:`module_params` tree, or this rank's shards of
    one): each call binds the given tensors into the module's parameter
    slots (every name of a tied parameter) and leaves them there.  Not
    ``torch.func.functional_call``: its substitution ends when the
    forward returns, and a remat recompute (``torch.utils.checkpoint``)
    re-runs the forward in the backward, where it would read the
    module's own, stale weights."""
    slots: dict = {}
    for name, p in module.named_parameters(remove_duplicate=False):
        slots.setdefault(id(p), []).append(name)
    aliases = {names[0].replace(".", "/"): names for names in slots.values()}

    def loss_fn(params, batch):
        for path, t in tree_paths(params):
            for name in aliases[path]:
                owner, _, leaf = name.rpartition(".")
                module.get_submodule(owner)._parameters[leaf] = t
        return fn(module, batch)

    return loss_fn


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _axis_names(entry):
    names = entry if isinstance(entry, (tuple, list)) else (entry,)
    return [n for n in names if n is not None]


def _slice_mine(leaf, spec):
    """This rank's shard of a global leaf: every dim ``spec`` assigns to
    dp or tp cut to this rank's block."""
    out = leaf
    for axis in (_DP, _TP):
        if ps.axis_size(axis) > 1:
            out = tsh.slice_local(out, spec, axis, ps.axis_rank(axis),
                                  ps.axis_size(axis))
    return out


def _tp_varying(spec) -> bool:
    return any(_TP in _axis_names(e)
               for e in (tuple(spec) if spec is not None else ()))


def _meta(t):
    """A storage-less stand-in of a shape (a tree leaf, unlike a tuple)."""
    return torch.empty(tuple(getattr(t, "shape", t)), device="meta")


def _mirror_shapes(opt_state, shapes: dict):
    """The global shapes of a functional optimizer state: a field keyed
    like the params takes their shapes, any other leaf is a scalar."""
    def field(sub):
        if isinstance(sub, dict) and set(sub) == set(shapes):
            return {k: shapes[k] for k in sub}
        return tree_map(lambda _: _meta(()), sub)

    if hasattr(opt_state, "_fields"):
        return type(opt_state)(*(field(f) for f in opt_state))
    if isinstance(opt_state, dict):
        return {k: field(v) for k, v in opt_state.items()}
    return field(opt_state)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _clone_state(state):
    """A deep copy of a state tree (tensors cloned)."""
    if isinstance(state, PerRank):
        return PerRank(_clone_state(state.tree))
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, dict):
        return {k: _clone_state(v) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_clone_state(v) for v in state))
    if isinstance(state, (list, tuple)):
        return type(state)(_clone_state(v) for v in state)
    return copy.copy(state)


def _global_grad_norm(grads, tp_varying, tp: int):
    """Global L2 norm of dp-synced gradients whose leaves may be
    tp-sharded: the tp-sharded square sums add over tp, replicated
    leaves count once."""
    dev = grads[0].device
    sq_rep = torch.zeros((), dtype=torch.float32, device=dev)
    sq_tp = torch.zeros((), dtype=torch.float32, device=dev)
    for g, v in zip(grads, tp_varying):
        s = g.float().square().sum()
        if v:
            sq_tp = sq_tp + s
        else:
            sq_rep = sq_rep + s
    if tp > 1 and any(tp_varying):
        comm.all_reduce(sq_tp, ps.get_group(_TP))
    return (sq_rep + sq_tp).sqrt()


# ---------------------------------------------------------------------------
# the plan check (the call log against a declared plan)
# ---------------------------------------------------------------------------


def check_plan(records, plan: dict) -> list:
    """Findings of a step's collective call log (``records``, one dict a
    call: kind, axis, dtype, bytes) against ``plan`` (``{"collectives":
    [{kind, axis, count, bytes: [lo, hi], dtypes}], "allow_unplanned_
    bytes"}``): a planned group whose count, summed bytes or dtypes
    differ, a planned group that never ran, or an unplanned group above
    the tolerance is an ERROR (rule ``reshard-plan``, the reference's
    name for the same check over compiled HLO)."""
    seen: dict = {}
    for r in records:
        g = seen.setdefault((r["kind"], r["axis"]),
                            {"count": 0, "bytes": 0, "dtypes": set()})
        g["count"] += 1
        g["bytes"] += r["bytes"]
        g["dtypes"].add(r["dtype"])
    planned: dict = {}
    for e in plan.get("collectives", ()):
        p = planned.setdefault((e["kind"], e.get("axis")),
                               {"count": 0, "lo": 0, "hi": 0, "dtypes": set()})
        b = e.get("bytes")
        lo, hi = (b if isinstance(b, (list, tuple)) else (b, b)) \
            if b is not None else (0, math.inf)
        p["count"] = None if (p["count"] is None or e.get("count") is None) \
            else p["count"] + e["count"]
        p["lo"] += lo
        p["hi"] += hi
        p["dtypes"].update(e.get("dtypes") or ())
    out = []
    for key, p in planned.items():
        where = f"{key[0]} over {key[1]}"
        g = seen.pop(key, None)
        if g is None:
            if p["count"]:
                out.append(Finding(
                    "reshard-plan", ERROR, where,
                    f"missing: planned {p['count']} call(s), the step "
                    "issued none"))
            continue
        if p["count"] is not None and g["count"] != p["count"]:
            out.append(Finding(
                "reshard-plan", ERROR, where,
                f"{g['count']} call(s), the plan says {p['count']}"))
        if not p["lo"] <= g["bytes"] <= p["hi"]:
            out.append(Finding(
                "reshard-plan", ERROR, where,
                f"{g['bytes']} bytes, the plan allows [{p['lo']}, "
                f"{p['hi']}]"))
        if p["dtypes"] and not g["dtypes"] <= p["dtypes"]:
            out.append(Finding(
                "reshard-plan", ERROR, where,
                f"dtypes {sorted(g['dtypes'])}, the plan allows "
                f"{sorted(p['dtypes'])}"))
    tol = int(plan.get("allow_unplanned_bytes", 0))
    for key, g in seen.items():
        sev = ERROR if g["bytes"] > tol else WARNING
        out.append(Finding(
            "reshard-plan", sev, f"{key[0]} over {key[1]}",
            f"{g['count']} unplanned call(s), {g['bytes']} bytes "
            f"(tolerance {tol})",
            "declare the model's collectives in TrainConfig."
            "model_collectives"))
    return out


def _graph_findings(record) -> list:
    """The transfer and promotion (f64) passes over a recorded step."""
    from apex_tpu_torch import analysis

    return analysis.lint_graph(record,
                               rules=("transfer", "promotion")).findings


def check_shapes(named, mesh: dict, min_bytes: int) -> list:
    """Findings of ``[(path, local leaf, global shape, spec)]``: a leaf
    whose shape is not ``local_shape(global, spec)`` is an ERROR (a leaf
    the rules shard but held whole is ``sharding-replicated``, forgiven
    under ``min_bytes``)."""
    out = []
    for path, leaf, shape, spec in named:
        want = tsh.local_shape(shape, spec, mesh)
        have = tuple(leaf.shape)
        if have == want:
            continue
        nbytes = leaf.numel() * leaf.element_size()
        if have == tuple(shape):
            if nbytes < min_bytes:
                continue
            out.append(Finding(
                "sharding-replicated", ERROR, path,
                f"held whole {have} ({nbytes} bytes) where the rules shard "
                f"it {spec!r} to {want}"))
        else:
            out.append(Finding(
                "sharding-mismatch", ERROR, path,
                f"local shape {have}, the spec {spec!r} gives {want}"))
    return out


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


class Trainer:
    """Build data- and tensor-parallel train steps from a
    :class:`~apex_tpu_torch.train.TrainConfig`."""

    def __init__(self, config: TrainConfig):
        self.config = config

    # -- the process grid -----------------------------------------------
    def mesh(self) -> ps.ProcessMesh:
        """The ``(dp, tp)`` grid over the ``torch.distributed`` world
        (initializing ``parallel_state`` at the config's tp when it is
        not yet); raises :class:`TrainBuildError` when the world does not
        hold dp·tp processes."""
        cfg = self.config
        d = torch.distributed
        world = d.get_world_size() if (d.is_available()
                                       and d.is_initialized()) else 1
        need = cfg.dp * cfg.tp
        if world != need:
            raise TrainBuildError(
                f"mesh {cfg.mesh_dict()} needs {need} processes, the "
                f"torch.distributed world has {world} (start one process "
                "per rank)")
        if ps.model_parallel_is_initialized():
            if (ps.axis_size(_DP), ps.axis_size(_TP)) != (cfg.dp, cfg.tp):
                raise TrainBuildError(
                    f"parallel_state holds dp={ps.axis_size(_DP)} "
                    f"tp={ps.axis_size(_TP)}, the config {cfg.mesh_dict()}")
        else:
            ps.initialize_model_parallel(cfg.tp)
        return ps.get_mesh()

    # -- optimizer resolution -------------------------------------------
    # One optimizer_kwargs vocabulary serves both realizations: the
    # functional factories spell the moments beta1=/beta2=, the ZeRO
    # twins betas=(b1, b2) — translated here, because the heuristic may
    # flip a config between the two modes as the model grows.

    def _replicated_tx(self):
        cfg = self.config
        name = cfg.optimizer_name()
        if name is None:
            return cfg.optimizer
        from apex_tpu_torch import optimizers

        kwargs = dict(cfg.optimizer_kwargs)
        if "betas" in kwargs:
            kwargs["beta1"], kwargs["beta2"] = kwargs.pop("betas")
        factory = optimizers.by_name(name)
        return factory(learning_rate=cfg.learning_rate, **kwargs)

    def _distributed_tx(self):
        cfg = self.config
        from apex_tpu_torch.parallel import (
            DistributedFusedAdam,
            DistributedFusedLAMB,
        )

        cls = {"adam": DistributedFusedAdam, "lamb": DistributedFusedLAMB}[
            cfg.optimizer_name()
        ]
        kwargs = dict(cfg.optimizer_kwargs)
        if "beta1" in kwargs or "beta2" in kwargs:
            kwargs["betas"] = (
                kwargs.pop("beta1", 0.9), kwargs.pop("beta2", 0.999),
            )
        return cls(lr=cfg.learning_rate, axis_name=_DP, wire=cfg.wire,
                   param_wire=cfg.param_wire, chunks=cfg.chunks,
                   block=cfg.block, **kwargs)

    # -- the build ------------------------------------------------------
    def build(self, loss_fn: Callable[[Any, Any], Any], params,
              example_batch, *, name: str = "train") -> "TrainStep":
        """Compose and verify the step.  ``params`` and ``example_batch``
        are GLOBAL trees of tensors, the same on every rank; the build
        moves them to the config's device and cuts this rank's shards."""
        cfg = self.config
        dev = resolve_device(cfg.device)
        self.mesh()
        mesh_dict = cfg.mesh_dict()
        params = tree_map(lambda t: t.detach().to(dev), params)
        example_batch = tree_map(lambda t: t.to(dev), example_batch)

        try:
            param_specs = tsh.resolve_param_specs(cfg.rules, params)
        except ValueError as e:
            raise TrainBuildError(str(e)) from e
        batch_specs = tsh.resolve_batch_specs(cfg.batch_rules, example_batch)
        decision = tsh.decide_update_sharding(params, cfg, param_specs)
        if decision.shard and cfg.track_grad_norm and cfg.tp > 1:
            raise TrainBuildError(
                "track_grad_norm with a tp axis needs the replicated "
                "update path (the ZeRO flat buffer duplicates "
                "tp-replicated leaves across groups, so a flat-shard "
                "norm would overcount them): set "
                "update_sharding='replicate' or drop track_grad_norm"
            )
        spec_leaves = tsh._spec_leaves(param_specs, params)
        tp_varying = [_tp_varying(s) for s in spec_leaves]
        local = tree_unflatten(params, [
            _slice_mine(l, s).clone() for l, s in
            zip(tree_leaves(params), spec_leaves)])

        registry = None
        if cfg.metrics:
            from apex_tpu_torch.observability.metrics import MetricRegistry

            registry = MetricRegistry(fetch_every=cfg.fetch_every,
                                      device=dev)
            registry.gauge("train/loss", unit="loss")
            if cfg.track_grad_norm:
                registry.gauge("train/grad_norm")

        # the global shapes as meta tensors (tree leaves, no storage)
        global_shapes = tree_map(_meta, params)
        if decision.shard:
            tx = self._distributed_tx()
            tx.init(tree_leaves(local), world=cfg.dp)
            fspec = tx.spec
            st = tx.state
            opt = PerRank({"count": st.count, "m": st.m, "v": st.v,
                           "master": st.master})
            flat_spec = P((_TP, _DP)) if cfg.tp > 1 else P(_DP)
            flat_global = (cfg.tp * fspec.padded_size,)
            opt_specs = {"count": P(), "m": flat_spec, "v": flat_spec,
                         "master": flat_spec}
            opt_shapes = {"count": _meta(()), "m": _meta(flat_global),
                          "v": _meta(flat_global),
                          "master": _meta(flat_global)}
            plan_entries = comm.zero_plan(
                fspec.flat_size, cfg.dp, _DP, wire=cfg.wire,
                param_wire=cfg.param_wire, chunks=cfg.chunks,
                block=cfg.block)
        else:
            tx = self._replicated_tx()
            opt = tx.init(dict(tree_paths(local)))
            flat_specs = dict(zip([p for p, _ in tree_paths(params)],
                                  spec_leaves))
            opt_specs = tsh.mirror_optimizer_specs(
                opt, dict(tree_paths(local)), flat_specs)
            shapes = dict(tree_paths(global_shapes))
            opt_shapes = _mirror_shapes(opt, shapes)
            local_sizes = [int(t.numel()) for t in tree_leaves(local)]
            plan_entries = comm.sync_plan(
                local_sizes, cfg.dp, _DP, wire=cfg.wire, chunks=cfg.chunks,
                block=cfg.block, min_size=cfg.min_sync_size)

        state = {"params": local, "opt": opt}
        state_specs = {"params": param_specs, "opt": opt_specs}
        expect_plan = {
            "mesh": mesh_dict,
            "collectives": list(plan_entries) + list(cfg.model_collectives),
            "allow_unplanned_bytes": cfg.unplanned_tolerance,
        }
        expect_sharding = {
            "mesh": mesh_dict,
            "rules": tsh.exact_entry_rules([
                ("state/params", params, param_specs),
                ("batch", example_batch, batch_specs),
            ]),
            "min_bytes": cfg.min_shard_bytes,
        }
        step = TrainStep(
            trainer=self, name=name, device=dev, state=state,
            state_specs=state_specs, batch_specs=batch_specs,
            registry=registry, decision=decision,
            expect_sharding=expect_sharding, expect_plan=expect_plan,
            example_batch=example_batch, loss_fn=loss_fn, tx=tx,
            global_shapes={"params": global_shapes, "opt": opt_shapes},
            tp_varying=tp_varying,
        )
        if cfg.verify != "off":
            step.report = step.verify(example_batch)
            errors = step.report.errors()
            if errors and cfg.verify == "error":
                raise TrainBuildError(
                    "trainer build failed its own verification "
                    f"({len(errors)} ERROR finding(s)):\n"
                    + step.report.render()
                )
            if step.report.findings and cfg.verify == "warn":
                print(step.report.render(), file=sys.stderr)
        return step

    def build_guarded(self, loss_fn, params, **kwargs):
        """The two-program guarded-amp shape — see
        :func:`apex_tpu_torch.train.guarded.build_guarded`."""
        from apex_tpu_torch.train.guarded import build_guarded

        return build_guarded(self, loss_fn, params, **kwargs)


class TrainStep:
    """A built step: ``state, aux = step(state, batch)``, plus what the
    verification and run layers need (the state, its specs, the declared
    plans, the registry, the build's report)."""

    def __init__(self, *, trainer, name, device, state, state_specs,
                 batch_specs, registry, decision, expect_sharding,
                 expect_plan, example_batch, loss_fn, tx, global_shapes,
                 tp_varying):
        self.trainer = trainer
        self.config = trainer.config
        self.name = name
        self.device = device
        self.state = state
        self.state_specs = state_specs
        self.batch_specs = batch_specs
        self.registry = registry
        self.metrics_state = registry.init() if registry is not None else None
        self.decision = decision
        self.expect_sharding = expect_sharding
        self.expect_plan = expect_plan
        self.example_batch = example_batch
        self.loss_fn = loss_fn
        self.tx = tx
        self.global_shapes = global_shapes
        self.tp_varying = tp_varying
        self.report = None
        self.goodput = None

    @property
    def mode(self) -> str:
        """``"zero"`` (update sharded across dp) or ``"ddp"``."""
        return self.decision.mode

    def collective_plan(self) -> dict:
        """The plan this step promises (the reference's plan schema);
        what :meth:`verify` holds the call log to."""
        return self.expect_plan

    # -- the step -------------------------------------------------------
    def local_batch(self, batch):
        """This rank's rows of a global batch (the batch rules' dp
        slice, and any tp slice they ask for)."""
        specs = flatten_up_to(batch, self.batch_specs) if not isinstance(
            self.batch_specs, P) else [self.batch_specs]
        leaves = tree_leaves(batch)
        return tree_unflatten(batch, [
            _slice_mine(t.to(self.device), s)
            for t, s in zip(leaves, specs)])

    def __call__(self, state, batch):
        """One step on a GLOBAL batch; returns ``(new_state, aux)``."""
        cfg = self.config
        batch = self.local_batch(batch)
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(state["params"])]
        params = tree_unflatten(state["params"], leaves)
        loss = self.loss_fn(params, batch)
        grads = list(torch.autograd.grad(loss, leaves))
        loss = loss.detach()
        aux = {}
        with torch.no_grad():
            if self.decision.shard:
                new_params, new_opt, gnorm = self._zero_update(
                    state, leaves, grads)
                loss = comm.mean_over(loss, _DP)
            else:
                if cfg.dp > 1:
                    comm.sync_gradients(
                        grads, _DP, wire=cfg.wire, chunks=cfg.chunks,
                        block=cfg.block, min_size=cfg.min_sync_size)
                    loss = comm.mean_over(loss, _DP)
                gnorm = (_global_grad_norm(grads, self.tp_varying, cfg.tp)
                         if cfg.track_grad_norm else None)
                paths = [p for p, _ in tree_paths(state["params"])]
                flat_p = dict(zip(paths, leaves))
                updates, new_opt = self.tx.update(
                    dict(zip(paths, grads)), state["opt"], flat_p)
                new_params = tree_unflatten(state["params"], [
                    (p + updates[k].to(p.dtype)).detach()
                    for k, p in flat_p.items()])
            aux["loss"] = loss
            if gnorm is not None:
                aux["grad_norm"] = gnorm
            if self.registry is not None:
                folded = {"train/loss": loss}
                if gnorm is not None:
                    folded["train/grad_norm"] = gnorm
                aux["metrics"] = self.registry.update(self.metrics_state,
                                                      folded)
        return {"params": new_params, "opt": new_opt}, aux

    def _zero_update(self, state, leaves, grads):
        """The ZeRO update of one step: reduce-scatter, the shard's
        update, all-gather into new parameter tensors."""
        from apex_tpu_torch.parallel.distributed_fused_optimizers import (
            _State,
        )

        dist = self.tx
        o = state["opt"].tree
        dist.state = _State(o["count"], o["m"].clone(), o["v"].clone(),
                            o["master"])
        g = dist.reduce_scatter_grads(grads)
        gnorm = None
        if self.config.track_grad_norm:
            # exact: the reduce-scattered shards partition the buffer
            sq = (g * g).sum()
            comm.all_reduce(sq, ps.get_group(_DP))
            gnorm = sq.sqrt()
        new_master, st = dist._shard_update(g, dist.state)
        new_leaves = [torch.empty_like(p) for p in leaves]
        dist.gather_params(new_master, new_leaves)
        new_opt = PerRank({"count": st.count, "m": st.m, "v": st.v,
                           "master": st.master})
        return (tree_unflatten(state["params"], new_leaves), new_opt,
                gnorm)

    # -- placement --------------------------------------------------------
    def place(self, state):
        """A state whose params hold GLOBAL leaves (restored from a
        one-process checkpoint, or drawn anew) cut to this rank's shards;
        a state already in local shapes passes through unchanged."""
        specs = tsh._spec_leaves(self.state_specs["params"],
                                 state["params"])
        shapes = tree_leaves(self.global_shapes["params"])
        new = []
        for leaf, spec, shape in zip(tree_leaves(state["params"]), specs,
                                     shapes):
            if leaf.shape == shape.shape and any(
                    f > 1 for f in spec_dim_factors(
                        spec, self.config.mesh_dict(), leaf.dim())):
                leaf = _slice_mine(leaf, spec).contiguous()
            new.append(leaf.to(self.device))
        return dict(state, params=tree_unflatten(state["params"], new))

    def n_params(self) -> int:
        """The model's (global) parameter count."""
        return sum(s.numel() for s in
                   tree_leaves(self.global_shapes["params"]))

    def tokens_per_step(self) -> int:
        leaves = tree_leaves(self.example_batch)
        return int(leaves[0].shape[0]) if leaves else 0

    # -- verification ----------------------------------------------------
    def verify(self, batch=None, *, hbm_budget=None) -> Report:
        """Run one step on a copy of the state (the RNG forked) and hold
        it to the build's expectations: the plan, the shapes, the memory
        budget (module docstring).  Returns the :class:`Report`."""
        cfg = self.config
        batch = batch if batch is not None else self.example_batch
        budget = hbm_budget if hbm_budget is not None else cfg.hbm_budget
        report = Report(target=f"{self.name}/{self.mode}")
        mesh = cfg.mesh_dict()
        named = []
        for part in ("params", "opt"):
            tree = self.state[part]
            tree = tree.tree if isinstance(tree, PerRank) else tree
            for (path, leaf), shape, spec in zip(
                    tree_paths(tree),
                    tree_leaves(self.global_shapes[part]),
                    tsh._spec_leaves(self.state_specs[part], tree)):
                if isinstance(leaf, torch.Tensor):
                    named.append((f"state/{part}/{path}", leaf,
                                  tuple(shape.shape), spec))
        report.extend(check_shapes(named, mesh, cfg.min_shard_bytes))

        on_card = self.device.type == "cuda"
        devices = [self.device] if on_card else []
        saved = self.metrics_state
        with torch.random.fork_rng(devices=devices):
            from apex_tpu_torch.transformer.tensor_parallel.random import (
                get_tpu_rng_tracker,
            )

            tracker = get_tpu_rng_tracker()
            rng = tracker.get_states()
            copy_ = _clone_state(self.state)
            if self.registry is not None:
                self.metrics_state = self.registry.init()
            if on_card:
                torch.cuda.synchronize(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
            try:
                # a ZeRO state's PerRank shards named like the rest
                named_state = {k: v.tree if isinstance(v, PerRank) else v
                               for k, v in copy_.items()}
                with comm.collective_log() as log:
                    _, record = analysis_passes.capture(
                        lambda: self(copy_, batch),
                        named={"state": named_state, "batch": batch})
                if on_card:
                    torch.cuda.synchronize(self.device)
            finally:
                self.metrics_state = saved
                if rng:
                    tracker.set_states(rng)
        report.extend(check_plan(log, self.expect_plan))
        # the graph passes over the step just run: no host transfer, no
        # f64
        report.extend(_graph_findings(record))
        opt = self.state["opt"]
        peak = (torch.cuda.max_memory_allocated(self.device) if on_card
                else _nbytes({"params": self.state["params"], "opt":
                              opt.tree if isinstance(opt, PerRank) else opt}))
        report.sections["plan"] = comm.collective_summary(log)
        report.sections["memory"] = {"peak_bytes": int(peak),
                                     "estimate_bytes": memory.estimate_peak(
                                         record)["peak_bytes"],
                                     "budget": budget,
                                     "measured": "max_memory_allocated"
                                     if on_card else "state bytes"}
        if budget is not None and peak > budget:
            report.extend([make_finding(
                "memory-budget", self.name,
                f"{peak} bytes over the {budget}-byte budget")])
        report.record = record  # as analysis.check's reports carry it
        return report

    # -- the composed run loop ------------------------------------------
    def fit(
        self,
        batch_fn: Callable[[int], Any],
        num_steps: int,
        *,
        directory,
        save_interval_steps: int = 10,
        max_to_keep: int = 3,
        observer: Any = None,
        flight: Any = None,
        reporter: Any = None,
        report_every: int = 10,
        checkpoint: str = "async",
    ):
        """Drive the step under :func:`apex_tpu_torch.resilience.
        run_resilient` (auto-resume, SIGTERM-safe, checkpoint retries)
        with a :class:`~apex_tpu_torch.observability.GoodputAccountant` on
        the observer stream, a :class:`~apex_tpu_torch.observability.
        StepMeter` (``self.meter``) and a flight recorder armable from
        ``APEX_TPU_FLIGHT``.  ``checkpoint="async"`` saves through the
        :class:`~apex_tpu_torch.goodput.AsyncCheckpointEngine`, ``"sync"``
        on the step path; at world > 1 every rank writes its own shards
        (the ZeRO state) and rank 0 the replicated leaves; a resume
        restores into the build's state in place.  Returns the :class:`~apex_tpu_torch.resilience.runner.RunResult`;
        the goodput ledger lands on ``self.goodput``."""
        from apex_tpu_torch.observability.meter import (
            GoodputAccountant,
            StepMeter,
            transformer_train_flops,
        )
        from apex_tpu_torch.resilience import ObserverFanout, run_resilient

        tokens = self.tokens_per_step()
        meter = StepMeter(
            tokens_per_step=tokens,
            flops_per_step=transformer_train_flops(self.n_params(), tokens),
        )
        self.meter = meter
        goodput = GoodputAccountant()
        self.goodput = goodput
        registry = self.registry
        counter = {"step": 0}

        def step_fn(state, batch):
            new_state, aux = self(self.place(state), batch)
            counter["step"] += 1
            if registry is not None:
                registry.observe(counter["step"], aux["metrics"])
            meter.tick()
            if reporter is not None and counter["step"] % report_every == 0:
                reporter.report(counter["step"])
            return new_state, {"skipped": False, "loss": aux["loss"]}

        return run_resilient(
            step_fn,
            self.state,
            batch_fn,
            directory=directory,
            num_steps=num_steps,
            save_interval_steps=save_interval_steps,
            max_to_keep=max_to_keep,
            observer=ObserverFanout([goodput, observer]),
            flight=flight,
            checkpoint=checkpoint,
        )

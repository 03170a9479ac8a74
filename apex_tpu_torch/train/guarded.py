"""Guarded two-program steps — the resilient example's step shape.

Counterpart of ``apex_tpu/train/guarded.py``.  The fused
:meth:`Trainer.build` step is the default, but a chaos drill needs the
gradients to surface between their computation and the update, so the
chaos ``grads`` site can poison them.  :func:`build_guarded` composes
that two-program shape from the same config:

- ``compute_grads(params, scaler_state, batch) -> (loss, scaled)`` —
  this rank's rows of every microbatch (the batch leaves are
  ``(accum, rows, ...)``, rows split over dp) through the port's
  :class:`~apex_tpu_torch.parallel.DistributedDataParallel` (the config's
  ``wire``/``chunks``/``min_sync_size``; ``accum = K`` microbatches
  accumulate locally with one boundary sync), the gradients then
  multiplied by the loss scale, as the guard expects them;
- ``apply_update(scaled, state, loss) -> (state, verdict)`` —
  :func:`apex_tpu_torch.resilience.guarded_amp_update` (NaN and spike
  skips, the budget) with the metric fold on the device when a registry
  is given.

``params`` is a tree of tensors (replicated: tp must be 1 and the update
is never sharded).  The :class:`GuardedStep` carries the declared
``expect_sharding``/``expect_plan``; ``verify="error"|"warn"`` holds one
``compute_grads`` call's collective log to the plan at build.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable

import torch

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.analysis.sharding import (
    P,
    Report,
    tree_map,
    tree_paths,
    tree_unflatten,
)
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.train.trainer import TrainBuildError, check_plan

__all__ = ["GuardedStep", "build_guarded"]


@dataclasses.dataclass
class GuardedStep:
    """The two programs plus everything the example and the checks
    consume."""

    compute_grads: Callable
    apply_update: Callable
    state: Any
    mesh: Any
    dp: int
    ddp: Any  # the DistributedDataParallel engine (comm knobs live here)
    tx: Any
    scaler: Any
    guard: Any
    registry: Any
    shard_rules: list
    expect_sharding: dict
    expect_plan: dict
    report: Any = None


class _Holder(torch.nn.Module):
    """The params tree as parameters (what the DDP engine syncs), in
    ``tree_paths`` order."""

    def __init__(self, params):
        super().__init__()
        self.structure = params
        self.paths = [p for p, _ in tree_paths(params)]
        self.load(params)

    def load(self, params) -> None:
        self.leaves = torch.nn.ParameterList(
            [torch.nn.Parameter(t.detach()) for _, t in tree_paths(params)])

    def tree(self):
        return tree_unflatten(self.structure, list(self.leaves))

    def grads(self) -> dict:
        return {k: p.grad if p.grad is not None else torch.zeros_like(p)
                for k, p in zip(self.paths, self.leaves)}


def build_guarded(
    trainer,
    loss_fn: Callable[[Any, Any], Any],
    params,
    *,
    tx,
    scaler,
    guard,
    registry=None,
    accum: int = 1,
    verify: str = "off",
    example_batch=None,
) -> GuardedStep:
    """Compose the guarded two-program step from ``trainer``'s config
    (see the module docstring).  ``loss_fn(params, microbatch) ->
    scalar`` with ``microbatch`` a tuple of this rank's rows; ``tx`` a
    functional optimizer (``init``/``update`` over a dict keyed by the
    params' paths), ``scaler`` a loss scaler, ``guard`` a
    :class:`~apex_tpu_torch.resilience.GradGuard`."""
    from apex_tpu_torch.amp import DynamicLossScaler
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.resilience import guard_metrics, guarded_amp_update

    cfg = trainer.config
    if cfg.tp != 1:
        raise TrainBuildError(
            "build_guarded composes a replicated guarded-amp update; "
            f"tp={cfg.tp} needs the fused Trainer.build path"
        )
    if cfg.update_sharding == "shard":
        raise TrainBuildError(
            "build_guarded cannot shard the update (the guard needs the "
            "replicated tree); drop update_sharding='shard' or use "
            "Trainer.build"
        )
    dev = resolve_device(cfg.device)
    mesh = trainer.mesh()
    dp = cfg.dp
    params = tree_map(lambda t: t.detach().to(dev), params)
    holder = _Holder(params)
    ddp = DistributedDataParallel(
        holder, lambda m, *mb: loss_fn(m.tree(), tuple(mb)),
        wire=cfg.wire, chunks=cfg.chunks, block=cfg.block,
        min_size=cfg.min_sync_size,
    )
    state = {
        "params": params,
        "opt": tx.init(dict(tree_paths(params))),
        "scaler": scaler.init(dev),
        "guard": guard.init(dev),
    }
    if registry is not None:
        state["metrics"] = registry.init()

    def rows(b):
        # (accum, rows, ...) -> this rank's rows of every microbatch
        n = b.shape[1] // dp
        return b.to(dev).narrow(1, ps.axis_rank("dp") * n, n)

    def compute_grads(params, scaler_state, batch):
        holder.load(params)
        local = tuple(rows(b) for b in batch)
        if accum == 1:
            loss, _ = ddp.value_and_grad(*(b[0] for b in local))
        else:
            loss, _ = ddp.accum_value_and_grad(*local)
        with torch.no_grad():
            scaled = {k: scaler.scale(g, scaler_state)
                      for k, g in holder.grads().items()}
        return loss, scaled

    @torch.no_grad()
    def apply_update(scaled, state, loss):
        flat = dict(tree_paths(state["params"]))
        p, o, s, g, verdict = guarded_amp_update(
            tx, scaler, guard, scaled, state["opt"], flat,
            state["scaler"], state["guard"])
        new_state = {"params": tree_unflatten(state["params"],
                                              [p[k] for k in flat]),
                     "opt": o, "scaler": s, "guard": g}
        if registry is not None:
            # the metric fold on the device: the registry fetches on its
            # own cadence
            new_state["metrics"] = registry.update(state["metrics"], {
                "train/loss": loss,
                **guard_metrics(verdict, g, guard),
                **DynamicLossScaler.metrics(s),
            })
        return new_state, verdict

    shard_rules = [
        (r"^params(/|$)", P()),           # replicated: the DDP contract
        (r"^scaler", P()),
        (r"^batch(/|$)", P(None, "dp")),  # (accum, rows, feat)
    ]
    expect_sharding = {
        "mesh": {"dp": dp},
        "rules": shard_rules,
        "min_bytes": cfg.min_shard_bytes,
    }
    expect_plan = ddp.collective_plan(dp)
    step = GuardedStep(
        compute_grads=compute_grads, apply_update=apply_update, state=state,
        mesh=mesh, dp=dp, ddp=ddp, tx=tx, scaler=scaler, guard=guard,
        registry=registry, shard_rules=shard_rules,
        expect_sharding=expect_sharding, expect_plan=expect_plan,
    )
    if verify != "off":
        _verify_guarded(step, verify, example_batch)
    return step


def _verify_guarded(step: GuardedStep, level: str, example_batch) -> None:
    """One ``compute_grads`` call (the RNG forked) with its collective log
    held to ``expect_plan``."""
    from apex_tpu_torch.parallel import comm

    if example_batch is None:
        raise TrainBuildError(
            "build_guarded(verify=...) needs example_batch to run "
            "compute_grads on"
        )
    from apex_tpu_torch.analysis import memory, passes
    from apex_tpu_torch.train.trainer import _graph_findings

    dev = step.state["scaler"].loss_scale.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.random.fork_rng(devices=[dev] if on_card else []):
        with comm.collective_log() as log:
            _, record = passes.capture(
                lambda: step.compute_grads(step.state["params"],
                                           step.state["scaler"],
                                           example_batch),
                named={"params": step.state["params"],
                       "batch": example_batch})
    report = Report(check_plan(log, step.expect_plan) +
                    _graph_findings(record),
                    target="guarded/compute_grads",
                    sections={"plan": comm.collective_summary(log)})
    report.sections["memory"] = {
        "estimate_bytes": memory.estimate_peak(record)["peak_bytes"],
        "peak_bytes": (int(torch.cuda.max_memory_allocated(dev))
                       if on_card else None)}
    step.report = report
    if report.errors() and level == "error":
        raise TrainBuildError(
            "guarded build failed its own verification:\n" + report.render()
        )
    if report.findings:
        print(report.render(), file=sys.stderr)

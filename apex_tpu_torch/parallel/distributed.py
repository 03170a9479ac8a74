"""Data parallelism — counterpart of ``apex_tpu/parallel/distributed.py``
(≙ ``apex.parallel.DistributedDataParallel`` and ``Reducer``).

Each process computes the gradients of its own slice of the batch with
``backward()``; :class:`DistributedDataParallel` then syncs the
parameters' ``.grad`` in place over the dp group, through the engine of
:mod:`apex_tpu_torch.parallel.comm` (``wire``, ``chunks``, ``block``,
``min_size``), with the reference's averaging: ``gradient_average``
divides the sum by the world, ``gradient_predivide_factor`` divides
before the sum (and by world / factor after).  The sync runs after the
whole backward, as in the reference, where XLA schedules it; the
reference's bucketing knobs (``message_size``) have no counterpart.

Gradient accumulation: inside :meth:`~DistributedDataParallel.no_sync`
(or with ``delay_allreduce=True``) the gradients stay local and
accumulate in ``.grad`` across ``backward()`` calls; one
:meth:`~DistributedDataParallel.all_reduce_gradients` then syncs the
sum.  :meth:`~DistributedDataParallel.accum_value_and_grad` does that
over K microbatches, dividing by K under ``gradient_average``, so a step
over K equal microbatches equals one over their concatenation.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

import torch

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.parallel import comm

__all__ = ["all_reduce_gradients", "DistributedDataParallel", "Reducer"]


@torch.no_grad()
def all_reduce_gradients(grads: Any,
                         axis_name: str = ps.DATA_PARALLEL_AXIS,
                         gradient_average: bool = True,
                         gradient_predivide_factor: Optional[float] = None):
    """All-reduce gradient tensors (a tensor, or a dict or list of them)
    over ``axis_name`` in place, with the averaging and predivide rules;
    the exact per-tensor path.  Returns ``grads``."""
    return comm.sync_gradients(
        grads, axis_name, wire="f32", chunks=None, min_size=1 << 62,
        gradient_average=gradient_average,
        gradient_predivide_factor=gradient_predivide_factor,
    )


class DistributedDataParallel:
    """Data-parallel training of ``module``.

    ``loss_fn(module, *batch)`` returns this rank's scalar loss (default:
    ``module(*batch)``).  :meth:`value_and_grad` runs it and
    ``backward()``, syncs the gradients (unless inside :meth:`no_sync`
    or with ``delay_allreduce``) and returns the dp-mean loss and the
    gradients by parameter name.  ``.grad`` accumulates as usual in
    PyTorch: zero it between steps (:meth:`make_step` does).

    Usage::

        ddp = DistributedDataParallel(model, lambda m, ids: gpt_lm_loss(m, ids))
        step = ddp.make_step(optimizer)
        loss = step(ids_local)            # this rank's rows of the batch
    """

    def __init__(self, module: torch.nn.Module,
                 loss_fn: Optional[Callable] = None,
                 axis_name: str = ps.DATA_PARALLEL_AXIS,
                 gradient_average: bool = True,
                 gradient_predivide_factor: Optional[float] = None,
                 delay_allreduce: bool = False, wire: str = "f32",
                 chunks: Optional[int] = None,
                 block: int = comm.DEFAULT_BLOCK, min_size: int = 1024):
        self.module = module
        self.loss_fn = loss_fn or (lambda m, *batch: m(*batch))
        self.axis_name = axis_name
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.delay_allreduce = delay_allreduce
        self.wire = comm.check_wire(wire)
        self.chunks = chunks
        self.block = block
        self.min_size = min_size
        self._no_sync = False

    def parameters(self):
        return [p for p in self.module.parameters() if p.requires_grad]

    @contextlib.contextmanager
    def no_sync(self):
        """Inside, :meth:`value_and_grad` leaves the gradients local (they
        accumulate in ``.grad``); sync once afterwards with
        :meth:`all_reduce_gradients`."""
        prev = self._no_sync
        self._no_sync = True
        try:
            yield
        finally:
            self._no_sync = prev

    def collective_plan(self, world: Optional[int] = None) -> dict:
        """The collectives one sync promises (the reference's plan
        schema, :func:`~apex_tpu_torch.parallel.comm.sync_plan` over the
        module's parameters and this wrapper's knobs)."""
        world = ps.axis_size(self.axis_name) if world is None else int(world)
        return {
            "mesh": {self.axis_name: world},
            "collectives": comm.sync_plan(
                self.parameters(), world, self.axis_name, wire=self.wire,
                chunks=self.chunks, block=self.block,
                min_size=self.min_size),
        }

    def all_reduce_gradients(self, grads: Any = None):
        """Sync ``grads`` (default: every parameter's ``.grad``) in place
        with this wrapper's engine settings; returns them."""
        if grads is None:
            grads = [p.grad for p in self.parameters() if p.grad is not None]
        return comm.sync_gradients(
            grads, self.axis_name, wire=self.wire, chunks=self.chunks,
            block=self.block, min_size=self.min_size,
            gradient_average=self.gradient_average,
            gradient_predivide_factor=self.gradient_predivide_factor,
        )

    def _grads(self) -> Dict[str, torch.Tensor]:
        return {name: p.grad for name, p in self.module.named_parameters()
                if p.grad is not None}

    def value_and_grad(self, *batch):
        """``loss_fn`` and ``backward()`` on this rank's batch, then the
        sync (skipped inside :meth:`no_sync` or with
        ``delay_allreduce``).  Returns ``(loss, grads)``: the dp-mean
        loss when synced (this rank's otherwise) and ``{name: .grad}``."""
        loss = self.loss_fn(self.module, *batch)
        loss.backward()
        if self.delay_allreduce or self._no_sync:
            return loss.detach(), self._grads()
        self.all_reduce_gradients()
        return comm.mean_over(loss, self.axis_name), self._grads()

    def accum_value_and_grad(self, *batch):
        """K-microbatch accumulation: every tensor of ``batch`` carries a
        leading ``(K, ...)`` microbatch axis; the K gradients accumulate
        locally, are divided by K under ``gradient_average``, and sync
        once.  Returns ``(loss, grads)``: the dp-mean of the mean
        microbatch loss, and the synced gradients."""
        k = batch[0].shape[0]
        losses = []
        with self.no_sync():
            for i in range(k):
                loss, _ = self.value_and_grad(*(b[i] for b in batch))
                losses.append(loss)
        if self.gradient_average:
            with torch.no_grad():
                for p in self.parameters():
                    if p.grad is not None:
                        p.grad.div_(k)
        self.all_reduce_gradients()
        return comm.mean_over(torch.stack(losses).mean(), self.axis_name), \
            self._grads()

    def make_step(self, optimizer: torch.optim.Optimizer,
                  accum_steps: int = 1) -> Callable:
        """A train step ``step(*batch) -> loss``: zero the gradients,
        :meth:`value_and_grad` (or :meth:`accum_value_and_grad` over
        ``(accum_steps, ...)`` microbatches), ``optimizer.step()``."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

        def step(*batch):
            optimizer.zero_grad(set_to_none=True)
            if accum_steps == 1:
                loss, _ = self.value_and_grad(*batch)
            else:
                if batch[0].shape[0] != accum_steps:
                    raise ValueError(
                        f"batch leads with {batch[0].shape[0]} microbatches, "
                        f"accum_steps={accum_steps}")
                loss, _ = self.accum_value_and_grad(*batch)
            optimizer.step()
            return loss

        return step


class Reducer:
    """Manual reduction over the dp group (≙ apex's ``Reducer``):
    :meth:`broadcast_params` copies rank 0's parameters to every rank,
    :meth:`reduce` all-reduces tensors in place (the mean with
    ``average``)."""

    def __init__(self, module_or_params=None,
                 axis_name: str = ps.DATA_PARALLEL_AXIS):
        self.axis_name = axis_name
        if isinstance(module_or_params, torch.nn.Module):
            module_or_params = list(module_or_params.parameters())
        self.params = list(module_or_params or [])

    @torch.no_grad()
    def broadcast_params(self, params=None):
        params = self.params if params is None else comm._leaves(params)
        group = ps.get_group(self.axis_name)
        if group is not None:
            src = ps.get_mesh().ranks[self.axis_name][0]
            for p in params:
                comm.broadcast(p.data, src, group)
        return params

    @torch.no_grad()
    def reduce(self, tree, average: bool = True):
        return comm.sync_gradients(tree, self.axis_name, wire="f32",
                                   min_size=1 << 62,
                                   gradient_average=average)

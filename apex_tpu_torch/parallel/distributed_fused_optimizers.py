"""ZeRO-style optimizers: the weight update sharded over the dp group.

Counterpart of ``apex_tpu/parallel/distributed_fused_optimizers.py``
(≙ apex's ``contrib.optimizers.DistributedFusedAdam`` /
``DistributedFusedLamb``).  Every parameter lives in one flat f32
buffer, padded to a multiple of the dp world; each rank owns one
contiguous shard of it.  A step:

1. reduce-scatters the ranks' local gradients into this rank's shard
   (:func:`~apex_tpu_torch.parallel.comm.reduce_scatter_flat`, at
   ``wire``, chunked), divided by the world under ``gradient_average``;
2. updates the shard of the f32 master weights with the moments of that
   shard (the arithmetic of the port's ``fused_adam`` / ``fused_lamb``;
   LAMB's per-tensor norms are summed over each tensor's pieces in
   every shard by segment ids, as in the reference: a shard boundary
   need not fall on a tensor boundary);
3. all-gathers the updated shards into the parameters
   (:func:`~apex_tpu_torch.parallel.comm.all_gather_flat`, at
   ``param_wire or wire``).

So each rank keeps 1/world of the optimizer state.  The master shard is
the authoritative value: a lossy ``param_wire`` rounds the working
copy the forward reads, never the accumulator.  Gradients handed in must
be local (not yet synced).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.optimizers.fused_adam import _adam_step, _lr_at
from apex_tpu_torch.parallel import comm

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB",
           "DistributedFusedLamb"]


class _FlatSpec(NamedTuple):
    flat_size: int
    padded_size: int
    shard_size: int
    world: int
    n_leaves: int
    segment_ids: torch.Tensor  # (padded,) leaf index; the pad -> n_leaves


def _make_spec(params: List[torch.Tensor], world: int) -> _FlatSpec:
    sizes = [p.numel() for p in params]
    flat_size = sum(sizes)
    shard = -(-flat_size // world)
    padded = shard * world
    seg = torch.full((padded,), len(params), dtype=torch.long)
    off = 0
    for i, n in enumerate(sizes):
        seg[off:off + n] = i
        off += n
    return _FlatSpec(flat_size, padded, shard, world, len(params), seg)


def _flatten_pad(tensors, spec: _FlatSpec) -> torch.Tensor:
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    return F.pad(flat, (0, spec.padded_size - spec.flat_size))


class _State(NamedTuple):
    count: int
    m: torch.Tensor       # (shard,) this rank's moments
    v: torch.Tensor
    master: torch.Tensor  # (shard,) f32 authoritative weights


class _DistributedFusedBase:
    def __init__(self, params=None, axis_name: str = ps.DATA_PARALLEL_AXIS,
                 wire: str = "f32", chunks: Optional[int] = None,
                 block: int = comm.DEFAULT_BLOCK,
                 param_wire: Optional[str] = None):
        self.axis_name = axis_name
        self.wire = comm.check_wire(wire)
        self.chunks = chunks
        self.block = block
        self.param_wire = (comm.check_wire(param_wire)
                           if param_wire is not None else None)
        self._spec: Optional[_FlatSpec] = None
        self.params: Optional[List[torch.Tensor]] = None
        self.state: Optional[_State] = None
        if params is not None:
            self.init(params)

    # -- set-up ----------------------------------------------------------
    def init(self, params, world: Optional[int] = None) -> _State:
        """Lay out ``params`` (a module, or an iterable of tensors) in
        the flat buffer and seed this rank's master shard from them."""
        if isinstance(params, torch.nn.Module):
            params = params.parameters()
        self.params = [p for p in params]
        world = ps.axis_size(self.axis_name) if world is None else int(world)
        self._spec = _make_spec(self.params, world)
        self._seg = None
        with torch.no_grad():
            master = self.my_param_shard().clone()
        zeros = torch.zeros_like(master)
        self.state = _State(0, zeros, zeros.clone(), master)
        return self.state

    @property
    def spec(self) -> _FlatSpec:
        if self._spec is None:
            raise RuntimeError("call init(params) first")
        return self._spec

    def collective_plan(self) -> dict:
        """The collectives one step promises (the reference's plan
        schema, :func:`~apex_tpu_torch.parallel.comm.zero_plan` on this
        optimizer's flat spec)."""
        spec = self.spec
        return {
            "mesh": {self.axis_name: spec.world},
            "collectives": comm.zero_plan(
                spec.flat_size, spec.world, self.axis_name, wire=self.wire,
                param_wire=self.param_wire, chunks=self.chunks,
                block=self.block),
        }

    # -- the sharded step's pieces ----------------------------------------
    def _rank_slice(self, flat: torch.Tensor) -> torch.Tensor:
        s = self.spec.shard_size
        r = ps.axis_rank(self.axis_name)
        return flat[r * s:(r + 1) * s]

    @torch.no_grad()
    def reduce_scatter_grads(self, grads=None,
                             gradient_average: bool = True) -> torch.Tensor:
        """This rank's shard of the summed local gradients (default: the
        parameters' ``.grad``, zeros for a parameter without one), f32,
        divided by the world under ``gradient_average``."""
        spec = self.spec
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        shard = comm.reduce_scatter_flat(
            _flatten_pad(comm._leaves(grads), spec), self.axis_name,
            wire=self.wire, chunks=self.chunks, block=self.block)
        if gradient_average:
            shard = shard / spec.world
        return shard

    @torch.no_grad()
    def my_param_shard(self, params=None) -> torch.Tensor:
        params = self.params if params is None else comm._leaves(params)
        return self._rank_slice(_flatten_pad(params, self.spec))

    def my_segment_ids(self) -> torch.Tensor:
        """The tensor index of each element of this rank's shard (the
        pad's is ``n_leaves``)."""
        if self._seg is None:
            self._seg = self._rank_slice(self.spec.segment_ids).to(
                self.state.master.device)
        return self._seg

    @torch.no_grad()
    def gather_params(self, new_param_shard: torch.Tensor, params=None):
        """All-gather the updated shards (at ``param_wire or wire``) and
        write them into ``params`` (default: the optimizer's), in each
        tensor's dtype; returns the tensors."""
        spec = self.spec
        params = self.params if params is None else comm._leaves(params)
        flat = comm.all_gather_flat(
            new_param_shard, self.axis_name,
            wire=self.param_wire or self.wire, chunks=self.chunks,
            block=self.block)
        off = 0
        for p in params:
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape))
            off += n
        return params

    @torch.no_grad()
    def update_with_norm(self, grads=None, gradient_average: bool = True
                         ) -> torch.Tensor:
        """One sharded step from local ``grads`` (default: ``.grad``);
        returns the global L2 norm of the reduced gradient, measured on
        the shards (one scalar all-reduce)."""
        g = self.reduce_scatter_grads(grads, gradient_average)
        sq = (g * g).sum()
        comm.all_reduce(sq, ps.get_group(self.axis_name))
        self._update(g)
        return sq.sqrt()

    @torch.no_grad()
    def update(self, grads=None, gradient_average: bool = True) -> None:
        """One sharded step from local ``grads`` (default: ``.grad``):
        reduce-scatter, shard update, all-gather into the parameters."""
        self._update(self.reduce_scatter_grads(grads, gradient_average))

    def _update(self, g_shard: torch.Tensor) -> None:
        new_master, self.state = self._shard_update(g_shard, self.state)
        self.gather_params(new_master)

    def step(self, closure=None):
        """``torch.optim`` style: one sharded step from the ``.grad`` of
        the parameters."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.update()
        return loss

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def make_train_step(self, loss_fn: Callable) -> Callable:
        """``step(*batch) -> loss``: zero the gradients, ``loss_fn(*batch)``
        and ``backward()`` on this rank's batch, one sharded update;
        returns the dp-mean loss."""

        def step(*batch):
            self.zero_grad()
            loss = loss_fn(*batch)
            loss.backward()
            self.update()
            return comm.mean_over(loss, self.axis_name)

        return step


class DistributedFusedAdam(_DistributedFusedBase):
    """ZeRO Adam(W) (≙ apex's ``DistributedFusedAdam``)."""

    def __init__(self, params=None, lr=1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 adam_w_mode: bool = True, bias_correction: bool = True,
                 axis_name: str = ps.DATA_PARALLEL_AXIS, wire: str = "f32",
                 chunks: Optional[int] = None,
                 block: int = comm.DEFAULT_BLOCK,
                 param_wire: Optional[str] = None):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        super().__init__(params, axis_name, wire=wire, chunks=chunks,
                         block=block, param_wire=param_wire)

    def _shard_update(self, g, state: _State):
        count = state.count + 1
        m, v, p = state.m, state.v, state.master
        (u,) = _adam_step(
            [p], [g], [m], [v], count=count,
            lr=_lr_at(self.lr, state.count), beta1=self.beta1,
            beta2=self.beta2, eps=self.eps, weight_decay=self.weight_decay,
            adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction)
        p = p + u
        return p, _State(count, m, v, p)


class DistributedFusedLAMB(_DistributedFusedBase):
    """ZeRO LAMB (≙ apex's ``DistributedFusedLamb``): the gradient clipped
    by its global norm after the reduction (``clip_after_ar``), the
    per-tensor trust ratios summed over the shards, nvlamb gating."""

    def __init__(self, params=None, lr=1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 bias_correction: bool = True, grad_averaging: bool = True,
                 adam_w_mode: bool = True, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False,
                 axis_name: str = ps.DATA_PARALLEL_AXIS, wire: str = "f32",
                 chunks: Optional[int] = None,
                 block: int = comm.DEFAULT_BLOCK,
                 param_wire: Optional[str] = None):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.grad_averaging = grad_averaging
        self.adam_w_mode = adam_w_mode
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        super().__init__(params, axis_name, wire=wire, chunks=chunks,
                         block=block, param_wire=param_wire)

    def _shard_update(self, g, state: _State):
        group = ps.get_group(self.axis_name)
        seg = self.my_segment_ids()
        nseg = self.spec.n_leaves + 1  # + the pad's segment
        count = state.count + 1
        lr = _lr_at(self.lr, state.count)
        if self.bias_correction:
            bc1 = 1.0 - self.beta1 ** count
            bc2 = 1.0 - self.beta2 ** count
        else:
            bc1 = bc2 = 1.0
        beta3 = (1.0 - self.beta1) if self.grad_averaging else 1.0
        p = state.master
        # the global norm of the reduced gradient, over every shard
        gsq = (g * g).sum()
        comm.all_reduce(gsq, group)
        gnorm = gsq.sqrt()
        if self.max_grad_norm > 0.0:
            g = g / torch.where(gnorm > self.max_grad_norm,
                                gnorm / self.max_grad_norm,
                                torch.ones_like(gnorm))
        if not self.adam_w_mode and self.weight_decay != 0.0:
            g = g + self.weight_decay * p
        m = self.beta1 * state.m + beta3 * g
        v = self.beta2 * state.v + (1.0 - self.beta2) * g * g
        u = (m / bc1) / ((v / bc2).sqrt() + self.eps)
        if self.adam_w_mode and self.weight_decay != 0.0:
            u = u + self.weight_decay * p
        # per-tensor norms across shard boundaries: segment sums, then
        # one all-reduce of both
        sums = torch.zeros(2, nseg, dtype=torch.float32, device=p.device)
        sums[0].index_add_(0, seg, p * p)
        sums[1].index_add_(0, seg, u * u)
        comm.all_reduce(sums, group)
        w_norm, u_norm = sums.sqrt().unbind(0)
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        if not self.use_nvlamb and self.weight_decay == 0.0:
            ratio = torch.ones_like(ratio)
        p = p - lr * ratio[seg] * u
        return p, _State(count, m, v, p)


# the reference's contrib name
DistributedFusedLamb = DistributedFusedLAMB

"""Expert parallelism — Switch-style Mixture-of-Experts over the dp ranks.

Counterpart of ``apex_tpu/transformer/moe.py`` (no Apex analog):
:class:`SwitchMoe`, a drop-in MoE FFN block — an f32 top-1 or top-2
router, a fixed expert capacity, experts sharded over ``expert_axis``
(the dp ranks: Megatron's convention, no extra axis), the token dispatch
by two tiled all-to-alls and the Switch auxiliary load-balancing loss.

Dataflow on one rank (T local tokens, E global experts, E_l = E / ep
local experts, C the capacity of an expert):

    router logits (T, E) → dispatch one-hots (T, E, C), combine (T, E, C)
    x (T, H) ──einsum──▶ (E, C, H) ──all-to-all(ep)──▶ (E_l, ep·C, H)
        ──batched expert FFN (E_l, ·, H) @ (E_l, H, F)──▶ (E_l, ep·C, H)
        ──all-to-all back──▶ (E, C, H) ──combine──▶ (T, H)

Tokens over an expert's capacity are dropped (zero combine weight) and
pass through the residual of the surrounding block.  The one-hot
dispatch and combine and the expert products are plain ``torch.einsum``
products, as the reference computes them outside any Pallas kernel; the
dispatch and combine tensors are ``(T, E, C)`` each, the reference's
formulation (a gather-based dispatch is a speed follow-up).

Collectives go through :mod:`apex_tpu_torch.parallel.comm`.  The
reference's ``pmean`` of the aux statistics is differentiated as JAX
does under ``shard_map`` without replication checks (its transpose sums
the cotangents over the axis), so the gradient scales below are the
reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.analysis.sharding import tree_paths
from apex_tpu_torch.parallel import comm

__all__ = [
    "MoeConfig",
    "SwitchMoe",
    "moe_dispatch_combine",
    "sync_moe_gradients",
]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    hidden_size: int
    ffn_hidden_size: int
    num_experts: int
    top_k: int = 1  # 1 = Switch, 2 = GShard-style top-2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # the router always computes in f32 (the Switch paper's stability
    # rule); the expert FFN computes in `dtype`
    dtype: torch.dtype = torch.bfloat16
    # the axis the experts shard over; None = unsharded.  "dp" is the
    # Megatron convention (expert group ⊂ data-parallel world)
    expert_axis: Optional[str] = ps.DATA_PARALLEL_AXIS
    # inside the sequence-parallel region at tp > 1 (each tp rank routes
    # its S/tp tokens): the router and expert parameters have tp-partial
    # gradients and are registered as sequence-parallel
    sequence_parallel: bool = False
    # under context parallelism (tokens sharded over cp): the aux stats
    # are averaged over cp with gradient scale 1.0 (cp gradients are
    # mean-reduced, as a data axis)
    context_parallel: bool = False

    def __post_init__(self):
        if self.top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 or 2, got {self.top_k}")
        if self.sequence_parallel and self.context_parallel:
            raise ValueError(
                "sequence_parallel and context_parallel are mutually "
                "exclusive (both shard the token dimension)"
            )


def _axis_size(axis: Optional[str]) -> int:
    return 1 if axis is None else ps.bound_axis_size(axis)


def moe_dispatch_combine(router_probs, top_k, capacity, stats_axis=None,
                         stats_grad_scale=None):
    """Dispatch and combine tensors from router probabilities.

    ``router_probs`` f32 (T, E) (softmaxed).  Returns ``(dispatch (T, E,
    C) 0/1 f32, combine (T, E, C) f32, aux)``: a token's slot in an
    expert is its place in token order among the expert's tokens
    (earlier tokens win capacity — the Switch rule), and ``aux`` is the
    load-balancing term ``E · Σ_e f_e · P_e`` (fraction routed × mean
    probability).

    ``stats_axis``: the axis whose ranks' ``f_e``, ``P_e`` are averaged
    before the product, when tokens are sharded over it (sequence
    parallelism over tp, context parallelism over cp): aux is quadratic
    in the stats, so this recovers the unsharded value.
    ``stats_grad_scale`` scales aux's gradient only (its value is kept):
    ``None`` means ``1/axis_size``, right when the caller then sums the
    gradients over the axis (sequence parallelism); 1.0 when it
    averages them (context parallelism)."""
    t, e = router_probs.shape
    expert_idx = torch.topk(router_probs, top_k, dim=-1).indices  # (T, K)
    onehot = F.one_hot(expert_idx, e).to(torch.float32)  # (T, K, E)

    # the aux loss takes the top-1 assignment fraction (Switch)
    frac_routed = onehot[:, 0, :].mean(dim=0)  # (E,)
    mean_prob = router_probs.mean(dim=0)  # (E,)
    if stats_axis is not None:
        frac_routed = comm.pmean(frac_routed, stats_axis)
        mean_prob = comm.pmean(mean_prob, stats_axis)
        aux = e * torch.sum(frac_routed * mean_prob)
        scale = (1.0 / ps.axis_size(stats_axis) if stats_grad_scale is None
                 else stats_grad_scale)
        if scale != 1.0:
            aux = aux * scale + (aux * (1.0 - scale)).detach()
    else:
        aux = e * torch.sum(frac_routed * mean_prob)

    dispatch = router_probs.new_zeros((t, e, capacity))
    combine = router_probs.new_zeros((t, e, capacity))
    # running per-expert fill counts across the K choices: a token's k-th
    # choice sees the capacity taken by every token's earlier choices and
    # by earlier tokens' k-th choice (GShard's order for K <= 2)
    fill = router_probs.new_zeros((e,))
    for k in range(top_k):
        oh = onehot[:, k, :]  # (T, E)
        pos = torch.cumsum(oh, dim=0) - oh + fill[None, :]
        keep = oh * (pos < capacity)
        pos_clamped = torch.clamp(pos, max=capacity - 1).long()
        pos_oh = F.one_hot(pos_clamped, capacity).to(torch.float32)
        sel = keep[..., None] * pos_oh  # (T, E, C)
        dispatch = dispatch + sel
        gate = torch.sum(router_probs * oh, dim=-1)  # (T,)
        combine = combine + sel * gate[:, None, None]
        fill = fill + oh.sum(dim=0)
    if top_k == 2:
        # renormalize the KEPT gates to sum to 1 per token (GShard's
        # top-2 rule); a token whose both choices overflowed keeps 0
        denom = torch.sum(combine, dim=(1, 2), keepdim=True)
        combine = torch.where(denom > 0.0,
                              combine / torch.clamp(denom, min=1e-9),
                              torch.zeros_like(combine))
    return dispatch, combine, aux


def _is_expert(path: str) -> bool:
    return any(part.startswith("expert_")
               for part in path.replace(".", "/").split("/"))


@torch.no_grad()
def sync_moe_gradients(grads, axis: str = ps.EXPERT_PARALLEL_AXIS,
                       average: bool = True,
                       sequence_parallel_axis: Optional[str] = None):
    """Data-parallel gradient sync that understands expert sharding, in
    place; returns ``grads``.

    ``grads`` is an ``nn.Module`` (its parameters' ``.grad``) or a tree
    of gradient tensors keyed by parameter names.  A plain all-reduce
    over dp is wrong for an MoE model: rank r holds experts ``[r·E_l,
    (r+1)·E_l)``, so it would mix the gradients of different experts.
    It is also unneeded: each rank's experts saw every rank's tokens
    through the dispatch, so their backward already sums over the
    global batch.  So every leaf is reduced over ``axis`` except those
    whose path has a part starting with ``expert_``; under ``average``
    (the mean objective, DDP's gradient average) the others are
    averaged and the expert leaves divided by the axis size, else the
    others are summed and the expert leaves left as they are.

    With tensor and sequence parallelism (``MoeConfig.
    sequence_parallel``), pass ``sequence_parallel_axis="tp"`` and a
    module: the registered router, expert and LayerNorm gradients are
    then also summed over tp
    (:func:`~apex_tpu_torch.transformer.tensor_parallel.
    allreduce_sequence_parallel_gradients`)."""
    world = ps.axis_size(axis)
    group = ps.get_group(axis)
    if isinstance(grads, nn.Module):
        leaves = [(n, p.grad) for n, p in grads.named_parameters()
                  if p.grad is not None]
    else:
        leaves = tree_paths(grads)
    for path, g in leaves:
        if _is_expert(path):
            if average:
                g.div_(world)
            continue
        comm.all_reduce(g, group)
        if average:
            g.div_(world)
    if sequence_parallel_axis is not None:
        from apex_tpu_torch.transformer.tensor_parallel.mappings import (
            allreduce_sequence_parallel_gradients,
        )

        allreduce_sequence_parallel_gradients(grads, sequence_parallel_axis)
    return grads


def _expert_seed(base_seed: int, expert: int) -> int:
    """The seed of global expert ``expert``'s generator (the same at
    every ep degree)."""
    return (int(base_seed) * 1_000_003 + int(expert)) % (2 ** 63 - 1)


class SwitchMoe(nn.Module):
    """MoE FFN block (router + sharded experts + dispatch/combine).

    Input and output ``(S, B, H)`` (seq-first); :meth:`forward` returns
    ``(y, aux_loss)`` (add ``aux_loss_coef * aux`` to the loss).  The f32
    weights are ``router`` (H, E) and this rank's expert shard
    ``expert_w1`` (E_l, H, F) and ``expert_w2`` (E_l, F, H), the "expert_"
    prefix marking what :func:`sync_moe_gradients` leaves unreduced.

    Init: the router N(0, 0.02) from ``generator``; global expert e from
    a generator of its own seeded with ``_expert_seed(base_seed, e)``
    (N(0, 1/fan_in)), so e has the same weights at every ep degree.
    ``base_seed`` defaults to a draw from ``generator``."""

    def __init__(self, cfg: MoeConfig, *, device=None,
                 generator: Optional[torch.Generator] = None,
                 base_seed: Optional[int] = None):
        super().__init__()
        ep = _axis_size(cfg.expert_axis)
        if cfg.num_experts % ep:
            raise ValueError(
                f"num_experts ({cfg.num_experts}) must be divisible by the "
                f"expert axis size ({ep})"
            )
        self.cfg = cfg
        self.ep = ep
        self.e_local = cfg.num_experts // ep
        h, f = cfg.hidden_size, cfg.ffn_hidden_size
        kw = dict(dtype=torch.float32, device=device)
        self.router = nn.Parameter(torch.empty(h, cfg.num_experts, **kw))
        self.expert_w1 = nn.Parameter(torch.empty(self.e_local, h, f, **kw))
        self.expert_w2 = nn.Parameter(torch.empty(self.e_local, f, h, **kw))
        if cfg.sequence_parallel:
            for p in (self.router, self.expert_w1, self.expert_w2):
                ps.register_sequence_parallel_param(p)
        if generator is None:
            generator = torch.Generator(
                device=self.router.device).manual_seed(0)
        self.reset_parameters(generator, base_seed)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         base_seed: Optional[int] = None) -> None:
        cfg = self.cfg
        dev = generator.device
        self.router.copy_(torch.randn(self.router.shape, generator=generator,
                                      device=dev) * 0.02)
        if base_seed is None:
            base_seed = int(torch.randint(2 ** 31 - 1, (1,),
                                          generator=generator, device=dev))
        rank = (ps.axis_rank(cfg.expert_axis)
                if cfg.expert_axis is not None and self.ep > 1 else 0)
        h, f = cfg.hidden_size, cfg.ffn_hidden_size
        for i in range(self.e_local):
            g = torch.Generator(device=dev).manual_seed(
                _expert_seed(base_seed, rank * self.e_local + i))
            self.expert_w1[i].copy_(
                torch.randn((h, f), generator=g, device=dev) * h ** -0.5)
            self.expert_w2[i].copy_(
                torch.randn((f, h), generator=g, device=dev) * f ** -0.5)

    def forward(self, x):
        cfg = self.cfg
        s, b, h = x.shape
        if h != cfg.hidden_size:
            raise ValueError(
                f"hidden {h} != cfg.hidden_size {cfg.hidden_size}")
        tokens = s * b
        capacity = max(int(cfg.capacity_factor * tokens / cfg.num_experts
                           + 0.5), 1)
        xt = x.reshape(tokens, h)
        probs = torch.softmax(xt.float() @ self.router, dim=-1)
        stats_axis, stats_grad_scale = None, None
        if cfg.sequence_parallel and ps.axis_is_bound(
                ps.TENSOR_PARALLEL_AXIS):
            stats_axis = ps.TENSOR_PARALLEL_AXIS  # summed: 1/n scale
        elif cfg.context_parallel and ps.axis_is_bound(
                ps.CONTEXT_PARALLEL_AXIS):
            stats_axis = ps.CONTEXT_PARALLEL_AXIS
            stats_grad_scale = 1.0  # averaged: the 1/n cancels
        dispatch, combine, aux = moe_dispatch_combine(
            probs, cfg.top_k, capacity, stats_axis=stats_axis,
            stats_grad_scale=stats_grad_scale)

        dt = cfg.dtype
        # (E, C, H): this rank's C slots of every expert
        ex = torch.einsum("tec,th->ech", dispatch.to(dt), xt.to(dt))
        if self.ep > 1:
            # (E, C, H) -> (E_l, ep·C, H): the slots routed to this rank's
            # experts from every peer, source-rank major
            ex = comm.all_to_all(ex, cfg.expert_axis, 0, 1)
        hmid = torch.einsum("ekh,ehf->ekf", ex, self.expert_w1.to(dt))
        hmid = F.gelu(hmid, approximate="tanh")
        ey = torch.einsum("ekf,efh->ekh", hmid, self.expert_w2.to(dt))
        if self.ep > 1:
            # back to (E, C, H) in global expert order
            ey = comm.all_to_all(ey, cfg.expert_axis, 1, 0)
        y = torch.einsum("tec,ech->th", combine.to(dt), ey)
        return y.reshape(s, b, h).to(x.dtype), aux

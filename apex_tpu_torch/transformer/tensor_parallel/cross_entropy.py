"""Vocab-parallel cross entropy: no logits gather.

Counterpart of ``apex_tpu/transformer/tensor_parallel/cross_entropy.py``
(≙ apex's ``_VocabParallelCrossEntropy``): the softmax cross entropy of
logits whose vocab is sharded over the tp group, with three row-wise
all-reduces — the global max, the sum of exps and the target logit
(which only the rank that owns the target's id holds) — and, with
``label_smoothing``, the sum of the logits.  The forward keeps
``exp(logits - max)`` and the row sums for the backward, which rebuilds
``softmax - target_dist`` on each rank's slice with no collective.
``label_smoothing`` spreads the smoothing uniformly over the full vocab.

Shapes: ``logits`` is ``(..., V / tp)`` (this rank's slice: ids
``[rank * V / tp, (rank + 1) * V / tp)``), ``target`` is ``(...)``
integer ids in ``[0, V)`` (an id outside the range gets no target
logit, as on the JAX side).  The loss is f32 of shape ``(...)``, the
same on every rank; the logits gradient comes back in the logits'
dtype.  At tp = 1 no collective is issued.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.parallel import comm

__all__ = ["vocab_parallel_cross_entropy"]


class _VocabCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, target, smoothing, axis_name):
        group = ps.get_group(axis_name)
        world = ps.axis_size(axis_name)
        lf = logits.float()
        local_v = lf.shape[-1]
        vocab = local_v * world
        start = ps.axis_rank(axis_name) * local_v
        lmax = comm.all_reduce(lf.amax(dim=-1), group, op="max")
        shifted = lf - lmax[..., None]
        in_range = (target >= start) & (target < start + local_v)
        idx = (target.long() - start).clamp(0, local_v - 1)
        pred = shifted.gather(-1, idx[..., None])[..., 0]
        pred = comm.all_reduce(
            torch.where(in_range, pred, torch.zeros_like(pred)), group)
        mean_logit = None
        if smoothing > 0.0:
            mean_logit = comm.all_reduce(shifted.sum(dim=-1), group) / vocab
        # in place: the shifted logits are not needed past this point,
        # and at (S*B, V) = (16384, 50304) each such buffer is 3.3 GB
        exp = shifted.exp_()
        sum_exp = comm.all_reduce(exp.sum(dim=-1), group)
        log_z = torch.log(sum_exp)
        loss = log_z - pred
        if smoothing > 0.0:
            # (1-s)*nll + s * mean over the vocab of (log_z - logit_j)
            loss = (1.0 - smoothing) * loss + smoothing * (log_z - mean_logit)
        ctx.save_for_backward(exp, sum_exp, in_range, idx)
        ctx.smoothing = smoothing
        ctx.vocab = vocab
        ctx.logits_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        exp, sum_exp, in_range, idx = ctx.saved_tensors
        s = ctx.smoothing
        # softmax - target_dist, target_dist = (1-s)*onehot + s/V, built
        # in place in the one new buffer (no one-hot tensor)
        grad = exp / sum_exp[..., None]
        grad.scatter_add_(-1, idx[..., None],
                          -(1.0 - s) * in_range[..., None].float())
        if s > 0.0:
            grad.sub_(s / ctx.vocab)
        grad.mul_(g[..., None])
        return grad.to(ctx.logits_dtype), None, None, None


def vocab_parallel_cross_entropy(logits, target, label_smoothing: float = 0.0,
                                 axis_name: str = ps.TENSOR_PARALLEL_AXIS, *,
                                 tp_size: Optional[int] = None):
    """Per-position cross entropy (f32, shape ``target.shape``) of this
    rank's vocab slice ``logits`` (..., V / tp) against integer
    ``target`` (...).  ``tp_size``, when given, must be the size of the
    ``axis_name`` group (a check of the caller's sharding)."""
    world = ps.axis_size(axis_name)
    if tp_size is not None and tp_size != world:
        raise ValueError(
            f"vocab_parallel_cross_entropy: tp_size={tp_size} but the "
            f"{axis_name!r} group has {world} rank(s)"
        )
    if logits.shape[:-1] != target.shape:
        raise ValueError(
            f"logits {tuple(logits.shape)} and target {tuple(target.shape)} "
            "disagree on the leading dimensions"
        )
    return _VocabCrossEntropy.apply(logits, target, float(label_smoothing),
                                    axis_name)

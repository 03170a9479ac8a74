"""Vocab-parallel cross entropy at tensor-parallel size 1.

Counterpart of ``apex_tpu/transformer/tensor_parallel/cross_entropy.py``:
``vocab_parallel_cross_entropy`` with its ``_fwd``/``_bwd`` arithmetic.
The forward keeps ``exp(logits - max)`` and its row sum for the backward,
which rebuilds ``softmax - target_dist`` from them.  ``label_smoothing``
spreads the smoothing uniformly over the full vocab.

Shapes: ``logits`` is ``(..., V)``, ``target`` is ``(...)`` integer ids
in ``[0, V)`` (an id outside the range gets no target logit, as on the
JAX side).  The loss is f32 of shape ``(...)``; the logits gradient
comes back in the logits' dtype.  Only ``tp_size=1`` is ported: the
vocab-sharded version needs the collectives of the multi-GPU slice.
"""

from __future__ import annotations

import torch

__all__ = ["vocab_parallel_cross_entropy"]


class _VocabCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, target, smoothing):
        lf = logits.float()
        vocab = lf.shape[-1]
        shifted = lf - lf.amax(dim=-1, keepdim=True)
        in_range = (target >= 0) & (target < vocab)
        idx = target.long().clamp(0, vocab - 1)
        pred = shifted.gather(-1, idx[..., None])[..., 0]
        pred = torch.where(in_range, pred, torch.zeros_like(pred))
        mean_logit = shifted.sum(dim=-1) / vocab if smoothing > 0.0 else None
        # in place: the shifted logits are not needed past this point,
        # and at (S*B, V) = (16384, 50304) each such buffer is 3.3 GB
        exp = shifted.exp_()
        sum_exp = exp.sum(dim=-1)
        log_z = torch.log(sum_exp)
        loss = log_z - pred
        if smoothing > 0.0:
            # (1-s)*nll + s * mean over the vocab of (log_z - logit_j)
            loss = (1.0 - smoothing) * loss + smoothing * (log_z - mean_logit)
        ctx.save_for_backward(exp, sum_exp, in_range, idx)
        ctx.smoothing = smoothing
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
            grad.sub_(s / exp.shape[-1])
        grad.mul_(g[..., None])
        return grad.to(ctx.logits_dtype), None, None


def vocab_parallel_cross_entropy(logits, target, label_smoothing: float = 0.0,
                                 *, tp_size: int = 1):
    """Per-position cross entropy (f32, shape ``target.shape``) of
    ``logits`` (..., V) against integer ``target`` (...)."""
    if tp_size != 1:
        raise NotImplementedError(
            f"vocab_parallel_cross_entropy at tp_size={tp_size} is not "
            "ported yet (ROADMAP: multi-GPU slice); only tp_size=1"
        )
    if logits.shape[:-1] != target.shape:
        raise ValueError(
            f"logits {tuple(logits.shape)} and target {tuple(target.shape)} "
            "disagree on the leading dimensions"
        )
    return _VocabCrossEntropy.apply(logits, target, float(label_smoothing))

"""Softmax cross entropy with label smoothing.

Counterpart of ``apex_tpu/ops/xentropy.py`` (≙ apex's
``SoftmaxCrossEntropyLoss``): plain PyTorch, as the JAX version is
plain jnp.  The forward keeps the f32 row logsumexp beside the logits
and labels, and the backward rebuilds ``softmax - target`` from them,
as the reference's custom backward does.

- ``smoothing = 0``: ``loss_i = lse_i - logit_i[label_i]``;
- ``smoothing = s``: the target puts ``1 - s`` on the label and ``s / V``
  on every class: ``loss_i = lse_i - (1 - s) logit_i[label_i] - s
  mean(logit_i)``;
- rows whose label is ``ignore_idx`` give zero loss and zero gradient;
- the loss is f32 whatever the logits' dtype; the gradient comes back in
  the logits' dtype.

The logits are cast by the active amp policy first (``amp_cast``
under ``"xentropy"``, an fp32 op): under O1 half logits are widened to
f32, and their gradient comes back in the caller's dtype; with no
policy active they pass as they are.
"""

from __future__ import annotations

import torch

__all__ = ["softmax_cross_entropy_loss", "SoftmaxCrossEntropyLoss"]


def _target(labels, v: int, smoothing: float):
    """The (N, V) f32 target: one-hot of the label (all zero for a label
    outside the vocab, e.g. ``ignore_idx``), smoothed."""
    one_hot = (torch.arange(v, device=labels.device)[None, :]
               == labels.long()[:, None]).float()
    if smoothing > 0.0:
        return (1.0 - smoothing) * one_hot + smoothing / v
    return one_hot


class _Xent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, smoothing, ignore_idx):
        lf = logits.float()
        n, v = logits.shape
        m = lf.max(dim=-1, keepdim=True).values
        lse = m[:, 0] + torch.log(torch.exp(lf - m).sum(dim=-1))
        label_logit = lf.gather(
            1, labels.long().clamp(0, v - 1)[:, None])[:, 0]
        if smoothing > 0.0:
            nll = (lse - (1.0 - smoothing) * label_logit
                   - smoothing * lf.mean(dim=-1))
        else:
            nll = lse - label_logit
        valid = labels != ignore_idx
        ctx.save_for_backward(logits, labels, lse, valid)
        ctx.smoothing = smoothing
        return torch.where(valid, nll, torch.zeros_like(nll))

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse, valid = ctx.saved_tensors
        lf = logits.float()
        softmax = torch.exp(lf - lse[:, None])
        target = _target(labels, logits.shape[1], ctx.smoothing)
        dlogits = (softmax - target) * g[:, None]
        dlogits = torch.where(valid[:, None], dlogits,
                              torch.zeros_like(dlogits))
        return dlogits.to(logits.dtype), None, None, None


def softmax_cross_entropy_loss(logits, labels, smoothing: float = 0.0,
                               ignore_idx: int = -100):
    """Per-example smoothed cross entropy ``(N,)`` f32 of ``logits``
    ``(N, V)`` against integer ``labels`` ``(N,)``."""
    from apex_tpu_torch.amp.lists import amp_cast

    return _Xent.apply(amp_cast("xentropy", logits), labels,
                       float(smoothing), int(ignore_idx))


class SoftmaxCrossEntropyLoss:
    """Shaped like the reference's module (static, stateless)."""

    @staticmethod
    def apply(logits, labels, smoothing: float = 0.0, padding_idx: int = 0,
              half_to_float: bool = False):
        del half_to_float  # the loss is always f32 (module docstring)
        return softmax_cross_entropy_loss(logits, labels, smoothing,
                                          ignore_idx=padding_idx)

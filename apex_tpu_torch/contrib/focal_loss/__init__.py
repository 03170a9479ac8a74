"""Sigmoid focal loss — ≙ ``apex/contrib/focal_loss`` (``focal_loss``,
the SSD / RetinaNet classification loss); counterpart of
``apex_tpu/contrib/focal_loss``.

Upstream's CUDA kernel fuses the sigmoid, log and power chain with the
sum.  Here it is a plain PyTorch composition with the reference's
semantics: the math is f32 whatever the logits' dtype; an integer target
``t >= 1`` marks class ``t - 1`` positive, ``t == 0`` makes the anchor
all negative and ``t == -1`` ignores it; classes from
``num_real_classes`` on are masked out (padding); optional label
smoothing; the sum divided by ``max(num_positives_sum, 1)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["focal_loss", "sigmoid_focal_loss"]


def sigmoid_focal_loss(logits: torch.Tensor, targets_one_hot: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """The elementwise term ``-alpha_t (1 - p_t)**gamma log(p_t)`` in f32;
    ``targets_one_hot`` in {0, 1} (floats allowed), broadcastable to
    ``logits`` (..., num_classes)."""
    lf = logits.float()
    t = targets_one_hot.float()
    if label_smoothing > 0.0:
        t = t * (1.0 - label_smoothing) + 0.5 * label_smoothing
    p = torch.sigmoid(lf)
    ce = F.relu(lf) - lf * t + torch.log1p(torch.exp(-lf.abs()))
    p_t = p * t + (1.0 - p) * (1.0 - t)
    alpha_t = alpha * t + (1.0 - alpha) * (1.0 - t)
    return alpha_t * torch.pow(1.0 - p_t, gamma) * ce


def focal_loss(cls_output: torch.Tensor, cls_targets_at_level: torch.Tensor,
               num_positives_sum, num_real_classes: Optional[int] = None,
               alpha: float = 0.25, gamma: float = 2.0,
               label_smoothing: float = 0.0) -> torch.Tensor:
    """≙ ``focal_loss_cuda.focal_loss_forward``: ``cls_output`` (..., C)
    logits, ``cls_targets_at_level`` (...) integer targets (see the
    module docstring); the f32 sum over the valid anchors and real
    classes over ``max(num_positives_sum, 1)``."""
    c = cls_output.shape[-1]
    if num_real_classes is None:
        num_real_classes = c
    t = cls_targets_at_level.long()
    classes = torch.arange(c, device=cls_output.device)
    # t - 1 == class: no class for t <= 0
    one_hot = (t[..., None] - 1 == classes).float()
    per_elem = sigmoid_focal_loss(cls_output, one_hot, alpha, gamma,
                                  label_smoothing)
    valid = (t >= 0).float()[..., None]
    real = (classes < num_real_classes).float()
    total = (per_elem * valid * real).sum()
    npos = torch.as_tensor(num_positives_sum, dtype=torch.float32,
                           device=total.device)
    return total / torch.clamp(npos, min=1.0)

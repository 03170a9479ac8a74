"""SyncBatchNorm — batch normalization with dp-wide statistics.

Counterpart of ``apex_tpu/parallel/sync_batchnorm.py`` (≙ apex's
``optimized_sync_batchnorm`` with ``csrc/syncbn``).  Plain PyTorch, as
the reference is plain jnp (there is no Pallas kernel here): each rank
sums ``x`` and ``x * x`` over every non-channel axis in f32, with its
element count; one all-reduce over the dp group adds the ranks'
(Σx, Σx², n), and every rank normalizes with the full batch's mean and
biased variance.  The all-reduce is an autograd function whose backward
all-reduces the cotangents, so the input gradient is the full batch's
too.  Running statistics follow PyTorch's convention:
``running = (1 - momentum) * running + momentum * batch``, with the
unbiased variance.  With no dp group (dp = 1, or before
``initialize_model_parallel``) it is plain BatchNorm.

Layout: PyTorch's ``(N, C, ...)``; ``channel_last=True`` takes
``(N, ..., C)``, the reference's layout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.parallel import comm

__all__ = ["SyncBatchNorm", "convert_syncbn_model"]


class SyncBatchNorm(nn.Module):
    """Drop-in for ``nn.BatchNorm{1,2,3}d`` with statistics over the dp
    group.  ``eval()`` (or ``use_running_average=True``) normalizes with
    the running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 axis_name: str = ps.DATA_PARALLEL_AXIS,
                 channel_last: bool = False,
                 use_running_average: Optional[bool] = None,
                 device=None, dtype=None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.axis_name = axis_name
        self.channel_last = channel_last
        self.use_running_average = use_running_average
        if affine:
            self.weight = nn.Parameter(torch.ones(
                num_features, dtype=torch.float32, device=device))
            self.bias = nn.Parameter(torch.zeros(
                num_features, dtype=torch.float32, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(
                num_features, dtype=torch.float32, device=device))
            self.register_buffer("running_var", torch.ones(
                num_features, dtype=torch.float32, device=device))
            self.register_buffer("num_batches_tracked", torch.zeros(
                (), dtype=torch.long, device=device))
        else:
            self.running_mean = self.running_var = None

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        y, stats = self.normalize(x, use_running_average)
        if stats is not None and self.training:
            with torch.no_grad():
                self.running_mean.copy_(stats[0])
                self.running_var.copy_(stats[1])
                self.num_batches_tracked.add_(1)
        return y

    def normalize(self, x: torch.Tensor,
                  use_running_average: Optional[bool] = None):
        """``(y, stats)`` without touching the buffers: ``stats`` is the
        running ``(mean, var)`` after this batch (detached f32), or None
        when normalizing with the running statistics or tracking none.
        :meth:`forward` stores them in training mode; a caller that
        keeps the statistics as returned state (the reference's
        ``mutable=["batch_stats"]``) uses this directly."""
        c_axis = x.ndim - 1 if self.channel_last else 1
        if x.shape[c_axis] != self.num_features:
            raise ValueError(
                f"SyncBatchNorm expects {self.num_features} channels on "
                f"axis {c_axis}, got shape {tuple(x.shape)}")
        if use_running_average is None:
            use_running_average = self.use_running_average
        if use_running_average is None:
            use_running_average = not self.training
        shape = [1] * x.ndim
        shape[c_axis] = self.num_features
        xf = x.float()
        stats = None
        if use_running_average and self.track_running_stats:
            mean, var = self.running_mean, self.running_var
        else:
            axes = [d for d in range(x.ndim) if d != c_axis]
            n_local = float(x.numel() // self.num_features)
            sums = torch.cat([
                xf.sum(dim=axes), (xf * xf).sum(dim=axes),
                torch.full((1,), n_local, device=x.device)])
            if ps.get_group(self.axis_name) is not None:
                sums = comm.psum(sums, self.axis_name)
            s1, s2, n = sums.split([self.num_features, self.num_features, 1])
            mean = s1 / n
            var = s2 / n - mean * mean
            if self.track_running_stats:
                with torch.no_grad():
                    m = self.momentum
                    unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                    stats = (self.running_mean * (1.0 - m) + m * mean,
                             self.running_var * (1.0 - m) + m * unbiased)
        y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                     + self.eps)
        if self.affine:
            y = y * self.weight.float().reshape(shape) \
                + self.bias.float().reshape(shape)
        return y.to(x.dtype), stats


def convert_syncbn_model(module: nn.Module,
                         axis_name: str = ps.DATA_PARALLEL_AXIS) -> nn.Module:
    """Replace every ``nn.BatchNorm*d`` in ``module`` (the module itself
    included) with a :class:`SyncBatchNorm` holding its affine
    parameters and running statistics (≙ apex's
    ``convert_syncbn_model``); returns the converted module."""
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        out = SyncBatchNorm(
            module.num_features, eps=module.eps,
            momentum=module.momentum if module.momentum is not None else 0.1,
            affine=module.affine,
            track_running_stats=module.track_running_stats,
            axis_name=axis_name)
        with torch.no_grad():
            if module.affine:
                out.weight.copy_(module.weight)
                out.bias.copy_(module.bias)
            if module.track_running_stats:
                out.running_mean.copy_(module.running_mean)
                out.running_var.copy_(module.running_var)
                out.num_batches_tracked.copy_(module.num_batches_tracked)
        dev = (module.weight.device if module.affine else
               module.running_mean.device if module.track_running_stats
               else None)
        if dev is not None:
            out = out.to(dev)
        out.train(module.training)
        return out
    for name, child in module.named_children():
        setattr(module, name, convert_syncbn_model(child, axis_name))
    return module

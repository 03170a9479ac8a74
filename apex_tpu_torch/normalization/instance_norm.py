"""InstanceNorm3d — counterpart of
``apex_tpu/normalization/instance_norm.py`` (≙
``apex/normalization/instance_norm.py`` :: ``InstanceNorm3dNVFuser``).

Plain PyTorch, as the reference is plain jnp (it has no Pallas kernel
here): a per-(sample, channel) reduction over the spatial dims.

- Channels-last ``(N, D, H, W, C)`` by default, the reference's layout;
  ``channels_first=True`` takes PyTorch's ``(N, C, D, H, W)``.
- Statistics per (n, c) over every spatial dim, always in f32; the
  output in the input's dtype.
- ``affine``: a per-channel scale and bias.
- ``track_running_stats``: running mean and variance for evaluation,
  updated in training with PyTorch's momentum convention,
  ``running = (1 - m) * running + m * batch``, the batch variance
  unbiased (the batch's per-sample statistics averaged over samples).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["instance_norm", "InstanceNorm3d", "InstanceNorm3dNVFuser"]


def instance_norm(x, weight=None, bias=None, eps: float = 1e-5,
                  mean=None, var=None):
    """Instance norm over ``(N, *spatial, C)``: statistics per (sample,
    channel) over the spatial dims in f32, unless ``mean`` and ``var``
    (shape ``(N, C)`` or ``(C,)``) are given (the evaluation path)."""
    xf = x.float()
    axes = tuple(range(1, x.ndim - 1))
    if mean is None:
        mean = xf.mean(dim=axes, keepdim=True)
        var = xf.var(dim=axes, keepdim=True, unbiased=False)
    else:
        shape = ((x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
                 if mean.ndim == 2 else (1,) * (x.ndim - 1) + (x.shape[-1],))
        mean = mean.float().reshape(shape)
        var = var.float().reshape(shape)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


class InstanceNorm3d(nn.Module):
    """≙ ``InstanceNorm3dNVFuser(num_features, eps, momentum, affine,
    track_running_stats)``.  ``forward(x, use_running_average=None)``:
    ``None`` means evaluation when the module is in ``eval()`` mode."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = False,
                 channels_first: bool = False,
                 param_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.channels_first = channels_first
        dev = resolve_device(device)
        if affine:
            self.weight = nn.Parameter(torch.ones(
                num_features, dtype=param_dtype, device=dev))
            self.bias = nn.Parameter(torch.zeros(
                num_features, dtype=param_dtype, device=dev))
        else:
            self.weight = self.bias = None
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(
                num_features, dtype=torch.float32, device=dev))
            self.register_buffer("running_var", torch.ones(
                num_features, dtype=torch.float32, device=dev))

    def forward(self, x, use_running_average: Optional[bool] = None):
        if self.channels_first:
            x = torch.movedim(x, 1, -1)
        if x.shape[-1] != self.num_features:
            raise ValueError(
                f"expected {self.num_features} channels, got {x.shape[-1]}")
        if use_running_average is None:
            use_running_average = not self.training
        if use_running_average and self.track_running_stats:
            y = instance_norm(x, self.weight, self.bias, self.eps,
                              mean=self.running_mean, var=self.running_var)
        else:
            y = instance_norm(x, self.weight, self.bias, self.eps)
            if self.track_running_stats:
                self._update_running_stats(x)
        if self.channels_first:
            y = torch.movedim(y, -1, 1)
        return y

    @torch.no_grad()
    def _update_running_stats(self, x):
        axes = tuple(range(1, x.ndim - 1))
        xf = x.float()
        n = 1
        for a in axes:
            n *= x.shape[a]
        bm = xf.mean(dim=axes).mean(dim=0)
        # PyTorch feeds the running variance the unbiased sample variance
        bv = xf.var(dim=axes, unbiased=False).mean(dim=0) * (n / max(n - 1, 1))
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * bm)
        self.running_var.copy_((1 - m) * self.running_var + m * bv)


# the reference's name (NVFuser names the CUDA code generator it used)
InstanceNorm3dNVFuser = InstanceNorm3d

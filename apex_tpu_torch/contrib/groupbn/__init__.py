"""NHWC BatchNorm with fused ReLU and residual add, statistics over a
group of ranks — ≙ ``apex/contrib/groupbn`` (``BatchNorm2d_NHWC``);
counterpart of ``apex_tpu/contrib/groupbn``.

Upstream is MLPerf ResNet's batch norm: NHWC kernels with a fused ReLU
and residual add, and ``bn_group``, statistics all-reduced over a small
group of GPUs through CUDA IPC.  Here it is a plain PyTorch composition
with the reference's arithmetic, kept exactly: f32 sums ``s1`` and
``s2`` (summed over the ``axis_name`` group with
:func:`apex_tpu_torch.parallel.comm.psum` where ``bn_group > 1``), the
variance ``s2 / n - mean**2`` with no clamp, and the running statistics
in PyTorch's convention, ``(1 - momentum) * running + momentum * new``
with the unbiased variance.  (This is not flax's ``nn.BatchNorm``
arithmetic of :class:`apex_tpu_torch.models.resnet.BatchNorm`.)
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.normalization import from_jax_params
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.parallel import comm

__all__ = ["BatchNorm2d_NHWC"]


def _merge_param(name: str, attribute, argument):
    """flax's ``nn.merge_param``: exactly one of the two is set."""
    if (attribute is None) == (argument is None):
        raise ValueError(
            f"{name} must be set either as an attribute or as a call "
            f"argument, and not both")
    return attribute if argument is None else argument


class BatchNorm2d_NHWC(nn.Module):
    """≙ ``BatchNorm2d_NHWC(num_features, fuse_relu=False, bn_group=1)``.

    ``forward(x, z=None, use_running_average=None)``: ``x`` (N, H, W, C)
    channels-last; ``z`` the fused residual add (≙ upstream's
    bn_add_relu), before the ReLU.  ``bn_group > 1`` sums the batch
    statistics over ``axis_name``, whose group must exist and have
    ``bn_group`` ranks.  A training call updates the running statistics
    in place.  The result is in ``dtype`` (``x``'s when None)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, fuse_relu: bool = False,
                 bn_group: int = 1, axis_name: str = ps.DATA_PARALLEL_AXIS,
                 use_running_average: Optional[bool] = None, dtype=None, *,
                 param_dtype=torch.float32, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.num_features, self.eps, self.momentum = num_features, eps, \
            momentum
        self.fuse_relu, self.bn_group, self.axis_name = fuse_relu, bn_group, \
            axis_name
        self.use_running_average, self.dtype = use_running_average, dtype
        self.weight = nn.Parameter(torch.ones(num_features, dtype=param_dtype,
                                              device=dev))
        self.bias = nn.Parameter(torch.zeros(num_features, dtype=param_dtype,
                                             device=dev))
        self.register_buffer("running_mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("running_var", torch.ones(
            num_features, dtype=torch.float32, device=dev))

    def _batch_statistics(self, xf: torch.Tensor):
        c = self.num_features
        n = torch.tensor([xf.numel() // c], dtype=torch.float32,
                         device=xf.device)
        s1 = xf.sum(dim=tuple(range(xf.ndim - 1)))
        s2 = (xf * xf).sum(dim=tuple(range(xf.ndim - 1)))
        if self.bn_group > 1:
            if not ps.axis_is_bound(self.axis_name):
                raise RuntimeError(
                    f"bn_group={self.bn_group} needs axis "
                    f"{self.axis_name!r} bound (initialize_model_parallel "
                    f"first)")
            world = ps.axis_size(self.axis_name)
            if world != self.bn_group:
                raise ValueError(
                    f"bn_group ({self.bn_group}) must equal the "
                    f"{self.axis_name!r} axis size ({world})")
            s1, s2, n = comm.psum(torch.cat([s1, s2, n]),
                                  self.axis_name).split([c, c, 1])
        mean = s1 / n
        return mean, s2 / n - mean * mean, n

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        use_running_average = _merge_param(
            "use_running_average", self.use_running_average,
            use_running_average)
        if x.shape[-1] != self.num_features:
            raise ValueError(
                f"BatchNorm2d_NHWC expects channels-last with "
                f"{self.num_features} channels, got {tuple(x.shape)}")
        xf = x.float()
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var, n = self._batch_statistics(xf)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * unbiased)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.float() + self.bias.float()
        if z is not None:
            y = y + z.float()
        if self.fuse_relu:
            y = F.relu(y)
        return y.to(self.dtype or x.dtype)


#: copies a JAX module's ``{"params": {"weight", "bias"}, "batch_stats":
#: {"mean", "var"}}`` (numpy) into a :class:`BatchNorm2d_NHWC`; returns it
from_jax_variables = from_jax_params

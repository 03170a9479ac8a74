"""ResNet bottleneck block and its spatially parallel form — ≙
``apex/contrib/bottleneck`` (``Bottleneck``, ``SpatialBottleneck``);
counterpart of ``apex_tpu/contrib/bottleneck``.

``Bottleneck`` is conv1x1-BN-ReLU, conv3x3-BN-ReLU, conv1x1-BN with the
residual added before the last ReLU (the BN's fused add, bn_add_relu),
on NHWC activations: each convolution is cuDNN's on a channels-last
view (:func:`apex_tpu_torch.contrib.conv_bias_relu.conv_nhwc`), each
norm a :class:`~apex_tpu_torch.contrib.groupbn.BatchNorm2d_NHWC`.
``SpatialBottleneck`` runs the same block with H split over a parallel
axis: the 3x3 convolution takes one halo row from each neighbour
(:func:`apex_tpu_torch.contrib.peer_memory.halo_exchange_1d`) and
convolves with no padding in H, which gives the rows of the unsplit
convolution.  Its norms keep ``bn_group = 1``: in training each rank's
statistics are its strip's, as in the reference.

The submodules are ``conv1``, ``conv2``, ``conv3`` and (where the
stride or the width changes) ``downsample``, each holding ``conv`` (an
OIHW ``weight`` in channels-last memory format, no bias) and ``bn``:
the names of the JAX module's tree, which :func:`from_jax_variables`
walks (HWIO kernels to OIHW).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from apex_tpu_torch.contrib import groupbn
from apex_tpu_torch.contrib.conv_bias_relu import conv_nhwc
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.contrib.peer_memory import halo_exchange_1d
from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["Bottleneck", "SpatialBottleneck"]


class _Conv(nn.Module):
    """A bias-free convolution's OIHW weight (channels-last memory
    format), drawn from ``generator`` with std 1/sqrt(fan_in)."""

    def __init__(self, cin: int, cout: int, k: int, device,
                 generator: torch.Generator):
        super().__init__()
        w = torch.randn(cout, cin, k, k, generator=generator) \
            / math.sqrt(cin * k * k)
        self.weight = nn.Parameter(
            w.to(device).contiguous(memory_format=torch.channels_last))


class _ConvBn(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 fuse_relu: bool = True,
                 spatial_axis_name: Optional[str] = None,
                 dtype=torch.float32, *, device, generator):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.spatial_axis_name = spatial_axis_name
        self.conv = _Conv(cin, cout, k, device, generator)
        self.bn = BatchNorm2d_NHWC(cout, fuse_relu=fuse_relu, dtype=dtype,
                                   device=device)

    def forward(self, x, z=None, *, train: bool = True):
        p = (self.k - 1) // 2
        padding = ((p, p), (p, p))
        if self.spatial_axis_name is not None and self.k == 3:
            # one halo row from each neighbour, then no padding in H
            x = halo_exchange_1d(x, 1, axis=1,
                                 axis_name=self.spatial_axis_name)
            padding = ((0, 0), (1, 1))
        y = conv_nhwc(x.to(self.dtype), self.conv.weight.to(self.dtype),
                      stride=self.stride, padding=padding)
        return self.bn(y, z, use_running_average=not train)


class Bottleneck(nn.Module):
    """≙ ``Bottleneck(in_channels, bottleneck_channels, out_channels,
    stride)`` on NHWC input; ``forward(x, train=True)``.  The weights are
    drawn from ``generator`` (seed 0 by default) on the host, then moved
    to ``device``; compute runs in ``dtype``, the parameters are f32."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1, dtype=torch.float32,
                 spatial_axis_name: Optional[str] = None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if spatial_axis_name is not None and stride != 1:
            raise ValueError(
                "spatial parallelism requires stride=1 (the halo exchange "
                "does not support strided 3x3 convolutions, as in the "
                "reference)")
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        kw = dict(dtype=dtype, device=dev, generator=gen)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.stride, self.dtype = stride, dtype
        self.spatial_axis_name = spatial_axis_name
        self.conv1 = _ConvBn(in_channels, bottleneck_channels, 1, **kw)
        self.conv2 = _ConvBn(bottleneck_channels, bottleneck_channels, 3,
                             stride, spatial_axis_name=spatial_axis_name,
                             **kw)
        self.downsample = None
        if stride != 1 or in_channels != out_channels:
            self.downsample = _ConvBn(in_channels, out_channels, 1, stride,
                                      fuse_relu=False, **kw)
        self.conv3 = _ConvBn(bottleneck_channels, out_channels, 1, **kw)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        residual = x
        y = self.conv1(x, train=train)
        y = self.conv2(y, train=train)
        if self.downsample is not None:
            residual = self.downsample(x, train=train)
        # the last 1x1 + BN with the residual added before its ReLU
        return self.conv3(y, residual, train=train)


class SpatialBottleneck(Bottleneck):
    """≙ ``SpatialBottleneck``: :class:`Bottleneck` with H split over
    ``spatial_axis_name`` (``"dp"`` unless given); each rank passes its
    strip of rows.  Only stride-1 blocks may be split."""

    def __init__(self, *args, spatial_axis_name: Optional[str] = "dp",
                 **kwargs):
        super().__init__(*args, spatial_axis_name=spatial_axis_name,
                         **kwargs)


@torch.no_grad()
def from_jax_variables(module: Bottleneck, variables_np: Mapping
                       ) -> Bottleneck:
    """Copy a JAX ``Bottleneck``'s ``{"params", "batch_stats"}`` (numpy)
    into ``module`` (HWIO kernels to OIHW); returns it."""
    for name in ("conv1", "conv2", "conv3", "downsample"):
        sub = getattr(module, name)
        if sub is None:
            continue
        params = variables_np["params"][name]
        kernel = np.asarray(params["conv"]["kernel"], np.float32)
        sub.conv.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))))
        groupbn.from_jax_variables(sub.bn, {
            "params": params["bn"],
            "batch_stats": variables_np["batch_stats"][name]["bn"]})
    return module

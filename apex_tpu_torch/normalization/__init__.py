"""Fused normalization modules — counterpart of
:mod:`apex_tpu.normalization` (≙ ``apex/normalization/fused_layer_norm.py``
:: ``FusedLayerNorm``, ``FusedRMSNorm``, ``MixedFusedLayerNorm``,
``MixedFusedRMSNorm``, and ``instance_norm.py``).

``FusedLayerNorm`` and ``FusedRMSNorm`` are ``nn.Module``s over the
port's ``fused_layer_norm_affine`` / ``fused_layer_norm`` /
``fused_rms_norm_affine`` / ``fused_rms_norm``: K1 forward and K2
backward on the card, their plain twins on the CPU.  The parameters are
f32 by default (``param_dtype``) whatever the input dtype, and the
statistics are always f32, so the "Mixed" classes are aliases, as in
the reference.  ``memory_efficient`` is K2's ``x_is_output``: the
backward recomputes from the output instead of keeping the input.
:func:`from_jax_params` loads a JAX module's variables into any of
these modules.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
from torch import nn

from apex_tpu_torch.normalization.instance_norm import (  # noqa: F401
    InstanceNorm3d,
    InstanceNorm3dNVFuser,
    instance_norm,
)
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
)

__all__ = [
    "FusedLayerNorm",
    "FusedRMSNorm",
    "MixedFusedLayerNorm",
    "MixedFusedRMSNorm",
    "InstanceNorm3d",
    "InstanceNorm3dNVFuser",
    "instance_norm",
    "from_jax_params",
]

Shape = Union[int, Sequence[int]]


def _as_tuple(normalized_shape: Shape):
    if isinstance(normalized_shape, int):
        return (normalized_shape,)
    return tuple(normalized_shape)


class _Norm(nn.Module):
    def __init__(self, normalized_shape: Shape, eps: float,
                 elementwise_affine: bool, memory_efficient: bool,
                 param_dtype, device, with_bias: bool):
        super().__init__()
        self.normalized_shape = _as_tuple(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.memory_efficient = memory_efficient
        dev = resolve_device(device)
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=param_dtype, device=dev))
            self.bias = nn.Parameter(torch.zeros(
                self.normalized_shape, dtype=param_dtype, device=dev)) \
                if with_bias else None
        else:
            self.register_parameter("weight", None)
            self.bias = None

    def extra_repr(self) -> str:
        return (f"{self.normalized_shape}, eps={self.eps}, "
                f"elementwise_affine={self.elementwise_affine}, "
                f"memory_efficient={self.memory_efficient}")


class FusedLayerNorm(_Norm):
    """≙ ``apex.normalization.FusedLayerNorm`` (``elementwise_affine``
    and ``memory_efficient`` included)."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False,
                 param_dtype=torch.float32, device="cuda"):
        super().__init__(normalized_shape, eps, elementwise_affine,
                         memory_efficient, param_dtype, device, True)

    def forward(self, x):
        if self.elementwise_affine:
            return fused_layer_norm_affine(
                x, self.weight, self.bias, self.normalized_shape, self.eps,
                self.memory_efficient)
        return fused_layer_norm(x, self.normalized_shape, self.eps,
                                self.memory_efficient)


class FusedRMSNorm(_Norm):
    """≙ ``apex.normalization.FusedRMSNorm``."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False,
                 param_dtype=torch.float32, device="cuda"):
        super().__init__(normalized_shape, eps, elementwise_affine,
                         memory_efficient, param_dtype, device, False)

    def forward(self, x):
        if self.elementwise_affine:
            return fused_rms_norm_affine(x, self.weight,
                                         self.normalized_shape, self.eps,
                                         self.memory_efficient)
        return fused_rms_norm(x, self.normalized_shape, self.eps,
                              self.memory_efficient)


# f32 parameters with half inputs is the default (see the module
# docstring): the Mixed classes are aliases kept for the reference's names
MixedFusedLayerNorm = FusedLayerNorm
MixedFusedRMSNorm = FusedRMSNorm


@torch.no_grad()
def from_jax_params(module: nn.Module, variables_np) -> nn.Module:
    """Copy a JAX normalization module's variables (numpy; ``{"params":
    ..., "batch_stats": ...}`` or the params alone) into ``module``:
    ``weight``/``bias`` by name (``scale`` is ``weight``), the running
    ``mean``/``var`` into ``running_mean``/``running_var``; returns it."""
    nested = "params" in variables_np or "batch_stats" in variables_np
    params = variables_np.get("params", {}) if nested else variables_np
    names = {"scale": "weight", "weight": "weight", "bias": "bias"}
    for key, value in params.items():
        getattr(module, names[key]).copy_(torch.tensor(np.asarray(value)))
    for key, value in variables_np.get("batch_stats", {}).items():
        getattr(module, f"running_{key}").copy_(
            torch.tensor(np.asarray(value)))
    return module

"""Fused dense layers — counterpart of :mod:`apex_tpu.fused_dense` (≙
``apex/fused_dense/fused_dense.py`` :: ``FusedDense``,
``FusedDenseGeluDense`` and their functions).

The reference folds bias and GELU into one XLA expression; it has no
kernel here.  The port's GEMMs are cuBLAS calls that accumulate in f32
and add the bias before their one rounding to the input's dtype
(:func:`apex_tpu_torch.mlp.linear_f32_accumulate`); the GELU is the
tanh approximation (the reference's ``jax.nn.gelu(approximate=True)``),
taken in f32 on the first GEMM's output.  For half-precision inputs that
output is the rounded one: the reference applies the GELU before its
rounding, so the two may differ by one half-precision step there; in f32
they compute the same expression.  Weights are ``(out, in)`` (Apex's
``weight``/``bias`` and ``weight1``/``bias1``/``weight2``/``bias2``);
:func:`from_jax_params` carries a JAX module's ``(in, out)`` kernels
across.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.mlp import lecun_normal_, linear_f32_accumulate
from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = [
    "FusedDense",
    "FusedDenseGeluDense",
    "fused_dense_function",
    "fused_dense_gelu_dense_function",
    "from_jax_params",
]


def fused_dense_function(x, weight, bias=None):
    """GEMM + bias (≙ ``fused_dense_cuda.linear_bias_forward``);
    ``weight`` is ``(out, in)``."""
    from apex_tpu_torch.amp.lists import amp_cast

    x, weight, bias = amp_cast("fused_dense", x, weight, bias)
    return linear_f32_accumulate(x, weight, bias)


def fused_dense_gelu_dense_function(x, weight1, bias1, weight2, bias2):
    """GEMM + bias + GELU + GEMM + bias (≙
    ``linear_gelu_linear_forward``), the tanh-approximate GELU."""
    from apex_tpu_torch.amp.lists import amp_cast

    x, weight1, bias1, weight2, bias2 = amp_cast(
        "fused_dense_gelu_dense", x, weight1, bias1, weight2, bias2)
    h = linear_f32_accumulate(x, weight1, bias1)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return linear_f32_accumulate(h, weight2, bias2)


def _dense_params(module, din, dout, suffix, bias, dtype, dev, generator):
    w = nn.Parameter(torch.empty(dout, din, dtype=dtype, device=dev))
    lecun_normal_(w, din, generator)
    module.register_parameter(f"weight{suffix}", w)
    module.register_parameter(
        f"bias{suffix}", nn.Parameter(torch.zeros(
            dout, dtype=dtype, device=dev)) if bias else None)


class FusedDense(nn.Module):
    """≙ ``apex.fused_dense.FusedDense(in_features, out_features,
    bias=True)``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        _dense_params(self, in_features, out_features, "", bias, dtype,
                      resolve_device(device), generator)

    def forward(self, x):
        return fused_dense_function(x.to(self.weight.dtype), self.weight,
                                    self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class FusedDenseGeluDense(nn.Module):
    """≙ ``apex.fused_dense.FusedDenseGeluDense(in_features,
    intermediate_features, out_features)`` (the transformer FFN)."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int, bias: bool = True, dtype=torch.float32,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.intermediate_features = intermediate_features
        self.out_features = out_features
        dev = resolve_device(device)
        _dense_params(self, in_features, intermediate_features, "1", bias,
                      dtype, dev, generator)
        _dense_params(self, intermediate_features, out_features, "2", bias,
                      dtype, dev, generator)

    def forward(self, x):
        return fused_dense_gelu_dense_function(
            x.to(self.weight1.dtype), self.weight1, self.bias1,
            self.weight2, self.bias2)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, intermediate_features="
                f"{self.intermediate_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias1 is not None}")


#: the JAX modules' parameter names and the port's
_JAX_NAMES = {"kernel": "weight", "bias": "bias", "kernel_1": "weight1",
              "bias_1": "bias1", "kernel_2": "weight2", "bias_2": "bias2"}


@torch.no_grad()
def from_jax_params(module: nn.Module, params_np) -> nn.Module:
    """Copy a JAX ``FusedDense``/``FusedDenseGeluDense``'s params (numpy;
    ``{"params": ...}`` or the params alone) into ``module``, each
    ``(in, out)`` kernel transposed to ``(out, in)``; returns it."""
    params = params_np.get("params", params_np)
    for key, value in params.items():
        value = torch.tensor(np.asarray(value))
        if key.startswith("kernel"):
            value = value.t()
        getattr(module, _JAX_NAMES[key]).copy_(value)
    return module

"""Fused MLP — counterpart of :mod:`apex_tpu.mlp` (≙ ``apex/mlp/mlp.py``
:: ``MLP`` / ``MlpFunction``).

The reference has no kernel here: its chain of GEMMs with bias and
ReLU/sigmoid epilogues is one XLA fusion.  The port's products are plain
cuBLAS calls (``torch.addmm``: f32 accumulation, the bias added in f32,
one rounding to the input's dtype — the reference's
``preferred_element_type=f32`` then ``.astype(x.dtype)``), the
activation in PyTorch between layers.  Weights are in PyTorch's
``(out, in)`` layout; :func:`from_jax_params` carries a JAX module's
``(in, out)`` kernels across.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["MLP", "mlp_function", "from_jax_params"]

_ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
}


def linear_f32_accumulate(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``x @ weight.T + bias`` over the last axis of ``x`` in one GEMM
    that accumulates in f32, adds the bias before its single rounding,
    and returns ``x``'s dtype; ``weight`` is ``(out, in)``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if bias is None:
        y = torch.mm(x2, weight.t())
    else:
        y = torch.addmm(bias.to(x.dtype), x2, weight.t())
    return y.reshape(*lead, weight.shape[0])


def mlp_function(x: torch.Tensor, weights: Sequence[torch.Tensor],
                 biases: Sequence[Optional[torch.Tensor]],
                 activation: str = "relu") -> torch.Tensor:
    """``(..., in) -> (..., out)`` through ``len(weights)`` GEMM + bias
    stages, the activation after every stage *except the last* (the
    reference's ``MLP`` applies it between layers only).  ``biases`` may
    be empty or hold None for a bias-free stage."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"activation must be one of {sorted(_ACTIVATIONS)}")
    if not weights:
        raise ValueError("mlp_function requires at least one weight matrix")
    from apex_tpu_torch.amp.lists import amp_cast

    n = len(weights)
    biases = list(biases) if biases else [None] * n
    cast = amp_cast("mlp", x, *weights, *biases)
    if not isinstance(cast, tuple):
        cast = (cast,)
    x, weights, biases = cast[0], cast[1:1 + n], cast[1 + n:]
    act = _ACTIVATIONS[activation]
    h = x
    for i, w in enumerate(weights):
        h = linear_f32_accumulate(h, w, biases[i])
        if i != n - 1:
            h = act(h)
    return h


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)


class MLP(nn.Module):
    """≙ ``apex.mlp.MLP(mlp_sizes, bias=True, activation='relu')``.

    ``mlp_sizes`` lists every layer width *including* the input width,
    as the reference's constructor.  The parameters are ``weight_{i}``
    ``(out, in)`` and ``bias_{i}``, as in upstream Apex."""

    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu", dtype=torch.float32,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(mlp_sizes) < 2:
            raise ValueError("mlp_sizes needs at least (in, out)")
        if activation not in _ACTIVATIONS:
            raise ValueError(
                f"activation must be one of {sorted(_ACTIVATIONS)}")
        dev = resolve_device(device)
        self.mlp_sizes = tuple(int(s) for s in mlp_sizes)
        self.bias = bias
        self.activation = activation
        self.num_layers = len(self.mlp_sizes) - 1
        for i, (din, dout) in enumerate(zip(self.mlp_sizes[:-1],
                                            self.mlp_sizes[1:])):
            w = nn.Parameter(torch.empty(dout, din, dtype=dtype, device=dev))
            lecun_normal_(w, din, generator)
            self.register_parameter(f"weight_{i}", w)
            self.register_parameter(
                f"bias_{i}", nn.Parameter(torch.zeros(
                    dout, dtype=dtype, device=dev)) if bias else None)

    @property
    def weights(self):
        return [getattr(self, f"weight_{i}") for i in range(self.num_layers)]

    @property
    def biases(self):
        return [getattr(self, f"bias_{i}") for i in range(self.num_layers)]

    def forward(self, x):
        if x.shape[-1] != self.mlp_sizes[0]:
            raise ValueError(f"input width {x.shape[-1]} != "
                             f"mlp_sizes[0]={self.mlp_sizes[0]}")
        return mlp_function(x.to(self.weight_0.dtype), self.weights,
                            self.biases, self.activation)

    def extra_repr(self) -> str:
        return (f"mlp_sizes={list(self.mlp_sizes)}, bias={self.bias}, "
                f"activation={self.activation}")


@torch.no_grad()
def from_jax_params(module: nn.Module, params_np) -> nn.Module:
    """Copy a JAX :class:`~apex_tpu.mlp.MLP`'s params (numpy; the
    ``{"params": ...}`` tree or the params alone) into ``module``:
    ``kernel_{i}`` ``(in, out)`` becomes ``weight_{i}`` ``(out, in)``,
    ``bias_{i}`` is copied; returns ``module``."""
    params = params_np.get("params", params_np)
    for key, value in params.items():
        value = torch.tensor(np.asarray(value))
        kind, i = key.rsplit("_", 1)
        if kind == "kernel":
            getattr(module, f"weight_{i}").copy_(value.t())
        else:
            getattr(module, f"bias_{i}").copy_(value)
    return module

"""NHWC GroupNorm with an optional SiLU — ≙ ``apex/contrib/group_norm``
(``GroupNorm``); counterpart of ``apex_tpu/contrib/group_norm``.

Upstream hand-writes NHWC GroupNorm kernels (with a fused swish) for a
table of channel counts, for diffusion models.  Here it is a plain
PyTorch composition on channels-last input with f32 statistics over
(spatial, C / G) per group, any channel count that ``num_groups``
divides, and the result in the input's dtype (after amp's cast).
:func:`from_jax_params` (the normalization modules' loader) copies a JAX
``GroupNorm``'s ``weight`` and ``bias`` into a :class:`GroupNorm`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.amp.lists import amp_cast
from apex_tpu_torch.normalization import from_jax_params  # noqa: F401
from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["GroupNorm", "group_norm"]

_ACTS = {None: lambda y: y, "": lambda y: y, "silu": F.silu, "swish": F.silu}


def group_norm(x: torch.Tensor, num_groups: int,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
               act: Optional[str] = None) -> torch.Tensor:
    """``x`` (N, ..., C) channels-last; statistics over (spatial..., C /
    ``num_groups``) per group in f32; ``act`` None, "", "silu" or
    "swish"."""
    if act not in _ACTS:
        raise ValueError(
            f"act must be one of {sorted(k or '' for k in _ACTS)}")
    x, weight, bias = amp_cast("group_norm", x, weight, bias)
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(
            f"channels {c} not divisible by num_groups {num_groups}")
    xf = x.float().reshape(x.shape[0], -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return _ACTS[act](y).to(x.dtype)


class GroupNorm(nn.Module):
    """≙ ``GroupNorm(num_groups, num_channels, eps, affine, act)``: a
    drop-in for ``torch.nn.GroupNorm`` on channels-last input, plus the
    ``act`` fusion."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 affine: bool = True, act: Optional[str] = None, *,
                 param_dtype=torch.float32, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.num_groups, self.num_channels = num_groups, num_channels
        self.eps, self.act = eps, act
        if affine:
            self.weight = nn.Parameter(torch.ones(
                num_channels, dtype=param_dtype, device=dev))
            self.bias = nn.Parameter(torch.zeros(
                num_channels, dtype=param_dtype, device=dev))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.num_channels:
            raise ValueError(
                f"expected channels-last input with {self.num_channels} "
                f"channels, got {tuple(x.shape)}")
        return group_norm(x, self.num_groups, self.weight, self.bias,
                          self.eps, self.act)

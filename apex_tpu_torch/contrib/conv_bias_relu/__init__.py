"""Convolution + bias (+ ReLU, + mask) on NHWC activations — ≙
``apex/contrib/conv_bias_relu`` (``ConvBias``, ``ConvBiasReLU``,
``ConvBiasMaskReLU``); counterpart of
``apex_tpu/contrib/conv_bias_relu``.

Upstream fuses the epilogue into a cuDNN runtime-fusion graph; here the
convolution is ``F.conv2d`` (cuDNN) on the NCHW view of the NHWC input,
``x.permute(0, 3, 1, 2)``, whose strides are channels-last: cuDNN takes
its NHWC kernels with no copy of the activations, and the result,
channels-last too, is permuted back to NHWC for free.  The weight is
PyTorch's ``(C_out, C_in, KH, KW)``; one stored in ``channels_last``
memory format (``w.to(memory_format=torch.channels_last)``) spares the
convolution a copy of it as well (a 1x1 weight already is).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch.amp.lists import amp_cast

__all__ = ["ConvBias", "ConvBiasReLU", "ConvBiasMaskReLU", "conv_bias",
           "conv_nhwc"]

Padding = Union[int, Sequence[Tuple[int, int]]]


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, *, stride=1,
              padding: Padding = 0) -> torch.Tensor:
    """``F.conv2d`` of NHWC ``x`` with an OIHW ``weight``, NHWC out.
    ``padding`` is an int or ``((top, bottom), (left, right))``; an
    uneven pair pads the input first (``F.pad``)."""
    xc = x.permute(0, 3, 1, 2)  # NCHW view, channels-last strides
    if not isinstance(padding, int):
        (t, b), (l, r) = padding
        if t == b and l == r:
            padding = (t, l)
        else:
            xc, padding = F.pad(xc, (l, r, t, b)), 0
    return F.conv2d(xc, weight, stride=stride,
                    padding=padding).permute(0, 2, 3, 1)


def conv_bias(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
              stride=1, padding: Padding = 1) -> torch.Tensor:
    """NHWC ``x`` (N, H, W, C_in) convolved with ``weight`` (C_out, C_in,
    KH, KW) plus ``bias`` (C_out,), added in the convolution's output
    dtype; returned in ``x``'s dtype (after amp's cast), NHWC."""
    x, weight, bias = amp_cast("conv_bias_relu", x, weight, bias)
    y = conv_nhwc(x, weight, stride=stride, padding=padding)
    return (y + bias.to(y.dtype)).to(x.dtype)


def ConvBias(x, weight, bias, padding=1, stride=1):
    """≙ ``ConvBias.apply(x, weight, bias, padding, stride)``."""
    return conv_bias(x, weight, bias, stride=stride, padding=padding)


def ConvBiasReLU(x, weight, bias, padding=1, stride=1):
    """≙ ``ConvBiasReLU.apply``: convolution + bias, then ReLU."""
    return F.relu(conv_bias(x, weight, bias, stride=stride, padding=padding))


def ConvBiasMaskReLU(x, weight, bias, mask, padding=1, stride=1):
    """≙ ``ConvBiasMaskReLU.apply``: convolution + bias, times ``mask``
    (NHWC, like the output), then ReLU."""
    return F.relu(conv_bias(x, weight, bias, stride=stride,
                            padding=padding) * mask)

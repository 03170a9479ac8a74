"""FusedScaleMaskSoftmax — the attention-softmax front door.

Counterpart of ``apex_tpu/transformer/functional/fused_softmax.py``
(≙ apex's ``FusedScaleMaskSoftmax``), dispatching to the ops of
:mod:`apex_tpu_torch.ops.scaled_softmax`.  Those ops have no shape or
dtype limits, so ``is_kernel_available`` only reports the fusion flag;
``softmax_in_fp32`` keeps its meaning by construction (every path
reduces in f32 and returns the input's dtype).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.ops.scaled_softmax import (
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.transformer.enums import AttnMaskType

__all__ = ["FusedScaleMaskSoftmax"]


class FusedScaleMaskSoftmax:
    """Callable config object with the reference module's signature."""

    def __init__(
        self,
        input_in_fp16: bool = False,
        input_in_bf16: bool = False,
        attn_mask_type: AttnMaskType = AttnMaskType.padding,
        scaled_masked_softmax_fusion: bool = True,
        mask_func: Optional[Callable] = None,
        softmax_in_fp32: bool = True,
        scale: Optional[float] = None,
    ):
        if input_in_fp16 and input_in_bf16:
            raise RuntimeError("both fp16 and bf16 flags cannot be active")
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        if self.scale is not None and not softmax_in_fp32:
            raise RuntimeError("softmax should be in fp32 when scaled")

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        """≙ the reference heuristic; the ops have no shape limits."""
        return self.fusion

    def __call__(self, x, mask=None):
        scale = self.scale if self.scale is not None else 1.0
        if self.mask_func is not None:
            # the reference's unfused path: scale, the user's mask
            # function (e.g. an additive bias), then a plain softmax
            xs = x.float() * scale
            xs = self.mask_func(xs, mask) if mask is not None else xs
            return torch.softmax(xs, dim=-1).to(x.dtype)
        if self.attn_mask_type == AttnMaskType.causal:
            *lead, sq, sk = x.shape
            return scaled_upper_triang_masked_softmax(
                x.reshape(-1, sq, sk), scale).reshape(*lead, sq, sk)
        if mask is not None:
            return scaled_masked_softmax(x, mask, scale)
        return scaled_softmax(x, scale)

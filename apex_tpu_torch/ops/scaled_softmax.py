"""Scaled (masked) softmax family — the attention softmax ops.

Counterpart of ``apex_tpu/ops/scaled_softmax.py`` (≙ the reference's
megatron softmax kernels ``scaled_softmax``, ``scaled_masked_softmax``,
``scaled_upper_triang_masked_softmax`` and
``generic_scaled_masked_softmax``): plain PyTorch, as the JAX versions
are jnp compositions.  Each op is an autograd function whose backward is
the reference kernel's: ``dx = scale * y * (g - sum(g * y, -1))`` in
f32, from the saved output.

The statistics run in f32 and the output comes back in the input's
dtype.  ``mask`` is boolean with True = masked out; masked positions
get ``-10000.0`` after scaling.  :func:`scaled_masked_softmax` gives a
row whose every position is masked exact zeros; the causal variant
masks the strict upper triangle of square scores.

Each op casts its input by the active amp policy first (``amp_cast``
under ``"scaled_softmax"`` or ``"scaled_masked_softmax"``, both fp32
ops): under O1 a half input runs, and comes back, in f32; with no
policy active the input passes as it is.
"""

from __future__ import annotations

import torch

__all__ = [
    "scaled_softmax",
    "scaled_masked_softmax",
    "scaled_upper_triang_masked_softmax",
    "generic_scaled_masked_softmax",
]

_MASK_FILL = -10000.0


def _softmax_f32(xf):
    m = xf.max(dim=-1, keepdim=True).values
    e = torch.exp(xf - m)
    return e / e.sum(dim=-1, keepdim=True)


def _softmax_bwd(y, g, scale):
    gf, yf = g.float(), y.float()
    dx = yf * (gf - (gf * yf).sum(dim=-1, keepdim=True))
    return (dx * scale).to(g.dtype)


class _ScaledSoftmax(torch.autograd.Function):
    """``softmax(x * scale)``; the product in the input's dtype, then
    the statistics in f32."""

    @staticmethod
    def forward(ctx, x, scale):
        y = _softmax_f32((x * scale).float()).to(x.dtype)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return _softmax_bwd(y, g, ctx.scale), None


class _ScaledMaskedSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mask, scale):
        xs = x.float() * scale
        if mask is not None:
            xs = xs.masked_fill(mask, _MASK_FILL)
        y = _softmax_f32(xs)
        if mask is not None:
            # a fully masked row gives exact zeros, as the reference
            # kernel special-cases it
            all_masked = mask.all(dim=-1, keepdim=True)
            y = y.masked_fill(all_masked, 0.0)
        y = y.to(x.dtype)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, g):
        # masked lanes have y == 0, so dx == 0 there
        (y,) = ctx.saved_tensors
        return _softmax_bwd(y, g, ctx.scale), None, None


class _ScaledUpperTriangMaskedSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale):
        sq, sk = x.shape[-2], x.shape[-1]
        if sq != sk:
            raise ValueError(
                f"scaled_upper_triang_masked_softmax requires square scores, "
                f"got sq={sq}, sk={sk}; use scaled_masked_softmax with an "
                "explicit mask for KV-cache decode shapes"
            )
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=x.device).triu(1)
        y = _softmax_f32((x.float() * scale).masked_fill(causal, _MASK_FILL))
        y = y.to(x.dtype)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return _softmax_bwd(y, g, ctx.scale), None


def _amp(name, x):
    from apex_tpu_torch.amp.lists import amp_cast

    return amp_cast(name, x)


def scaled_softmax(x, scale):
    """``softmax(x * scale)`` — ≙ ScaledSoftmax."""
    return _ScaledSoftmax.apply(_amp("scaled_softmax", x), float(scale))


def scaled_masked_softmax(x, mask, scale):
    """``softmax(mask_fill(x * scale))`` over (b, np, sq, sk) — ≙
    ScaledMaskedSoftmax; ``mask`` boolean, broadcastable (e.g. (b, 1,
    sq, sk)), True = masked, or None."""
    return _ScaledMaskedSoftmax.apply(_amp("scaled_masked_softmax", x),
                                      mask, float(scale))


def scaled_upper_triang_masked_softmax(x, scale):
    """Causal softmax over (b, sq, sk), sq == sk — ≙
    ScaledUpperTriangMaskedSoftmax.  Row 0 attends only to column 0."""
    return _ScaledUpperTriangMaskedSoftmax.apply(_amp("scaled_softmax", x),
                                                 float(scale))


def generic_scaled_masked_softmax(x, mask, scale):
    """Masked softmax of any shape — ≙ generic_scaled_masked_softmax:
    the math of :func:`scaled_masked_softmax`."""
    return scaled_masked_softmax(x, mask, scale)

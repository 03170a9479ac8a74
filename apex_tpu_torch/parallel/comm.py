"""The blockwise int8 codec of the gradient wire.

Counterpart of the codec in ``apex_tpu/parallel/comm.py``
(``DEFAULT_BLOCK``, ``_QMAX``, ``quantize_blocks``,
``dequantize_blocks``), with the reference's rules:

- the last dim is cut into blocks of ``block`` elements, the tail
  zero-padded into its own block (zeros never raise a block's max, so
  real elements keep their scale);
- a block's scale is ``max|block| / 127``, floored at f32 ``tiny``; an
  all-zero block gets scale 1.0, so dequantizing never divides by zero
  or overflows;
- codes are ``round(x / scale)`` (round half to even, as ``jnp.round``)
  clipped to ±127.  The division is a division: multiplying by the
  reciprocal moves codes at ties.

The serving stack puts its int8 KV wire (one scale per (head, token)
row, ``block = head_dim``) and its int8 weight wire on this codec.  The
rest of the reference module (the f32/bf16/int8 gradient sync, chunking,
``sync_plan``, ``zero_plan``) comes with data parallelism.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["DEFAULT_BLOCK", "quantize_blocks", "dequantize_blocks"]

_QMAX = 127.0
DEFAULT_BLOCK = 256
_TINY = torch.finfo(torch.float32).tiny


def quantize_blocks(x: torch.Tensor, block: int = DEFAULT_BLOCK):
    """``x (..., n)`` f32 -> int8 codes ``(..., n_pad)`` and f32 scales
    ``(..., n_pad / block)``, ``n_pad`` the next multiple of ``block``."""
    x = x.float()
    n = x.shape[-1]
    pad = (-n) % block
    if pad:
        x = F.pad(x, (0, pad))
    xb = x.reshape(*x.shape[:-1], -1, block)
    m = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(m / _QMAX, _TINY)
    scale = torch.where(m > 0, scale, 1.0)
    q = torch.clamp(torch.round(xb / scale), -_QMAX, _QMAX).to(torch.int8)
    return q.reshape(*x.shape[:-1], n + pad), scale[..., 0]


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                      block: int = DEFAULT_BLOCK, n: Optional[int] = None):
    """Inverse of :func:`quantize_blocks` in f32; ``n`` slices the
    zero-pad back off.  The values sit on the int8 grid, so a second
    round trip is exact."""
    shape = q.shape
    xb = q.reshape(*shape[:-1], -1, block).float()
    out = (xb * scale[..., None]).reshape(shape)
    if n is not None and n != shape[-1]:
        out = out[..., :n]
    return out

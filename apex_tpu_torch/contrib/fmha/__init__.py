"""FMHA — packed attention over a padded batch; counterpart of
``apex_tpu/contrib/fmha`` (≙ ``apex/contrib/fmha`` :: ``FMHAFun``).

The reference takes an unpadded, token-packed ``(total_tokens, 3, H,
D)`` QKV with ``cu_seqlens`` offsets.  Here, as in the JAX package, the
batch stays padded to ``(B, S, 3, H, D)`` and the keys past each
sequence's length are masked by an additive bias built from ``seqlens``
(``MASK_VALUE``); the work per valid token is the same.  K3 runs the
forward and K4 the backward on the card (:func:`fmha_qkvpacked`).
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.attention import MASK_VALUE, fmha_qkvpacked

__all__ = ["fmha", "fmha_qkvpacked", "padding_bias_from_seqlens"]


def padding_bias_from_seqlens(seqlens: torch.Tensor,
                              max_seqlen: int) -> torch.Tensor:
    """(B,) valid lengths -> (B, 1, 1, S) f32 additive key-padding
    bias: 0 for a key inside the sequence, ``MASK_VALUE`` past it."""
    pos = torch.arange(max_seqlen, device=seqlens.device)
    keep = pos[None, :] < seqlens[:, None]
    bias = torch.where(keep, 0.0, MASK_VALUE).to(torch.float32)
    return bias[:, None, None, :]


def fmha(qkv, seqlens: Optional[torch.Tensor] = None, *,
         causal: bool = False, dropout_p: float = 0.0,
         generator: Optional[torch.Generator] = None,
         dropout_seed: Optional[torch.Tensor] = None):
    """≙ ``FMHAFun(qkv, cu_seqlens, ...)`` on a padded batch: ``qkv``
    (B, S, 3, H, D), ``seqlens`` optional (B,) valid lengths -> (B, S,
    H, D).  The bias masks the keys past ``seqlens``; the query rows
    past it still attend (over the valid keys) and give values the
    caller masks downstream, as the reference's unpadded layout implies
    for tokens that do not exist.  Dropout as in ``flash_attention``."""
    bias = None
    if seqlens is not None:
        bias = padding_bias_from_seqlens(seqlens, qkv.shape[1])
    return fmha_qkvpacked(qkv, bias, causal=causal, dropout_p=dropout_p,
                          generator=generator, dropout_seed=dropout_seed)

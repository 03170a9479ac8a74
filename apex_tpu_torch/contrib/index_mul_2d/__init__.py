"""Gather-multiply — ≙ ``apex/contrib/index_mul_2d``; counterpart of
``apex_tpu/contrib/index_mul_2d``.

``out = in1[idx1] * in2``.  The backward scatters ``in1``'s gradient
back through the gather and accumulates over repeated indices:
``index_select``'s backward is ``index_add_`` (on the card an atomic
scatter-add, so the f32 order of the sums varies from run to run).
"""

from __future__ import annotations

import torch

from apex_tpu_torch.amp.lists import amp_cast

__all__ = ["index_mul_2d"]


def index_mul_2d(in1: torch.Tensor, in2: torch.Tensor,
                 idx1: torch.Tensor) -> torch.Tensor:
    """``in1`` (N, E), ``in2`` (K, E), ``idx1`` (K,) integer -> (K, E)
    ``in1[idx1] * in2``."""
    if in2.shape[0] != idx1.shape[0]:
        raise ValueError(
            f"in2 rows ({in2.shape[0]}) must match idx1 length "
            f"({idx1.shape[0]})")
    in1, in2 = amp_cast("index_mul_2d", in1, in2)
    return in1.index_select(0, idx1) * in2

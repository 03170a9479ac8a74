"""FusedMixedPrecisionLamb — LAMB with f32 master parameters inside the
optimizer; counterpart of
``apex_tpu/optimizers/fused_mixed_precision_lamb.py`` (≙ apex's
``fused_mixed_precision_lamb.py``).

The state carries f32 copies of the (possibly half) model parameters
beside the LAMB moments.  ``update`` runs :func:`fused_lamb` on the
masters with the gradients in f32, advances them, and returns
``master.to(p.dtype) - p`` as the update, so that adding it leaves the
model parameters at the rounded masters.  With f32 parameters this is
:func:`fused_lamb` with an extra copy.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from apex_tpu_torch.amp.policy import to_f32
from apex_tpu_torch.optimizers.fused_adam import Transform
from apex_tpu_torch.optimizers.fused_lamb import fused_lamb
from apex_tpu_torch.optimizers.fused_sgd import Stateful

__all__ = ["FusedMixedPrecisionLamb", "MixedPrecisionLambState",
           "fused_mixed_precision_lamb"]


class MixedPrecisionLambState(NamedTuple):
    masters: Any  # f32 copies of the model parameters
    inner: Any  # the wrapped LAMB's state


def fused_mixed_precision_lamb(*args, **kwargs) -> Transform:
    """:func:`fused_lamb`'s signature (lr, betas, eps, weight_decay,
    bias_correction, grad_averaging, adam_w_mode, max_grad_norm,
    use_nvlamb)."""
    inner = fused_lamb(*args, **kwargs)

    def init(params):
        masters = to_f32(params)
        return MixedPrecisionLambState(masters=masters,
                                       inner=inner.init(masters))

    @torch.no_grad()
    def update(grads, state, params=None):
        if params is None:
            raise ValueError(
                "fused_mixed_precision_lamb requires params for the update")
        m_updates, inner_state = inner.update(to_f32(grads), state.inner,
                                              state.masters)
        masters = {k: m + m_updates[k] for k, m in state.masters.items()}
        updates = {k: masters[k].to(p.dtype) - p for k, p in params.items()}
        return updates, MixedPrecisionLambState(masters=masters,
                                                inner=inner_state)

    return Transform(init, update)


class FusedMixedPrecisionLamb(Stateful):
    """≙ the reference class: ``FusedMixedPrecisionLamb(params,
    **fused_lamb_kwargs)``."""

    def __init__(self, params, **kwargs):
        super().__init__(fused_mixed_precision_lamb(**kwargs), params)

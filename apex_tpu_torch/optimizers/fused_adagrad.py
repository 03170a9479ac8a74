"""Fused Adagrad — counterpart of ``apex_tpu/optimizers/fused_adagrad.py``.

The arithmetic of the JAX ``fused_adagrad`` (≙ apex's ``FusedAdagrad``
over ``csrc/multi_tensor_adagrad.cu`` :: ``AdagradFunctor``), in f32
with ``torch._foreach_*``:

    h  += g²
    p  -= lr · g / (√h + eps)   [+ lr·wd·p  decoupled if adagrad_w_mode,
                                 else wd folded into g first]

The sums are stored in ``state_dtype``; the updates carry the
parameter's dtype.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Union

import torch

from apex_tpu_torch.optimizers.fused_adam import (
    ScalarOrSchedule,
    Transform,
    _lr_at,
)
from apex_tpu_torch.optimizers.fused_sgd import Stateful, with_decay

__all__ = ["fused_adagrad", "FusedAdagrad", "FusedAdagradState"]


class FusedAdagradState(NamedTuple):
    count: Union[int, torch.Tensor]
    sum: Dict[str, torch.Tensor]


def fused_adagrad(
    learning_rate: ScalarOrSchedule = 1e-2,
    eps: float = 1e-10,
    weight_decay: float = 0.0,
    adagrad_w_mode: bool = False,
    *,
    state_dtype: torch.dtype = torch.float32,
) -> Transform:
    def init(params):
        return FusedAdagradState(
            count=0, sum={k: torch.zeros_like(p, dtype=state_dtype)
                          for k, p in params.items()})

    @torch.no_grad()
    def update(grads, state, params=None):
        if params is None:
            raise ValueError("fused_adagrad requires params for the update")
        keys = list(params)
        lr = _lr_at(learning_rate, state.count)
        p = [params[k] for k in keys]
        g = with_decay([grads[k] for k in keys], p,
                       0.0 if adagrad_w_mode else weight_decay)
        h = [state.sum[k].float() for k in keys]
        h = torch._foreach_add(h, torch._foreach_mul(g, g))
        u = torch._foreach_div(g, torch._foreach_add(torch._foreach_sqrt(h),
                                                     eps))
        if adagrad_w_mode and weight_decay != 0.0:
            torch._foreach_add_(u, [x.float() for x in p], alpha=weight_decay)
        u = torch._foreach_mul(u, -lr)
        return ({k: t.to(x.dtype) for k, t, x in zip(keys, u, p)},
                FusedAdagradState(
                    count=state.count + 1,
                    sum={k: t.to(state.sum[k].dtype)
                         for k, t in zip(keys, h)}))

    return Transform(init, update)


class FusedAdagrad(Stateful):
    """≙ ``FusedAdagrad(params, lr, eps, weight_decay, adagrad_w_mode)``."""

    def __init__(self, params, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, adagrad_w_mode: bool = False):
        super().__init__(fused_adagrad(lr, eps, weight_decay,
                                       adagrad_w_mode), params)

"""Fused NovoGrad — counterpart of ``apex_tpu/optimizers/fused_novograd.py``.

The arithmetic of the JAX ``fused_novograd`` (≙ apex's ``FusedNovoGrad``
over ``csrc/multi_tensor_novograd.cu`` :: ``NovoGradFunctor``) with a
**per-tensor** (layer-wise) second moment, in f32:

    v_t  = β₂·v_{t-1} + (1-β₂)·‖g_t‖²        (a 0-d tensor per tensor;
                                              first step: v_1 = ‖g_1‖²
                                              unless init_zero)
    u    = g_t / (√v_t + eps)  [+ wd·p  if reg_inside_moment]
    m_t  = β₁·m_{t-1} + (1-β₁ if grad_averaging else 1)·u
    p   -= lr · (m_t [+ wd·p  if not reg_inside_moment])
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Union

import torch

from apex_tpu_torch.optimizers.fused_adam import (
    ScalarOrSchedule,
    Transform,
    _lr_at,
)
from apex_tpu_torch.optimizers.fused_sgd import Stateful, first_step, select

__all__ = ["fused_novograd", "FusedNovoGrad", "FusedNovoGradState"]


class FusedNovoGradState(NamedTuple):
    count: Union[int, torch.Tensor]
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]  # a 0-d tensor per tensor


def fused_novograd(
    learning_rate: ScalarOrSchedule = 1e-3,
    beta1: float = 0.95,
    beta2: float = 0.98,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_averaging: bool = True,
    init_zero: bool = False,
    reg_inside_moment: bool = False,
    *,
    state_dtype: torch.dtype = torch.float32,
) -> Transform:
    beta3 = (1.0 - beta1) if grad_averaging else 1.0

    def init(params):
        return FusedNovoGradState(
            count=0,
            m={k: torch.zeros_like(p, dtype=state_dtype)
               for k, p in params.items()},
            v={k: torch.zeros((), dtype=state_dtype, device=p.device)
               for k, p in params.items()})

    @torch.no_grad()
    def update(grads, state, params=None):
        if params is None:
            raise ValueError("fused_novograd requires params for the update")
        keys = list(params)
        lr = _lr_at(learning_rate, state.count)
        count = state.count + 1
        g = [grads[k].float() for k in keys]
        pf = [params[k].float() for k in keys]
        gn2 = [torch.sum(x * x) for x in g]
        ema = torch._foreach_add(
            torch._foreach_mul([state.v[k].float() for k in keys], beta2),
            torch._foreach_mul(gn2, 1.0 - beta2))
        v = ema if init_zero else select(first_step(count), gn2, ema)
        u = torch._foreach_div(g, torch._foreach_add(torch._foreach_sqrt(v),
                                                     eps))
        if reg_inside_moment and weight_decay != 0.0:
            torch._foreach_add_(u, pf, alpha=weight_decay)
        m = torch._foreach_mul([state.m[k].float() for k in keys], beta1)
        torch._foreach_add_(m, torch._foreach_mul(u, beta3))
        upd = m
        if not reg_inside_moment and weight_decay != 0.0:
            upd = torch._foreach_add(m, pf, alpha=weight_decay)
        upd = torch._foreach_mul(upd, -lr)
        return ({k: t.to(params[k].dtype) for k, t in zip(keys, upd)},
                FusedNovoGradState(
                    count=count,
                    m={k: t.to(state.m[k].dtype) for k, t in zip(keys, m)},
                    v={k: t.to(state.v[k].dtype) for k, t in zip(keys, v)}))

    return Transform(init, update)


class FusedNovoGrad(Stateful):
    """≙ ``FusedNovoGrad(params, lr, betas, eps, weight_decay,
    grad_averaging, init_zero, reg_inside_moment)``."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.95, 0.98),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_averaging: bool = True, init_zero: bool = False,
                 reg_inside_moment: bool = False):
        super().__init__(fused_novograd(
            lr, betas[0], betas[1], eps, weight_decay, grad_averaging,
            init_zero, reg_inside_moment), params)

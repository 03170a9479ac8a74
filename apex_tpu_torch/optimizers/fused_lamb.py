"""Fused LAMB — counterpart of ``apex_tpu/optimizers/fused_lamb.py``.

The arithmetic of the JAX ``fused_lamb`` (≙ apex's ``FusedLAMB``, its
``LAMBStage1Functor`` / ``LAMBStage2Functor`` behind
``multi_tensor_l2norm``), written out in plain PyTorch with
``torch._foreach_*``:

1. the global gradient norm over **every** tensor of the step; the
   gradients are divided by ``max(norm / max_grad_norm, 1)`` (no clip
   when ``max_grad_norm <= 0``);
2. f32 moments ``m = beta1*m + beta3*g`` (``beta3 = 1 - beta1`` with
   ``grad_averaging``, else 1) and ``v = beta2*v + (1-beta2)*g*g``, bias
   correction ``1 - beta**count`` with the 1-based count; the update
   ``u = m_hat / (sqrt(v_hat) + eps)`` plus ``wd * p`` (``adam_w_mode``;
   without it ``wd * p`` goes into the gradient first);
3. the per-tensor trust ratio ``||p|| / ||u||`` where both norms are
   non-zero, else 1, and 1 for every tensor when ``weight_decay == 0``
   unless ``use_nvlamb``; the parameter moves by ``-lr * ratio * u``.

Weight decay applies to every parameter, as in the JAX optimizer (no
exclusion of biases or LayerNorm affines).  ``lr`` is a constant or a
callable of the 0-based step (the optax convention).  The clip ratio and
the trust ratios stay device tensors, so a step waits for nothing.

:func:`fused_lamb` is the functional form (``init``/``update`` over
dicts of tensors); :class:`FusedLAMB` the stateful
``torch.optim.Optimizer``.  Both run :func:`_lamb_step`.  AMSGrad raises.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Union

import torch

from apex_tpu_torch.optimizers.fused_adam import (
    ScalarOrSchedule,
    Transform,
    _lr_at,
    _stored,
)
from apex_tpu_torch.optimizers.multi_tensor import global_norm

__all__ = ["FusedLAMB", "FusedLAMBState", "fused_lamb"]


def _clip_divisor(grads: List[torch.Tensor], max_grad_norm: float
                  ) -> Union[torch.Tensor, float]:
    """``max(global_norm / max_grad_norm, 1)`` as a device scalar (1.0
    when clipping is off)."""
    if max_grad_norm <= 0.0 or not grads:
        return 1.0
    gnorm = global_norm(grads)
    return torch.clamp(gnorm / max_grad_norm, min=1.0)


@torch.no_grad()
def _lamb_step(params: List[torch.Tensor], grads: List[torch.Tensor],
               ms: List[torch.Tensor], vs: List[torch.Tensor], *,
               count: int, lr: float, beta1: float, beta2: float, eps: float,
               weight_decay: float, bias_correction: bool,
               grad_averaging: bool, adam_w_mode: bool, use_nvlamb: bool,
               clip: Union[torch.Tensor, float]) -> List[torch.Tensor]:
    """One LAMB update at the 1-based ``count`` with the gradients
    divided by ``clip``: updates ``ms`` and ``vs`` in place and returns
    the parameter updates ``-lr * ratio * u`` in each parameter's dtype
    (the caller adds them)."""
    if bias_correction:
        if isinstance(count, torch.Tensor):  # a count on the device
            count = count.float()
        bc1 = 1.0 - beta1 ** count
        bc2 = 1.0 - beta2 ** count
    else:
        bc1 = bc2 = 1.0
    beta3 = (1.0 - beta1) if grad_averaging else 1.0
    pf = [p.float() for p in params]
    # out of place: ``g.float()`` of an f32 gradient is the gradient
    gf = torch._foreach_div([g.float() for g in grads], clip)
    if not adam_w_mode and weight_decay != 0.0:
        gf = torch._foreach_add(gf, pf, alpha=weight_decay)
    torch._foreach_mul_(ms, beta1)
    torch._foreach_add_(ms, gf, alpha=beta3)
    torch._foreach_mul_(vs, beta2)
    torch._foreach_add_(vs, torch._foreach_mul(gf, gf), alpha=1.0 - beta2)
    denom = torch._foreach_sqrt(torch._foreach_div(vs, bc2))
    torch._foreach_add_(denom, eps)
    u = torch._foreach_div(torch._foreach_div(ms, bc1), denom)
    if adam_w_mode and weight_decay != 0.0:
        torch._foreach_add_(u, pf, alpha=weight_decay)
    if weight_decay != 0.0 or use_nvlamb:
        w_norm = torch.stack(torch._foreach_norm(pf, 2))
        u_norm = torch.stack(torch._foreach_norm(u, 2))
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        torch._foreach_mul_(u, list((ratio * -lr).unbind(0)))
    else:
        torch._foreach_mul_(u, -lr)
    return [t.to(p.dtype) for t, p in zip(u, params)]


class FusedLAMBState(NamedTuple):
    count: int  # 1-based after the first update
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def fused_lamb(
    learning_rate: ScalarOrSchedule = 1e-3,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    bias_correction: bool = True,
    grad_averaging: bool = True,
    adam_w_mode: bool = True,
    max_grad_norm: float = 1.0,
    use_nvlamb: bool = False,
    *,
    state_dtype: torch.dtype = torch.float32,
):
    """Functional LAMB: ``init(params) -> state`` and ``update(grads,
    state, params) -> (updates, state)`` over dicts of tensors with the
    same keys; the caller adds the updates.  The moments are stored in
    ``state_dtype`` and updated in f32 arithmetic, rounded once on each
    store."""
    hyper = dict(beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay, bias_correction=bias_correction,
                 grad_averaging=grad_averaging, adam_w_mode=adam_w_mode,
                 use_nvlamb=use_nvlamb)

    def init(params):
        return FusedLAMBState(
            count=0,
            m={k: torch.zeros_like(p, dtype=state_dtype)
               for k, p in params.items()},
            v={k: torch.zeros_like(p, dtype=state_dtype)
               for k, p in params.items()},
        )

    def update(grads, state, params):
        keys = list(params)
        m = {k: state.m[k].to(torch.float32, copy=True) for k in keys}
        v = {k: state.v[k].to(torch.float32, copy=True) for k in keys}
        g = [grads[k] for k in keys]
        updates = _lamb_step(
            [params[k] for k in keys], g, [m[k] for k in keys],
            [v[k] for k in keys], count=state.count + 1,
            lr=_lr_at(learning_rate, state.count),
            clip=_clip_divisor(g, max_grad_norm), **hyper,
        )
        return (dict(zip(keys, updates)),
                FusedLAMBState(count=state.count + 1,
                               m=_stored(m, state.m), v=_stored(v, state.v)))

    return Transform(init, update)


class FusedLAMB(torch.optim.Optimizer):
    """apex-shaped stateful LAMB: ``FusedLAMB(model.parameters(),
    lr=...)``, then ``loss.backward(); opt.step(); opt.zero_grad()``.
    The clip takes the global norm over the gradients of every group;
    parameters without a gradient are left alone."""

    def __init__(self, params, lr: ScalarOrSchedule = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, amsgrad: bool = False,
                 adam_w_mode: bool = True, grad_averaging: bool = True,
                 bias_correction: bool = True, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad variant.")
        super().__init__(params, dict(
            lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
            adam_w_mode=adam_w_mode, grad_averaging=grad_averaging,
            bias_correction=bias_correction, max_grad_norm=max_grad_norm,
            use_nvlamb=use_nvlamb, step=0,
        ))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        groups = [(g, [p for p in g["params"] if p.grad is not None])
                  for g in self.param_groups]
        all_grads = [p.grad for _, params in groups for p in params]
        clip = _clip_divisor(all_grads, self.defaults["max_grad_norm"])
        for group, params in groups:
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p]["m"] = torch.zeros_like(
                        p, dtype=torch.float32)
                    self.state[p]["v"] = torch.zeros_like(
                        p, dtype=torch.float32)
            beta1, beta2 = group["betas"]
            updates = _lamb_step(
                params, [p.grad for p in params],
                [self.state[p]["m"] for p in params],
                [self.state[p]["v"] for p in params],
                count=group["step"] + 1, lr=_lr_at(group["lr"], group["step"]),
                beta1=beta1, beta2=beta2, eps=group["eps"],
                weight_decay=group["weight_decay"],
                bias_correction=group["bias_correction"],
                grad_averaging=group["grad_averaging"],
                adam_w_mode=group["adam_w_mode"],
                use_nvlamb=group["use_nvlamb"], clip=clip,
            )
            torch._foreach_add_(params, updates)
            group["step"] += 1
        return loss

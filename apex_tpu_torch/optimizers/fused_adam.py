"""Fused Adam / AdamW — counterpart of ``apex_tpu/optimizers/fused_adam.py``.

The arithmetic of the JAX ``fused_adam`` (≙ apex's ``AdamFunctor``),
written out in plain PyTorch with ``torch._foreach_*`` so that one call
updates every tensor of a step (the JAX version is plain jnp too):

- f32 moments ``m`` and ``v`` whatever the parameter dtype (the
  functional form stores them in ``state_dtype``), and one step count;
- ``adam_w_mode=False`` (``ADAM_MODE_0``): L2, ``g += wd * p`` before
  the moments; ``adam_w_mode=True`` (``ADAM_MODE_1``): decoupled decay,
  ``u += wd * p`` after them;
- bias correction ``1 - beta**count`` with the 1-based count;
- ``lr`` a constant or a callable of the 0-based step (the optax
  convention: the first update sees ``lr(0)``).

:func:`fused_adam` is the functional form (``init``/``update`` over
dicts of tensors, as the optax transformation works over pytrees);
:class:`FusedAdam` is the stateful ``torch.optim.Optimizer``
(``step()`` reads each parameter's ``.grad`` and updates the parameters
and moments in place).  Both run :func:`_adam_step`.  AMSGrad raises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Union

import torch

__all__ = ["FusedAdam", "FusedAdamState", "fused_adam"]

ScalarOrSchedule = Union[float, Callable[[int], float]]


def _lr_at(lr: ScalarOrSchedule, prev_count) -> float:
    """A schedule at the 0-based step, or the constant.  A count held on
    the device (the amp update's, which a skipped step leaves alone)
    takes a constant rate only: a schedule would read it on the host."""
    if not callable(lr):
        return float(lr)
    if isinstance(prev_count, torch.Tensor):
        raise ValueError("a learning-rate schedule needs the step count on "
                         "the host; the amp update keeps it on the device")
    return float(lr(prev_count))


@torch.no_grad()
def _adam_step(params: List[torch.Tensor], grads: List[torch.Tensor],
               ms: List[torch.Tensor], vs: List[torch.Tensor], *,
               count: int, lr: float, beta1: float, beta2: float, eps: float,
               weight_decay: float, adam_w_mode: bool,
               bias_correction: bool) -> List[torch.Tensor]:
    """One update at the 1-based ``count`` (an int, or a 0-d tensor on
    the device, whose bias corrections are then f32 tensors as the
    reference's are): updates ``ms`` and ``vs`` in place and returns the parameter updates ``-lr * u`` in each
    parameter's dtype (the caller adds them)."""
    if bias_correction:
        if isinstance(count, torch.Tensor):  # a count on the device
            count = count.float()
        bc1 = 1.0 - beta1 ** count
        bc2 = 1.0 - beta2 ** count
    else:
        bc1 = bc2 = 1.0
    gf = [g.float() for g in grads]
    pf = [p.float() for p in params]
    if not adam_w_mode and weight_decay != 0.0:
        gf = torch._foreach_add(gf, pf, alpha=weight_decay)  # ADAM_MODE_0
    # m = beta1*m + (1-beta1)*g ; v = beta2*v + (1-beta2)*g*g
    torch._foreach_mul_(ms, beta1)
    torch._foreach_add_(ms, torch._foreach_mul(gf, 1.0 - beta1))
    torch._foreach_mul_(vs, beta2)
    torch._foreach_add_(vs, torch._foreach_mul(
        torch._foreach_mul(gf, 1.0 - beta2), gf))
    # u = (m / bc1) / (sqrt(v / bc2) + eps)
    denom = torch._foreach_sqrt(torch._foreach_div(vs, bc2))
    torch._foreach_add_(denom, eps)
    u = torch._foreach_div(torch._foreach_div(ms, bc1), denom)
    if adam_w_mode and weight_decay != 0.0:
        torch._foreach_add_(u, pf, alpha=weight_decay)  # ADAM_MODE_1
    torch._foreach_mul_(u, -lr)
    return [t.to(p.dtype) for t, p in zip(u, params)]


def _stored(new: Dict[str, torch.Tensor],
            old: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The f32 moments ``new`` in the storage dtypes of ``old``."""
    return {k: t.to(old[k].dtype) for k, t in new.items()}


class FusedAdamState(NamedTuple):
    count: int  # 1-based after the first update (a 0-d tensor under amp)
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


class Transform(NamedTuple):
    """A functional optimizer: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)``."""

    init: Callable
    update: Callable


def fused_adam(
    learning_rate: ScalarOrSchedule = 1e-3,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    adam_w_mode: bool = True,
    bias_correction: bool = True,
    *,
    state_dtype: torch.dtype = torch.float32,
):
    """Functional Adam(W): ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)`` over dicts of
    tensors with the same keys; the caller adds the updates.  The
    moments are stored in ``state_dtype`` (e.g. ``torch.bfloat16`` to
    halve their memory) and updated in f32 arithmetic, rounded once on
    each store."""

    def init(params):
        return FusedAdamState(
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
        updates = _adam_step(
            [params[k] for k in keys], [grads[k] for k in keys],
            [m[k] for k in keys], [v[k] for k in keys],
            count=state.count + 1, lr=_lr_at(learning_rate, state.count),
            beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
            adam_w_mode=adam_w_mode, bias_correction=bias_correction,
        )
        return (dict(zip(keys, updates)),
                FusedAdamState(count=state.count + 1,
                               m=_stored(m, state.m), v=_stored(v, state.v)))

    return Transform(init, update)


class FusedAdam(torch.optim.Optimizer):
    """apex-shaped stateful Adam(W): ``FusedAdam(model.parameters(),
    lr=...)``, then ``loss.backward(); opt.step(); opt.zero_grad()``.
    Parameters without a gradient are left alone.  ``lr`` may be a
    callable of the 0-based step."""

    def __init__(self, params, lr: ScalarOrSchedule = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 bias_correction: bool = True, amsgrad: bool = False):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
        super().__init__(params, dict(
            lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
            adam_w_mode=adam_w_mode, bias_correction=bias_correction,
            step=0,
        ))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p]["m"] = torch.zeros_like(
                        p, dtype=torch.float32)
                    self.state[p]["v"] = torch.zeros_like(
                        p, dtype=torch.float32)
            beta1, beta2 = group["betas"]
            updates = _adam_step(
                params, [p.grad for p in params],
                [self.state[p]["m"] for p in params],
                [self.state[p]["v"] for p in params],
                count=group["step"] + 1, lr=_lr_at(group["lr"], group["step"]),
                beta1=beta1, beta2=beta2, eps=group["eps"],
                weight_decay=group["weight_decay"],
                adam_w_mode=group["adam_w_mode"],
                bias_correction=group["bias_correction"],
            )
            torch._foreach_add_(params, updates)
            group["step"] += 1
        return loss

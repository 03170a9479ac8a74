"""Fused SGD — counterpart of ``apex_tpu/optimizers/fused_sgd.py``.

The arithmetic of the JAX ``fused_sgd`` (≙ apex's ``FusedSGD`` over
``csrc/multi_tensor_sgd_kernel.cu`` :: ``SGDFunctor``), which is
``torch.optim.SGD``'s, written out with ``torch._foreach_*``:

    d = g + wd*p
    buf = momentum*buf + (1-dampening)*d         (first step: buf = d)
    update = d + momentum*buf   if nesterov else buf
    p -= lr * update

in f32, whatever the parameter dtype; the updates carry the parameter's
dtype (bf16 gradients must not truncate f32 master-weight updates).
``lr`` is a constant or a callable of the 0-based step.  The step count
may be a 0-d tensor on the device (the amp update's): the first-step
rule is then a select on the device, with no host sync.

:func:`fused_sgd` is the functional form (``init``/``update`` over dicts
of tensors); :class:`FusedSGD` the reference's stateful wrapper,
``step(grads, params) -> params``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Union

import torch

from apex_tpu_torch.optimizers.fused_adam import (
    ScalarOrSchedule,
    Transform,
    _lr_at,
)

__all__ = ["fused_sgd", "FusedSGD", "FusedSGDState"]


class FusedSGDState(NamedTuple):
    count: Union[int, torch.Tensor]  # 1-based after the first update
    momentum_buf: Optional[Dict[str, torch.Tensor]]


def first_step(count) -> Union[bool, torch.Tensor]:
    """``count == 1`` for a 1-based count on the host or the device."""
    return count == 1


def select(cond, a: List[torch.Tensor], b: List[torch.Tensor]
           ) -> List[torch.Tensor]:
    """``a`` where ``cond`` else ``b``, tensor by tensor (new tensors):
    a host bool picks a list, a device bool selects on the device."""
    if isinstance(cond, torch.Tensor):
        return [torch.where(cond, x, y) for x, y in zip(a, b)]
    return [t.clone() for t in (a if cond else b)]


def with_decay(grads: List[torch.Tensor], params, weight_decay: float
               ) -> List[torch.Tensor]:
    """The gradients in f32 plus ``weight_decay * p`` (new tensors)."""
    gf = [g.float() for g in grads]
    if weight_decay == 0.0:
        return [g.clone() if g is o else g for g, o in zip(gf, grads)]
    return torch._foreach_add(gf, [p.float() for p in params],
                              alpha=weight_decay)


def fused_sgd(
    learning_rate: ScalarOrSchedule = 1e-3,
    momentum: float = 0.0,
    dampening: float = 0.0,
    weight_decay: float = 0.0,
    nesterov: bool = False,
    *,
    state_dtype: torch.dtype = torch.float32,
) -> Transform:
    """Functional SGD over dicts of tensors with the same keys; the
    caller adds the updates.  The momentum buffers are stored in
    ``state_dtype`` (none without momentum)."""
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError(
            "Nesterov momentum requires momentum > 0 and zero dampening")

    def init(params):
        buf = None if momentum == 0.0 else {
            k: torch.zeros_like(p, dtype=state_dtype)
            for k, p in params.items()}
        return FusedSGDState(count=0, momentum_buf=buf)

    @torch.no_grad()
    def update(grads, state, params=None):
        keys = list(grads)
        if params is None and weight_decay != 0.0:
            raise ValueError("fused_sgd with weight_decay requires params")
        lr = _lr_at(learning_rate, state.count)
        count = state.count + 1
        d = with_decay([grads[k] for k in keys],
                       None if params is None else [params[k] for k in keys],
                       weight_decay)
        out = params if params is not None else grads
        if momentum == 0.0:
            upd, buf = d, None
        else:
            old = [state.momentum_buf[k].float() for k in keys]
            ema = torch._foreach_mul(old, momentum)
            torch._foreach_add_(ema, d, alpha=1.0 - dampening)
            new = select(first_step(count), d, ema)
            upd = torch._foreach_add(d, new, alpha=momentum) if nesterov \
                else new
            buf = {k: t.to(state.momentum_buf[k].dtype)
                   for k, t in zip(keys, new)}
        upd = torch._foreach_mul(upd, -lr)
        return ({k: u.to(out[k].dtype) for k, u in zip(keys, upd)},
                FusedSGDState(count=count, momentum_buf=buf))

    return Transform(init, update)


class Stateful:
    """The reference's apex-shaped wrapper of a functional optimizer:
    the state lives in the object, ``step(grads, params)`` returns the
    new parameters (dicts of tensors)."""

    def __init__(self, tx: Transform, params):
        self.tx = tx
        self.state = tx.init(params)

    @torch.no_grad()
    def step(self, grads, params):
        updates, self.state = self.tx.update(grads, self.state, params)
        return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


class FusedSGD(Stateful):
    """≙ ``FusedSGD(params, lr, momentum, dampening, weight_decay,
    nesterov)``."""

    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.0,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False):
        super().__init__(fused_sgd(lr, momentum, dampening, weight_decay,
                                   nesterov), params)

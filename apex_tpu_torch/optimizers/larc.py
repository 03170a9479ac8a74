"""LARC — layer-wise adaptive rate clipping; counterpart of
``apex_tpu/optimizers/larc.py`` (≙ ``apex/parallel/LARC.py`` :: ``LARC``).

The reference rescales ``p.grad`` in place before the wrapped
optimizer's ``step``; here :func:`larc` is a functional transform chained
in front of the inner optimizer (:func:`chain`, :class:`LARC`):

    local_lr = trust_coefficient · ‖p‖ / (‖g‖ + wd·‖p‖ + eps)
    clip:     g ← (g + wd·p) · min(local_lr / lr, 1)
    scale:    g ← (g + wd·p) · local_lr

A tensor with ‖p‖ == 0 or ‖g‖ == 0 passes through untouched (the
reference applies the decay and the scale only when both norms are
non-zero).  The reference folds the wrapped group's weight decay in
here and zeroes it for the inner step: pass the same ``weight_decay``
and give the inner optimizer none.  The norms are f32 device tensors;
nothing waits for the host.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from apex_tpu_torch.optimizers.fused_adam import (
    ScalarOrSchedule,
    Transform,
    _lr_at,
)

__all__ = ["larc", "LARC", "LARCState", "chain"]


class LARCState(NamedTuple):
    count: Union[int, torch.Tensor]


def larc(learning_rate: ScalarOrSchedule, trust_coefficient: float = 0.02,
         clip: bool = True, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Transform:
    def init(params):
        del params
        return LARCState(count=0)

    @torch.no_grad()
    def update(grads, state, params=None):
        if params is None:
            raise ValueError("larc requires params for the update")
        keys = list(grads)
        lr = _lr_at(learning_rate, state.count)
        g = [grads[k].float() for k in keys]
        p = [params[k].float() for k in keys]
        p_norm = torch.stack(torch._foreach_norm(p, 2))
        g_norm = torch.stack(torch._foreach_norm(g, 2))
        local_lr = trust_coefficient * p_norm / (
            g_norm + weight_decay * p_norm + eps)
        scale = torch.clamp(local_lr / lr, max=1.0) if clip else local_lr
        active = (p_norm > 0.0) & (g_norm > 0.0)
        out = {}
        for i, k in enumerate(keys):
            adapted = (g[i] + weight_decay * p[i]) * scale[i]
            out[k] = torch.where(active[i], adapted, g[i]).to(grads[k].dtype)
        return out, LARCState(count=state.count + 1)

    return Transform(init, update)


def chain(*txs: Transform) -> Transform:
    """The transforms applied in order (``optax.chain``): each one's
    updates are the next one's gradients; the state is the tuple of
    their states."""

    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(grads, state, params=None):
        new = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s, params)
            new.append(s)
        return grads, tuple(new)

    return Transform(init, update)


class LARC:
    """≙ ``LARC(optimizer, trust_coefficient, clip, eps)`` wrapping a
    functional optimizer: ``init``/``update`` of :func:`larc` chained
    in front of ``optimizer``."""

    def __init__(self, optimizer: Transform, learning_rate: float,
                 trust_coefficient: float = 0.02, clip: bool = True,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.tx = chain(larc(learning_rate, trust_coefficient, clip, eps,
                             weight_decay), optimizer)

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params=None):
        return self.tx.update(grads, state, params)

"""Gradient clipping by the global norm; counterpart of
``apex_tpu/optimizers/clip_grad.py`` (≙ ``apex/contrib/clip_grad`` ::
``clip_grad_norm_``, built on ``multi_tensor_l2norm`` and
``multi_tensor_scale``).

:func:`clip_grad_norm` is the reference's functional form: the clipped
gradients (a dict or list, each in its own dtype) and the total norm
before clipping.  :func:`clip_grad_norm_` is apex's in-place one: it
scales the ``.grad`` of the given parameters (or the tensors of a dict
of gradients) in place and returns the total norm.  Either way the scale is
``min(max_norm / (total + 1e-6), 1)``, applied in f32, and the norm
stays a device tensor.
"""

from __future__ import annotations

from typing import Iterable, List, Union

import torch

from apex_tpu_torch.optimizers.multi_tensor import _join, _split, global_norm

__all__ = ["clip_grad_norm", "clip_grad_norm_"]


def _total_norm(tensors: List[torch.Tensor], norm_type: float
                ) -> torch.Tensor:
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    if norm_type == 2.0:
        return global_norm(tensors)
    if norm_type == float("inf"):
        return torch.stack([t.float().abs().max() for t in tensors]).max()
    return sum(torch.sum(t.float().abs() ** norm_type)
               for t in tensors) ** (1.0 / norm_type)


def _scale(total: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (total + 1e-6), max=1.0)


def clip_grad_norm(grads, max_norm: float, norm_type: float = 2.0):
    """``(clipped, total)``: ``grads`` (a dict or list of tensors)
    scaled to at most ``max_norm`` in total ``norm_type`` norm (2, inf
    or any p), and that norm before clipping."""
    keys, tensors = _split(grads)
    total = _total_norm(tensors, norm_type)
    if not tensors:
        return _join(keys, []), total
    s = _scale(total, max_norm)
    return _join(keys, [(t.float() * s).to(t.dtype) for t in tensors]), total


@torch.no_grad()
def clip_grad_norm_(parameters: Union[torch.Tensor, Iterable[torch.Tensor],
                                      dict],
                    max_norm: float, norm_type: float = 2.0) -> torch.Tensor:
    """apex's ``clip_grad_norm_``: the ``.grad`` of each parameter that
    has one (or each tensor of a dict of gradients) scaled in place;
    returns the total norm before clipping."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    if isinstance(parameters, dict):
        grads = list(parameters.values())
    else:
        grads = [p.grad for p in parameters if p.grad is not None]
    total = _total_norm(grads, norm_type)
    if grads:
        s = _scale(total, max_norm)
        for g in grads:
            g.copy_(g.float() * s)
    return total

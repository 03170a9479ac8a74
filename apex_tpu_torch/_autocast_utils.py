"""Autocast helpers — counterpart of ``apex_tpu/_autocast_utils.py``
(≙ ``apex/_autocast_utils.py`` :: ``_cast_if_autocast_enabled``).

The reference checks ``torch.is_autocast_enabled()`` and casts an
extension's inputs to the autocast dtype, so hand kernels compose with
native amp.  Here the cast takes an explicit policy or dtype, as the
JAX package's does; with none given it follows PyTorch's autocast for
the inputs' device when that is on, and is the identity otherwise.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from apex_tpu_torch.amp.policy import cast_floats

__all__ = ["_cast_if_autocast_enabled", "cast_inputs"]


def cast_inputs(args: Sequence[Any], policy_or_dtype: Optional[Any]):
    """The floating leaves of ``args`` cast to the policy's compute
    dtype (``policy_or_dtype`` a :class:`~apex_tpu_torch.amp.Policy`, a
    dtype, or None for no cast)."""
    if policy_or_dtype is None:
        return tuple(args)
    dtype = getattr(policy_or_dtype, "compute_dtype", policy_or_dtype)
    return tuple(cast_floats(a, dtype) for a in args)


def _autocast_dtype(args) -> Optional[torch.dtype]:
    """PyTorch's autocast dtype for the first tensor's device type, when
    autocast is on there."""
    for a in args:
        if isinstance(a, torch.Tensor):
            kind = a.device.type
            if torch.is_autocast_enabled(kind):
                return torch.get_autocast_dtype(kind)
            return None
    return None


def _cast_if_autocast_enabled(*args, policy=None):
    """Varargs form with the reference's call shape
    (``_cast_if_autocast_enabled(x, y, ...)``): cast by ``policy`` (a
    Policy or a dtype), else by PyTorch's active autocast, else not at
    all."""
    if policy is None:
        policy = _autocast_dtype(args)
    return cast_inputs(args, policy)

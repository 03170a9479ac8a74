"""The op -> category registry and the cast hook.

Counterpart of ``apex_tpu/amp/lists/_registry.py``.  A category is
``"half"`` (cast to the active policy's half dtype), ``"fp32"`` or
``"promote"`` (the widest floating dtype among the inputs, by
``torch.promote_types``).  The active policy lives in a
``contextvars.ContextVar``: :func:`o1_patch` sets it for the block.

A context variable is per thread, and autograd runs a CUDA backward on
a thread of its own, where no policy is active.  So a checkpoint that
recomputes its forward in the backward captures the policy when its
forward runs and re-enters it in the recompute (:func:`carry_policy`),
as the reference's remat recomputes what it traced under the policy.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Any, Callable, Iterator, Optional

import torch

__all__ = [
    "CastPolicy",
    "register",
    "category",
    "o1_patch",
    "active_policy",
    "amp_cast",
    "carry_policy",
]

# op name -> "half" | "fp32" | "promote"
_CATEGORY: dict = {}

_VALID = ("half", "fp32", "promote")


def register(name: str, cat: str) -> None:
    """Add or override an op's cast category (≙ editing the override
    lists)."""
    if cat not in _VALID:
        raise ValueError(f"category must be one of {_VALID}, got {cat!r}")
    _CATEGORY[name] = cat


def category(name: str) -> Optional[str]:
    return _CATEGORY.get(name)


@dataclasses.dataclass(frozen=True)
class CastPolicy:
    """Active O1 policy: which dtype 'half' ops cast to."""

    half_dtype: Any = torch.bfloat16


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "apex_tpu_torch_amp_op_policy", default=None
)


def active_policy() -> Optional[CastPolicy]:
    return _ACTIVE.get()


@contextlib.contextmanager
def _using(policy: Optional[CastPolicy]) -> Iterator[None]:
    token = _ACTIVE.set(policy)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def o1_patch(half_dtype=torch.bfloat16):
    """Activate per-op casting for the block (≙
    ``patch_torch_functions=True``)."""
    return _using(CastPolicy(half_dtype))


def carry_policy(fn: Callable) -> Callable:
    """``fn`` run under the policy active now, wherever and whenever it
    is called: the checkpoint wrappers pass this to
    ``torch.utils.checkpoint`` so the recompute in the backward casts as
    the forward did."""
    policy = _ACTIVE.get()

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _using(policy):
            return fn(*args, **kwargs)

    return run


def _is_float_tensor(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def amp_cast(op_name: str, *tensors):
    """Cast ``tensors`` per the active policy and ``op_name``'s category.

    Identity when no policy is active or the op is unregistered.
    Non-tensor and non-float leaves (None, ints, bools) pass through
    untouched.  Returns a single value for a single input, else a tuple.
    The cast is ``Tensor.to``, whose backward returns the gradient in
    the caller's dtype."""
    pol = _ACTIVE.get()
    cat = _CATEGORY.get(op_name)
    if pol is None or cat is None:
        return tensors[0] if len(tensors) == 1 else tensors

    if cat == "half":
        target = pol.half_dtype
    elif cat == "fp32":
        target = torch.float32
    else:  # promote: the widest floating dtype among the inputs wins
        floats = [t.dtype for t in tensors if _is_float_tensor(t)]
        target = (functools.reduce(torch.promote_types, floats)
                  if floats else None)

    def cast(x):
        if target is not None and _is_float_tensor(x):
            return x.to(target)
        return x

    out = tuple(cast(t) for t in tensors)
    return out[0] if len(out) == 1 else out

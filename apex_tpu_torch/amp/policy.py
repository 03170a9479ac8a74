"""Precision policies — the O0–O3 opt-level table.

Counterpart of ``apex_tpu/amp/policy.py`` (≙ ``apex/amp/frontend.py`` ::
``opt_levels`` and ``Properties``).  A :class:`Policy` is a dtype triple
applied structurally: parameters live in ``param_dtype``, a model casts
its inputs and parameters to ``compute_dtype`` at entry
(:meth:`Policy.cast_to_compute`), outputs come back in ``output_dtype``.
The cast touches floating-point tensors only and leaves integer tensors
(token ids, masks) and non-tensors alone.

With bf16 (the default half dtype; its f32-range exponent makes loss
scaling unnecessary) O1/O2 take ``loss_scale=1.0``; with
``half_dtype=torch.float16`` they take the dynamic scaler, as the
reference's fp16 semantics do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

__all__ = ["Properties", "opt_levels", "Policy", "cast_floats", "to_f32",
           "cast_like"]


def _map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts, lists, tuples and
    NamedTuples (and the leaves at the same places of ``rest``)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, *vs) for vs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def cast_floats(tree, dtype):
    """Every floating-point tensor of a tree of dicts, lists and tuples
    cast to ``dtype``; other leaves unchanged (the port's copy of
    ``apex_tpu/_tree_util.py``'s)."""
    return _map(lambda x: x.to(dtype) if _is_float(x) else x, tree)


def to_f32(tree):
    """f32 copies of the floating leaves (master weights, master
    gradients); integer leaves pass through.  A leaf already in f32 is
    copied too, so a master never aliases the model's tensor."""
    return _map(lambda x: x.to(torch.float32, copy=True) if _is_float(x)
                else x, tree)


def cast_like(ref_tree, tree):
    """Each floating leaf of ``tree`` cast to the dtype of the matching
    ``ref_tree`` leaf (the master -> model copy); other leaves
    untouched."""
    return _map(lambda x, r: x.to(r.dtype) if _is_float(x) else x, tree,
                ref_tree)


@dataclasses.dataclass(frozen=True)
class Policy:
    """jmp-style dtype triple; the mechanical core of an opt level."""

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    output_dtype: Any = torch.float32

    def cast_to_param(self, tree):
        return cast_floats(tree, self.param_dtype)

    def cast_to_compute(self, tree):
        return cast_floats(tree, self.compute_dtype)

    def cast_to_output(self, tree):
        return cast_floats(tree, self.output_dtype)


@dataclasses.dataclass(frozen=True)
class Properties:
    """≙ apex/amp/frontend.py :: Properties (resolved opt-level config)."""

    opt_level: str
    cast_model_type: Optional[Any]  # O2/O3: params stored in half
    compute_dtype: Any  # O1+: math in half
    keep_batchnorm_fp32: bool
    master_weights: bool
    loss_scale: Union[float, str]  # number or "dynamic"

    def policy(self) -> Policy:
        return Policy(
            param_dtype=self.cast_model_type or torch.float32,
            compute_dtype=self.compute_dtype,
            output_dtype=torch.float32,
        )


def opt_levels(half_dtype=torch.bfloat16) -> dict:
    """The O0–O3 table, parameterized by the half dtype: with bf16 the
    dynamic-loss-scale defaults collapse to 1.0; with fp16 they are the
    reference's ("dynamic" for O1/O2, 1.0 for O3)."""
    dyn = "dynamic" if half_dtype == torch.float16 else 1.0
    return {
        "O0": Properties("O0", None, torch.float32, False, False, 1.0),
        "O1": Properties("O1", None, half_dtype, True, False, dyn),
        "O2": Properties("O2", half_dtype, half_dtype, True, True, dyn),
        "O3": Properties("O3", half_dtype, half_dtype, False, False, 1.0),
    }

"""Manual half-precision helpers — counterpart of
:mod:`apex_tpu.fp16_utils` (≙ ``apex/fp16_utils/fp16util.py`` ::
``network_to_half``, ``BN_convert_float``, ``prep_param_lists``,
``master_params_to_model_params``, ``model_grads_to_master_grads``,
``tofp16`` and ``apex/fp16_utils/fp16_optimizer.py`` ::
``FP16_Optimizer``, the pre-amp manual API).

They work over dicts of named tensors, as ``named_parameters()`` or
:func:`apex_tpu_torch.train.module_params` gives them (nested dicts
too); :class:`FP16_Optimizer` wraps a functional optimizer
(``init``/``update`` over such dicts) with f32 master weights and a
loss scaler.
"""

from __future__ import annotations

import re
from typing import Any, Optional, Tuple

import torch

from apex_tpu_torch.amp.frontend import _device_of
from apex_tpu_torch.amp.policy import cast_floats, cast_like, to_f32
from apex_tpu_torch.amp.scaler import (
    DynamicLossScaler,
    StaticLossScaler,
    amp_update,
)

__all__ = [
    "tofp16",
    "network_to_half",
    "BN_convert_float",
    "prep_param_lists",
    "master_params_to_model_params",
    "model_grads_to_master_grads",
    "FP16_Optimizer",
]

_HALF = (torch.float16, torch.bfloat16)


def tofp16(tree, half_dtype=torch.bfloat16):
    """The floating leaves cast to the half dtype (≙ the tofp16 module
    cast)."""
    return cast_floats(tree, half_dtype)


def network_to_half(tree, half_dtype=torch.bfloat16):
    """≙ network_to_half (BatchNorm parameters staying f32 is
    :func:`BN_convert_float`'s job; the normalization ops compute their
    statistics in f32 whatever the parameters' dtype)."""
    return tofp16(tree, half_dtype)


_BN_SCOPE_PREFIXES = ("batchnorm", "batch_norm", "syncbatchnorm", "bn")


def _is_bn_segment(seg: str, prefixes) -> bool:
    # anchored: the segment IS a BatchNorm scope name (optionally
    # numbered, "BatchNorm_0" / "bn_1", or torch-style "bn1"), never a
    # substring hit like "subnet" containing "bn"
    seg = seg.lower()
    return any(
        seg == p or seg.startswith(p + "_")
        or (seg.startswith(p) and seg[len(p):].isdigit())
        for p in (q.lower() for q in prefixes)
    )


def _segments(key) -> list:
    """A dotted or ``/``-joined name's segments."""
    return [s for s in re.split(r"[./]", str(key)) if s]


def BN_convert_float(tree, prefixes=_BN_SCOPE_PREFIXES):
    """≙ BN_convert_float: after a half cast, return the BatchNorm
    parameters to f32 for stable statistics.  A half-precision leaf
    whose name (the dict keys above it, each split at ``.`` and ``/``)
    has a segment equal to one of ``prefixes`` or a numbered instance of
    one (``bn1``, ``bn_1``, ``BatchNorm_0``, ``SyncBatchNorm_2``) goes
    back to f32; other leaves are untouched."""

    def walk(node, segs):
        if isinstance(node, dict):
            return {k: walk(v, segs + _segments(k)) for k, v in node.items()}
        if (isinstance(node, torch.Tensor) and node.dtype in _HALF
                and any(_is_bn_segment(s, prefixes) for s in segs)):
            return node.to(torch.float32)
        return node

    return walk(tree, [])


def prep_param_lists(params) -> Tuple[Any, Any]:
    """≙ prep_param_lists: ``(model params, f32 master copies)``."""
    return params, to_f32(params)


def master_params_to_model_params(model_params, master_params):
    """≙ master_params_to_model_params: the masters cast into the
    model's dtypes."""
    return cast_like(model_params, master_params)


def model_grads_to_master_grads(model_grads):
    """≙ model_grads_to_master_grads: the gradients in f32 for the
    master update."""
    return to_f32(model_grads)


class FP16_Optimizer:
    """≙ apex/fp16_utils/fp16_optimizer.py :: FP16_Optimizer.

    Wraps a functional optimizer: holds f32 masters and the scaler
    state, and ``step`` runs unscale -> overflow skip -> master update
    -> model re-cast, with every decision on the device.

    >>> opt = FP16_Optimizer(fused_adam(1e-3), static_loss_scale=128.0)
    >>> state = opt.init(bf16_params)
    >>> params, state, overflow = opt.step(bf16_params, scaled_grads, state)
    """

    def __init__(
        self,
        tx,
        static_loss_scale: float = 1.0,
        dynamic_loss_scale: bool = False,
        dynamic_loss_args: Optional[dict] = None,
    ):
        self.tx = tx
        if dynamic_loss_scale:
            self.loss_scaler = DynamicLossScaler(**(dynamic_loss_args or {}))
        else:
            if static_loss_scale is None:
                raise ValueError(
                    "static_loss_scale must be a number; pass "
                    "dynamic_loss_scale=True for dynamic scaling"
                )
            self.loss_scaler = StaticLossScaler(float(static_loss_scale))

    def init(self, model_params):
        _, master = prep_param_lists(model_params)
        return {
            "master": master,
            "opt": self.tx.init(master),
            "scaler": self.loss_scaler.init(_device_of(model_params)),
        }

    def scale_loss(self, loss, state):
        return self.loss_scaler.scale(loss, state["scaler"])

    def loss_scale(self, state):
        """The current loss scale (≙ the reference's ``loss_scale``
        property; functional, so it reads the threaded state)."""
        return state["scaler"].loss_scale

    def step(self, model_params, scaled_grads, state):
        master, new_opt, new_scaler, found_inf = amp_update(
            self.tx, self.loss_scaler, scaled_grads, state["opt"],
            state["master"], state["scaler"],
        )
        new_model = master_params_to_model_params(model_params, master)
        return (new_model,
                {"master": master, "opt": new_opt, "scaler": new_scaler},
                found_inf)

    # ≙ FP16_Optimizer.state_dict / load_state_dict
    def state_dict(self, state):
        return state

    def load_state_dict(self, _state, sd):
        return sd

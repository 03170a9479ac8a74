"""amp.initialize-shaped frontend.

Counterpart of ``apex_tpu/amp/frontend.py`` (≙ ``apex/amp/frontend.py``
:: ``initialize``, ``apex/amp/handle.py`` :: ``scale_loss`` /
``AmpHandle`` and the ``state_dict`` plumbing of
``apex/amp/_amp_state.py``).

The reference mutates a torch model and optimizer in place; this
frontend is functional, as the JAX one is.  :func:`initialize` resolves
an opt level to a :class:`~apex_tpu_torch.amp.policy.Properties`, casts
the parameters per ``cast_model_type`` and returns an
:class:`AmpHandle`: the policy, the loss scaler, optionally f32 master
copies, and :meth:`AmpHandle.step`, the patched ``optimizer.step``
(unscale, overflow check, apply or skip, scale update; every decision
on the device, no host synchronization).

Parameters are a flat dict of named tensors, as
:func:`apex_tpu_torch.train.module_params` gives them, and ``tx`` a
functional optimizer over such dicts (``optimizers.fused_adam(...)``,
``optimizers.FACTORIES[name](...)``).  :meth:`AmpHandle.step` returns
new parameter tensors; bind them into a module for the next forward with
:func:`apex_tpu_torch.train.module_loss`, the trainer's update, which
also holds under a remat recompute.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Union

import torch

from apex_tpu_torch.amp.policy import (
    Policy,
    Properties,
    cast_like,
    opt_levels,
    to_f32,
)
from apex_tpu_torch.amp.scaler import (
    DynamicLossScaler,
    LossScaleState,
    StaticLossScaler,
    _as_device_count,
    amp_update,
)

__all__ = ["initialize", "AmpHandle", "AmpState", "scale_loss",
           "master_params", "state_dict", "load_state_dict"]


class AmpState(NamedTuple):
    """Threaded training state: opt state + scaler state (+ f32
    masters)."""

    opt_state: Any
    scaler_state: LossScaleState
    master_params: Optional[Any]  # f32 copies when properties.master_weights


def _device_of(params) -> torch.device:
    for t in params.values():
        if isinstance(t, torch.Tensor):
            return t.device
    raise ValueError("params hold no tensor to place the scaler state by")


class AmpHandle:
    def __init__(self, properties: Properties, tx):
        self.properties = properties
        self.policy: Policy = properties.policy()
        ls = properties.loss_scale
        if ls == "dynamic":
            self.scaler = DynamicLossScaler()
        else:
            self.scaler = StaticLossScaler(float(ls))
        self.tx = tx

    # -- state -----------------------------------------------------------
    def init(self, params) -> AmpState:
        """The optimizer state (over the masters when kept; its step
        count a 0-d tensor on the device, as every step leaves it, so a
        fresh state is a template a checkpoint restores into in place),
        the scaler state on the parameters' device and the masters."""
        master = to_f32(params) if self.properties.master_weights else None
        opt_params = master if master is not None else params
        device = _device_of(params)
        return AmpState(
            opt_state=_as_device_count(self.tx.init(opt_params), device),
            scaler_state=self.scaler.init(device),
            master_params=master,
        )

    # -- loss scaling ----------------------------------------------------
    def scale_loss(self, loss, state: AmpState):
        """≙ the ``with amp.scale_loss(loss, opt) as scaled:`` entry:
        the loss times the scale, in f32."""
        return self.scaler.scale(loss, state.scaler_state)

    # -- O1 per-op casting (≙ patch_torch_functions) ---------------------
    def patch_functions(self):
        """Context manager activating the per-op cast registry
        (:mod:`apex_tpu_torch.amp.lists`) with this handle's half dtype,
        the O1 patch-table semantics.  Wrap the forward:

            with handle.patch_functions():
                loss = loss_fn(params, batch)

        A checkpointed block recomputes under the same policy in the
        backward, inside the block or not.  Only O1 patches functions
        (the reference's table), so this raises on the other levels."""
        if self.properties.opt_level != "O1":
            raise RuntimeError(
                "patch_functions() is the O1 mechanism (reference: "
                "patch_torch_functions=True only at O1); current level is "
                f"{self.properties.opt_level}"
            )
        from apex_tpu_torch.amp import lists

        return lists.o1_patch(self.properties.compute_dtype)

    # -- the patched optimizer.step --------------------------------------
    def step(self, params, scaled_grads, state: AmpState):
        """Returns ``(new_params, new_state, found_inf)``.

        With master weights (O2) the f32 masters take the update and
        the model parameters are re-cast from them (≙ the master ->
        model copy of ``_process_optimizer``); without, the parameters
        update in their own dtype.  On overflow nothing but the scaler
        state moves."""
        if state.master_params is not None:
            new_master, new_opt, new_scaler, found_inf = amp_update(
                self.tx, self.scaler, scaled_grads, state.opt_state,
                state.master_params, state.scaler_state,
            )
            new_params = cast_like(params, new_master)
            return (new_params, AmpState(new_opt, new_scaler, new_master),
                    found_inf)
        new_params, new_opt, new_scaler, found_inf = amp_update(
            self.tx, self.scaler, scaled_grads, state.opt_state, params,
            state.scaler_state,
        )
        return new_params, AmpState(new_opt, new_scaler, None), found_inf

    # -- persistence (≙ amp.state_dict / load_state_dict) ----------------
    def state_dict(self, state: AmpState) -> dict:
        return {
            "loss_scale": state.scaler_state.loss_scale,
            "growth_tracker": state.scaler_state.growth_tracker,
            "hysteresis": state.scaler_state.hysteresis,
        }

    def load_state_dict(self, state: AmpState, sd: dict) -> AmpState:
        dev = state.scaler_state.loss_scale.device
        return state._replace(scaler_state=LossScaleState(
            loss_scale=torch.as_tensor(sd["loss_scale"], dtype=torch.float32,
                                       device=dev),
            growth_tracker=torch.as_tensor(sd["growth_tracker"],
                                           dtype=torch.int32, device=dev),
            hysteresis=torch.as_tensor(sd["hysteresis"], dtype=torch.int32,
                                       device=dev),
        ))


def initialize(
    params,
    tx,
    opt_level: str = "O1",
    half_dtype=torch.bfloat16,
    cast_model_type=None,
    keep_batchnorm_fp32: Optional[bool] = None,
    master_weights: Optional[bool] = None,
    loss_scale: Union[float, str, None] = None,
):
    """≙ ``amp.initialize(model, optimizer, opt_level=..., **overrides)``.

    Returns ``(cast_params, handle)``; each keyword refines the opt
    level as the reference's ``initialize`` keywords override its
    ``opt_levels`` table."""
    levels = opt_levels(half_dtype)
    if opt_level not in levels:
        raise ValueError(
            f"Unexpected optimization level {opt_level!r} "
            "(options are 'O0', 'O1', 'O2', 'O3')"
        )
    props = levels[opt_level]
    overrides = {}
    if cast_model_type is not None:
        overrides["cast_model_type"] = cast_model_type
    if keep_batchnorm_fp32 is not None:
        overrides["keep_batchnorm_fp32"] = keep_batchnorm_fp32
    if master_weights is not None:
        overrides["master_weights"] = master_weights
    if loss_scale is not None:
        overrides["loss_scale"] = loss_scale
    if overrides:
        props = dataclasses.replace(props, **overrides)
    handle = AmpHandle(props, tx)
    return handle.policy.cast_to_param(params), handle


def scale_loss(loss, handle: AmpHandle, state: AmpState):
    """Free-function form of ``amp.scale_loss``."""
    return handle.scale_loss(loss, state)


def master_params(params, state: AmpState):
    """≙ ``apex.amp.master_params(optimizer)``: what the optimizer
    steps, the f32 masters when the opt level keeps them (O2), else the
    model parameters themselves."""
    return state.master_params if state.master_params is not None else params


def state_dict(handle: AmpHandle, state: AmpState) -> dict:
    """≙ module-level ``apex.amp.state_dict()`` (the scaler's state)."""
    return handle.state_dict(state)


def load_state_dict(handle: AmpHandle, state: AmpState, sd: dict) -> AmpState:
    """≙ module-level ``apex.amp.load_state_dict(sd)``."""
    return handle.load_state_dict(state, sd)

"""Loss scalers — static and dynamic with hysteresis.

Counterpart of ``apex_tpu/amp/scaler.py`` (≙ ``apex/amp/scaler.py`` ::
``LossScaler``, ``apex/fp16_utils/loss_scaler.py`` ::
``DynamicLossScaler`` and ``csrc/update_scale_hysteresis.cu``).

The scaler owns no Python state: its state is a :class:`LossScaleState`
of 0-d tensors on the step's device, threaded through the step.
Overflow detection rides the fused scale pass
(:func:`apex_tpu_torch.optimizers.scale_with_overflow_check`), and
every decision — grow, back off, skip the step — is a ``torch.where``
on the device: nothing reads a flag on the host, so a step that skips
costs no synchronization.

Update rule (the hysteresis of ``update_scale_hysteresis.cu``):

- overflow: ``hysteresis -= 1``; once exhausted, ``scale *=
  backoff_factor`` and the growth counter resets;
- clean step: ``growth_tracker += 1``; at ``growth_interval``
  consecutive clean steps ``scale *= growth_factor``, the trackers
  reset and the hysteresis is restored.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers.multi_tensor import scale_with_overflow_check

__all__ = ["LossScaleState", "DynamicLossScaler", "StaticLossScaler",
           "amp_update", "tree_select"]


class LossScaleState(NamedTuple):
    loss_scale: torch.Tensor  # f32 0-d
    growth_tracker: torch.Tensor  # i32: consecutive clean steps
    hysteresis: torch.Tensor  # i32: tolerated overflows before backoff


class DynamicLossScaler:
    """≙ LossScaler(loss_scale="dynamic") — 2**16 start, x2/2000, /2."""

    def __init__(
        self,
        init_scale: float = 2.0**16,
        growth_factor: float = 2.0,
        backoff_factor: float = 0.5,
        growth_interval: int = 2000,
        hysteresis: int = 1,
        min_loss_scale: float = 1.0,
        max_loss_scale: float = 2.0**24,
    ):
        self.init_scale = init_scale
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval
        self.hysteresis = hysteresis
        self.min_loss_scale = min_loss_scale
        self.max_loss_scale = max_loss_scale

    def init(self, device="cuda") -> LossScaleState:
        """A fresh state on ``device`` (the card unless asked)."""
        dev = resolve_device(device)
        return LossScaleState(
            loss_scale=torch.tensor(self.init_scale, dtype=torch.float32,
                                    device=dev),
            growth_tracker=torch.zeros((), dtype=torch.int32, device=dev),
            hysteresis=torch.tensor(self.hysteresis, dtype=torch.int32,
                                    device=dev),
        )

    @staticmethod
    def metrics(state: LossScaleState) -> dict:
        """The scaler's device scalars, keyed for a
        :class:`apex_tpu_torch.observability.MetricRegistry` (gauges)."""
        return {
            "amp/loss_scale": state.loss_scale,
            "amp/growth_tracker": state.growth_tracker,
            "amp/hysteresis": state.hysteresis,
        }

    def scale(self, loss, state: LossScaleState):
        """The loss times the scale, in f32 (a 2**16 scale in fp16 would
        be inf)."""
        return loss.float() * state.loss_scale

    def unscale(self, grads, state: LossScaleState) -> Tuple[Any, Any]:
        """``(grads / scale in f32, found_inf)``: the fused scale pass
        with its inf/nan flag (f32 0-d, 1.0 on overflow)."""
        return scale_with_overflow_check(grads, 1.0 / state.loss_scale,
                                         out_dtype=torch.float32)

    def update(self, state: LossScaleState, found_inf) -> LossScaleState:
        """≙ update_scale_hysteresis_cuda, on the device."""
        overflow = found_inf > 0.0
        new_hyst = torch.where(overflow, (state.hysteresis - 1).clamp_min(0),
                               state.hysteresis)
        do_backoff = overflow & (new_hyst <= 0)
        backed_off = (state.loss_scale * self.backoff_factor).clamp(
            self.min_loss_scale, self.max_loss_scale)
        tracker = torch.where(overflow, torch.zeros_like(
            state.growth_tracker), state.growth_tracker + 1)
        do_growth = ~overflow & (tracker >= self.growth_interval)
        grown = (state.loss_scale * self.growth_factor).clamp(
            self.min_loss_scale, self.max_loss_scale)
        new_scale = torch.where(do_backoff, backed_off, torch.where(
            do_growth, grown, state.loss_scale))
        tracker = torch.where(do_growth, torch.zeros_like(tracker), tracker)
        # a clean step or a completed backoff restores the hysteresis
        new_hyst = torch.where(do_backoff | ~overflow,
                               torch.full_like(new_hyst, self.hysteresis),
                               new_hyst)
        return LossScaleState(new_scale, tracker.to(torch.int32),
                              new_hyst.to(torch.int32))


class StaticLossScaler(DynamicLossScaler):
    """≙ LossScaler(loss_scale=<const>) — fixed scale, still flags
    overflow."""

    def __init__(self, loss_scale: float = 1.0):
        super().__init__(init_scale=loss_scale)

    def update(self, state: LossScaleState, found_inf) -> LossScaleState:
        return state


def _as_device_count(opt_state, device):
    """A functional optimizer state with its step count as a 0-d int32
    tensor on ``device`` (so a skipped step can keep the old count with
    a select, as the reference's device counter does).  A count restored
    elsewhere (a checkpoint read without a template tensor for it comes
    back on the host) moves to ``device`` too, so the update's
    arithmetic is the same after a resume as before it."""
    count = getattr(opt_state, "count", None)
    if isinstance(count, int) and not isinstance(count, bool):
        return opt_state._replace(count=torch.tensor(
            count, dtype=torch.int32, device=device))
    if isinstance(count, torch.Tensor) and count.device != device:
        return opt_state._replace(count=count.to(device=device,
                                                 dtype=torch.int32))
    return opt_state


def tree_select(keep_old, new, old):
    """``torch.where(keep_old, old, new)`` over two trees of the same
    structure (dicts, lists, tuples, NamedTuples of tensors)."""
    if isinstance(new, torch.Tensor):
        return torch.where(keep_old, old, new)
    if isinstance(new, dict):
        return {k: tree_select(keep_old, new[k], old[k]) for k in new}
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(tree_select(keep_old, a, b)
                           for a, b in zip(new, old)))
    if isinstance(new, (list, tuple)):
        return type(new)(tree_select(keep_old, a, b)
                         for a, b in zip(new, old))
    if new != old:
        raise ValueError(f"cannot select between host values {new!r} and "
                         f"{old!r} on the device")
    return new


def _flat(tree):
    """(keys, tensors) of a dict of tensors."""
    return list(tree), list(tree.values())


def amp_update(tx, scaler, scaled_grads, opt_state, params, scaler_state):
    """One mixed-precision optimizer step with overflow skip.

    ≙ the patched ``optimizer.step`` of ``apex/amp/_process_optimizer.py``:
    unscale, check overflow, apply or skip, adjust the scale.  ``tx`` is
    a functional optimizer (``init``/``update`` over dicts of tensors,
    e.g. :func:`apex_tpu_torch.optimizers.fused_adam`), ``params`` and
    ``scaled_grads`` dicts of tensors with the same keys.  Returns
    ``(new_params, new_opt_state, new_scaler_state, found_inf)``; on
    overflow the params and the optimizer state (its count included)
    come back as they were and only the scaler state moves — selected on
    the device, no host branch."""
    grads, found_inf = scaler.unscale(scaled_grads, scaler_state)
    grads = {k: grads[k].to(params[k].dtype) for k in params}
    device = found_inf.device
    opt_state = _as_device_count(opt_state, device)
    updates, new_opt_state = tx.update(grads, opt_state, params)
    skip = found_inf > 0.0
    new_params = {k: torch.where(skip, p, p + updates[k].to(p.dtype))
                  for k, p in params.items()}
    new_opt_state = tree_select(skip, new_opt_state, opt_state)
    return (new_params, new_opt_state, scaler.update(scaler_state, found_inf),
            found_inf)

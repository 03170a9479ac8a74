"""Guarded optimizer step — skip, don't poison, on bad batches.

Counterpart of ``apex_tpu/resilience/guards.py``.  Two detectors over
:func:`apex_tpu_torch.amp.scaler.amp_update`:

- **non-finite grads** — the scaler's fused ``found_inf`` flag;
- **grad-norm spikes** — an EMA of the global gradient norm; a finite
  gradient whose norm exceeds ``spike_factor`` × EMA (after
  ``warmup_steps``) marks a poisoned batch.

Either skips the step the way the scaler does: a ``torch.where`` over
the params and the optimizer state, on the device, with no host read —
and no divergence between data-parallel replicas, whose flags come from
the same all-reduced gradients.  Only a true overflow feeds the loss
scale's hysteresis; a spike skip freezes the scaler state.

The guard keeps a consecutive-skip budget: :meth:`GradGuard.
budget_exhausted` turns true once ``max_consecutive_skips`` steps in a
row were skipped — the cue for :func:`apex_tpu_torch.resilience.
run_resilient`'s rollback.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch.amp.scaler import _as_device_count, tree_select
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers.multi_tensor import global_norm

__all__ = [
    "GradGuard",
    "GuardState",
    "GuardVerdict",
    "guarded_amp_update",
    "guard_metrics",
]


class GuardState(NamedTuple):
    norm_ema: torch.Tensor  # f32: EMA of accepted global grad norms
    step: torch.Tensor  # i32: guarded steps seen (accepted or skipped)
    consecutive_skips: torch.Tensor  # i32
    total_skips: torch.Tensor  # i32


class GuardVerdict(NamedTuple):
    """Per-step diagnostics (0-d tensors on the device)."""

    skipped: torch.Tensor  # f32 {0,1}: this step was dropped
    found_inf: torch.Tensor  # f32 {0,1}: non-finite grads
    spike: torch.Tensor  # bool: finite but > spike_factor x EMA
    grad_norm: torch.Tensor  # f32: unscaled global grad norm


class GradGuard:
    """Config and state factory for :func:`guarded_amp_update`."""

    def __init__(
        self,
        spike_factor: float = 20.0,
        ema_beta: float = 0.99,
        warmup_steps: int = 10,
        max_consecutive_skips: int = 10,
    ):
        if spike_factor <= 1.0:
            raise ValueError("spike_factor must be > 1")
        if not 0.0 < ema_beta < 1.0:
            raise ValueError("ema_beta must be in (0, 1)")
        self.spike_factor = spike_factor
        self.ema_beta = ema_beta
        self.warmup_steps = warmup_steps
        self.max_consecutive_skips = max_consecutive_skips

    def init(self, device="cuda") -> GuardState:
        """A fresh state on ``device`` (the card unless asked)."""
        dev = resolve_device(device)
        return GuardState(
            norm_ema=torch.zeros((), dtype=torch.float32, device=dev),
            step=torch.zeros((), dtype=torch.int32, device=dev),
            consecutive_skips=torch.zeros((), dtype=torch.int32, device=dev),
            total_skips=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def budget_exhausted(self, state: GuardState) -> torch.Tensor:
        """True once the consecutive-skip budget is spent (0-d bool)."""
        return state.consecutive_skips >= self.max_consecutive_skips


def guard_metrics(verdict: GuardVerdict, state: GuardState,
                  guard: "GradGuard" = None) -> dict:
    """The guard's device scalars, keyed for a
    :class:`apex_tpu_torch.observability.MetricRegistry` (declare
    ``guard/skipped`` as a counter and the rest as gauges).  With the
    :class:`GradGuard`, also ``guard/budget_left``: consecutive skips
    left before the rollback budget trips."""
    out = {
        "guard/skipped": verdict.skipped,
        "guard/found_inf": verdict.found_inf,
        "guard/spike": verdict.spike,
        "guard/grad_norm": verdict.grad_norm,
        "guard/norm_ema": state.norm_ema,
        "guard/consecutive_skips": state.consecutive_skips,
        "guard/total_skips": state.total_skips,
    }
    if guard is not None:
        out["guard/budget_left"] = (
            guard.max_consecutive_skips - state.consecutive_skips
        ).clamp_min(0)
    return out


def guarded_amp_update(
    tx,
    scaler,
    guard: GradGuard,
    scaled_grads,
    opt_state,
    params,
    scaler_state,
    guard_state: GuardState,
) -> Tuple[Any, Any, Any, GuardState, GuardVerdict]:
    """``amp_update`` with spike detection and a consecutive-skip budget.

    Returns ``(params, opt_state, scaler_state, guard_state, verdict)``;
    ``params``/``scaled_grads`` are dicts of tensors with the same keys.
    On a skipped step the params and the optimizer state come back as
    they were; the loss scale reacts only to a real overflow, and the
    guard's EMA only to accepted steps."""
    grads, found_inf = scaler.unscale(scaled_grads, scaler_state)
    norm = global_norm(grads)

    warm = guard_state.step >= guard.warmup_steps
    have_ema = guard_state.norm_ema > 0.0
    spike = (warm & have_ema & torch.isfinite(norm)
             & (norm > guard.spike_factor * guard_state.norm_ema))
    skip = (found_inf > 0.0) | spike
    accept = ~skip

    grads = {k: grads[k].to(params[k].dtype) for k in params}
    opt_state = _as_device_count(opt_state, found_inf.device)
    updates, new_opt_state = tx.update(grads, opt_state, params)
    new_params = {k: torch.where(skip, p, p + updates[k].to(p.dtype))
                  for k, p in params.items()}
    new_opt_state = tree_select(skip, new_opt_state, opt_state)
    # only a real overflow feeds the scaler: a spike skip freezes its
    # whole state (else the skipped step would count as clean)
    new_scaler_state = tree_select(
        spike, scaler.update(scaler_state, found_inf), scaler_state)

    # the EMA over accepted norms only; the first accepted norm seeds it
    seeded = torch.where(have_ema, guard_state.norm_ema, norm)
    new_ema = torch.where(
        accept,
        torch.where(have_ema,
                    guard.ema_beta * guard_state.norm_ema
                    + (1.0 - guard.ema_beta) * norm,
                    seeded),
        guard_state.norm_ema)
    new_guard_state = GuardState(
        norm_ema=new_ema,
        step=guard_state.step + 1,
        consecutive_skips=torch.where(
            skip, guard_state.consecutive_skips + 1,
            torch.zeros_like(guard_state.consecutive_skips)),
        total_skips=guard_state.total_skips + skip.to(torch.int32),
    )
    verdict = GuardVerdict(skipped=skip.float(), found_inf=found_inf,
                           spike=spike, grad_norm=norm)
    return (new_params, new_opt_state, new_scaler_state, new_guard_state,
            verdict)

"""Grad scaler that agrees across the model-parallel group.

Counterpart of ``apex_tpu/transformer/amp/grad_scaler.py`` (≙
``apex/transformer/amp/grad_scaler.py`` :: ``GradScaler``): the dynamic
loss scaler with ``found_inf`` all-reduced (max) over the tensor- and
pipeline-parallel groups, so every model-parallel rank skips (or keeps)
the same step even when only one shard overflowed.  The all-reduce goes
through :func:`apex_tpu_torch.parallel.comm.all_reduce` (on the device,
no host read); an axis of size 1 has no group and issues nothing.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.amp.scaler import DynamicLossScaler, LossScaleState
from apex_tpu_torch.parallel import comm

__all__ = ["GradScaler"]


class GradScaler(DynamicLossScaler):
    """DynamicLossScaler whose overflow flag is synchronized over the
    model-parallel axes."""

    def __init__(
        self,
        init_scale: float = 2.0**16,
        growth_factor: float = 2.0,
        backoff_factor: float = 0.5,
        growth_interval: int = 2000,
        hysteresis: int = 1,
        model_parallel_axes: Sequence[str] = (
            ps.TENSOR_PARALLEL_AXIS,
            ps.PIPELINE_PARALLEL_AXIS,
        ),
    ):
        super().__init__(
            init_scale=init_scale,
            growth_factor=growth_factor,
            backoff_factor=backoff_factor,
            growth_interval=growth_interval,
            hysteresis=hysteresis,
        )
        self.model_parallel_axes = tuple(model_parallel_axes)

    def _sync_found_inf(self, found_inf):
        found_inf = found_inf.clone()
        for ax in self.model_parallel_axes:
            comm.all_reduce(found_inf, ps.get_group(ax), op="max")
        return found_inf

    def unscale(self, grads, state: LossScaleState) -> Tuple[object, object]:
        grads, found_inf = super().unscale(grads, state)
        return grads, self._sync_found_inf(found_inf)

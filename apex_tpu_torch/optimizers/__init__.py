"""Optimizers of the port (counterpart of :mod:`apex_tpu.optimizers`)."""

from apex_tpu_torch.optimizers.fused_adam import (  # noqa: F401
    FusedAdam,
    FusedAdamState,
    fused_adam,
)

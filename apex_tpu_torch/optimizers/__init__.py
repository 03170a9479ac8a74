"""Optimizers of the port (counterpart of :mod:`apex_tpu.optimizers`)."""

from apex_tpu_torch.optimizers.fused_adam import (  # noqa: F401
    FusedAdam,
    FusedAdamState,
    fused_adam,
)
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB,
    FusedLAMBState,
    fused_lamb,
)
from apex_tpu_torch.optimizers.multi_tensor import (  # noqa: F401
    axpby,
    global_norm,
    per_tensor_norm,
    scale_with_overflow_check,
)

"""Mixed precision (counterpart of :mod:`apex_tpu.amp`): the opt-level
policies and the loss scalers.  The reference's ``frontend``
(``initialize``, ``scale_loss``, the amp state dict), ``lists`` and
``fp16_utils`` wait for ROADMAP item 10."""

from apex_tpu_torch.amp.policy import Policy, Properties, opt_levels  # noqa: F401
from apex_tpu_torch.amp.scaler import (  # noqa: F401
    DynamicLossScaler,
    LossScaleState,
    StaticLossScaler,
    amp_update,
)

"""Mixed precision (counterpart of :mod:`apex_tpu.amp`): the opt-level
policies, the loss scalers, the ``initialize`` frontend with its
``AmpHandle`` and state dict, and the O1 per-op cast lists
(:mod:`apex_tpu_torch.amp.lists`)."""

from apex_tpu_torch.amp import lists  # noqa: F401
from apex_tpu_torch.amp.frontend import (  # noqa: F401
    AmpHandle,
    AmpState,
    initialize,
    load_state_dict,
    master_params,
    scale_loss,
    state_dict,
)
from apex_tpu_torch.amp.policy import Policy, Properties, opt_levels  # noqa: F401
from apex_tpu_torch.amp.scaler import (  # noqa: F401
    DynamicLossScaler,
    LossScaleState,
    StaticLossScaler,
    amp_update,
)

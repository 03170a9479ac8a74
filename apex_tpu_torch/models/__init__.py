"""Models of the port (counterpart of :mod:`apex_tpu.models`)."""

from apex_tpu_torch.models.convert import (  # noqa: F401
    from_jax_params,
    to_jax_params,
)
from apex_tpu_torch.models.gpt import (  # noqa: F401
    GptBlock,
    GptConfig,
    GptModel,
    gpt_lm_loss,
    rope_cos_sin,
)

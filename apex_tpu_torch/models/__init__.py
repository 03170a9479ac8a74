"""Models of the port (counterpart of :mod:`apex_tpu.models`)."""

from apex_tpu_torch.models.convert import from_jax_params  # noqa: F401
from apex_tpu_torch.models.gpt import (  # noqa: F401
    GptBlock,
    GptConfig,
    GptModel,
    rope_cos_sin,
)

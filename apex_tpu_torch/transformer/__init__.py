"""Transformer building blocks of the port (counterpart of
:mod:`apex_tpu.transformer`):

- :mod:`.tensor_parallel` — TP/SP sharded layers, collective mappings,
  vocab-parallel CE, RNG tracking;
- :mod:`.pipeline_parallel` — the pipeline schedules, the p2p shift,
  the microbatch calculator (:mod:`.microbatches`);
- :mod:`.context_parallel` — ring, zigzag and Ulysses attention;
- :mod:`.moe` — Switch MoE over the dp ranks;
- :mod:`.functional` — FusedScaleMaskSoftmax and the fused RoPE;
  :mod:`.amp` — the model-parallel GradScaler; :mod:`.enums`;
- :mod:`.layers` — the persist-LN selector; :mod:`.log_util` — the
  subsystem's logger; :mod:`.testing` — the standalone GPT and BERT
  providers and the test helpers.

The submodules load on first access, as the reference's do."""

from apex_tpu_torch import parallel_state  # noqa: F401
from apex_tpu_torch.transformer import tensor_parallel  # noqa: F401
from apex_tpu_torch.transformer.enums import (  # noqa: F401
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)
from apex_tpu_torch.transformer.log_util import (  # noqa: F401
    get_transformer_logger,
    set_logging_level,
)

_LAZY = (
    "pipeline_parallel",
    "functional",
    "amp",
    "microbatches",
    "moe",
    "context_parallel",
    "layers",
    "testing",
)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(f"apex_tpu_torch.transformer.{name}")
        globals()[name] = module
        return module
    raise AttributeError(
        f"module 'apex_tpu_torch.transformer' has no attribute {name!r}"
    )

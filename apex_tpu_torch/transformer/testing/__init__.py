"""The in-package test harness — counterpart of
``apex_tpu/transformer/testing`` (≙ ``apex/transformer/testing``):
seeds, separators, the model-parallel set-up, a one-process world, a
learnable-tensor module, and the standalone GPT and BERT providers over
:mod:`apex_tpu_torch.models`.  The reference's multi-device runs are
ranks as processes here (``tests/torch_dist_workers.py`` spawns them)."""

from apex_tpu_torch.transformer.testing.commons import (  # noqa: F401
    IdentityLayer,
    cpu_mesh,
    initialize_distributed,
    print_separator,
    set_random_seed,
)
from apex_tpu_torch.transformer.testing.standalone_bert import (  # noqa: F401
    bert_model_provider,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import (  # noqa: F401
    gpt_model_provider,
)

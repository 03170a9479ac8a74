"""Models of the port (counterpart of :mod:`apex_tpu.models`)."""

from apex_tpu_torch.models.bert import (  # noqa: F401
    BertConfig,
    BertForPreTraining,
    BertModel,
    bert_large_config,
    bert_pretrain_loss,
)
from apex_tpu_torch.models.convert import (  # noqa: F401
    bert_from_jax_params,
    bert_to_jax_params,
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

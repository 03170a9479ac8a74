"""Models of the port (counterpart of :mod:`apex_tpu.models`)."""

from apex_tpu_torch.models.bert import (  # noqa: F401
    BertConfig,
    BertEncoderCore,
    BertForPreTraining,
    BertLayer,
    BertModel,
    bert_large_config,
    bert_pretrain_loss,
)
from apex_tpu_torch.models.convert import (  # noqa: F401
    adam_state_from_jax,
    bert_from_jax_params,
    bert_lamb_state_from_jax,
    bert_to_jax_params,
    evoformer_from_jax_params,
    evoformer_to_jax_params,
    from_jax_params,
    gpt_param_tree,
    load_optimizer_state,
    optimizer_state,
    to_jax_params,
)
from apex_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResNetConfig,
    resnet50,
    resnet50_config,
)
from apex_tpu_torch.models.gpt import (  # noqa: F401
    GptBlock,
    GptConfig,
    GptModel,
    gpt_lm_loss,
    rope_cos_sin,
)

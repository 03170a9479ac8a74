"""The minimal BERT fixture — counterpart of
``apex_tpu/transformer/testing/standalone_bert.py`` (≙
``apex/transformer/testing/standalone_bert.py`` ::
``bert_model_provider``) over :mod:`apex_tpu_torch.models.bert`."""

from __future__ import annotations

import torch

from apex_tpu_torch.models.bert import BertConfig, BertForPreTraining

__all__ = ["bert_model_provider", "TEST_CONFIG"]

TEST_CONFIG = dict(
    vocab_size=128,
    hidden_size=64,
    num_layers=4,
    num_heads=8,
    intermediate_size=128,
    max_position_embeddings=64,
    dtype=torch.float32,
)


def bert_model_provider(sequence_parallel: bool = False, remat: bool = False,
                        device="cuda", generator=None,
                        **overrides) -> BertForPreTraining:
    """A :class:`BertForPreTraining` at :data:`TEST_CONFIG` (with
    ``overrides``) on ``device``."""
    cfg = BertConfig(sequence_parallel=sequence_parallel, remat=remat,
                     **{**TEST_CONFIG, **overrides})
    return BertForPreTraining(cfg, device=device, generator=generator)

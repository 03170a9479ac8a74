"""The minimal GPT fixture — counterpart of
``apex_tpu/transformer/testing/standalone_gpt.py`` (≙
``apex/transformer/testing/standalone_gpt.py`` ::
``gpt_model_provider``) over :mod:`apex_tpu_torch.models.gpt`."""

from __future__ import annotations

import torch

from apex_tpu_torch.models.gpt import GptConfig, GptModel

__all__ = ["gpt_model_provider", "TEST_CONFIG"]

TEST_CONFIG = dict(
    vocab_size=128,
    hidden_size=64,
    num_layers=4,
    num_heads=8,
    intermediate_size=128,
    max_seq_len=64,
    dtype=torch.float32,
)


def gpt_model_provider(sequence_parallel: bool = False, remat: bool = False,
                       device="cuda", generator=None,
                       **overrides) -> GptModel:
    """A :class:`GptModel` at :data:`TEST_CONFIG` (with ``overrides``)
    on ``device``."""
    cfg = GptConfig(sequence_parallel=sequence_parallel, remat=remat,
                    **{**TEST_CONFIG, **overrides})
    return GptModel(cfg, device=device, generator=generator)

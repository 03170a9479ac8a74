"""Functional transformer ops (counterpart of
:mod:`apex_tpu.transformer.functional`)."""

from apex_tpu_torch.transformer.functional.fused_softmax import (  # noqa: F401
    FusedScaleMaskSoftmax,
)
from apex_tpu_torch.ops.rope import (  # noqa: F401
    fused_apply_rotary_pos_emb,
    fused_apply_rotary_pos_emb_cached,
)

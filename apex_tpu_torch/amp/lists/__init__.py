"""Per-op AMP cast policy — the O1 patch-table semantics.

Counterpart of ``apex_tpu/amp/lists`` (≙ ``apex/amp/lists/*_overrides``).
The reference's O1 monkey-patches every listed torch function so
GEMM-class ops run in half precision, reduction/loss-class ops in fp32,
and multi-input ops promote to the widest input dtype.  Here nothing is
patched: the package's public ops (``flash_attention``, the LayerNorm
and RMSNorm entry points, ``softmax_cross_entropy_loss``, the scaled
softmaxes) consult the active policy at their entry through
:func:`amp_cast`.

Activate it with ``with amp.lists.o1_patch(half_dtype): ...`` around the
forward (or ``AmpHandle.patch_functions()``).  With no active policy
every hook is the identity.  A checkpointed block recomputes under the
policy its forward saw (:func:`carry_policy`), also when the backward
runs outside the block.
"""

from apex_tpu_torch.amp.lists._registry import (
    CastPolicy,
    active_policy,
    amp_cast,
    carry_policy,
    category,
    o1_patch,
    register,
)
from apex_tpu_torch.amp.lists.functional_overrides import (
    CASTS,
    FP16_FUNCS,
    FP32_FUNCS,
)

__all__ = [
    "CastPolicy",
    "active_policy",
    "amp_cast",
    "carry_policy",
    "category",
    "o1_patch",
    "register",
    "FP16_FUNCS",
    "FP32_FUNCS",
    "CASTS",
]

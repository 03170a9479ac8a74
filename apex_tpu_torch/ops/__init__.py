"""Fused ops: each kernel beside its plain PyTorch version.

Counterpart of :mod:`apex_tpu.ops` for the serving slice — LayerNorm /
RMSNorm forward (kernel K1), RoPE (plain), causal flash-attention
forward (K3) and paged decode attention (K6).  A CUDA tensor goes to the
kernel, a CPU tensor to the plain version (:mod:`._dispatch`).
"""

from apex_tpu_torch.ops.attention import (  # noqa: F401
    flash_attention,
    flash_attention_with_lse,
    mha_reference,
    mha_reference_with_lse,
)
from apex_tpu_torch.ops.layer_norm import (  # noqa: F401
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
)
from apex_tpu_torch.ops.paged_attention import (  # noqa: F401
    paged_decode_attention,
    paged_decode_attention_reference,
)
from apex_tpu_torch.ops.rope import (  # noqa: F401
    fused_apply_rotary_pos_emb_cached,
    rotate_half,
)

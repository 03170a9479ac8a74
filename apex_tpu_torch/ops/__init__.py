"""Fused ops: each kernel beside its plain PyTorch version.

Counterpart of :mod:`apex_tpu.ops` for the serving and training slices
— LayerNorm / RMSNorm (kernels K1 forward and K2 backward), RoPE
(plain), flash attention and packed-QKV attention (K3 forward and K4
backward), paged decode attention (K6), and the plain softmax
cross entropy and scaled (masked) softmaxes.  A CUDA tensor goes to the kernel, a CPU tensor to the
plain version (:mod:`._dispatch`).
"""

from apex_tpu_torch.ops.attention import (  # noqa: F401
    flash_attention,
    fmha_qkvpacked,
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
    fused_apply_rotary_pos_emb,
    fused_apply_rotary_pos_emb_cached,
    rotate_half,
)
from apex_tpu_torch.ops.scaled_softmax import (  # noqa: F401
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.ops.xentropy import (  # noqa: F401
    SoftmaxCrossEntropyLoss,
    softmax_cross_entropy_loss,
)

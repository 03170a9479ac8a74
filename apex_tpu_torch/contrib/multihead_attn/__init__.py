"""Fused multihead attention modules — counterpart of
``apex_tpu/contrib/multihead_attn`` (≙ ``apex/contrib/multihead_attn``:
``SelfMultiheadAttn`` and ``EncdecMultiheadAttn`` with ``bias``,
``include_norm_add``, ``mask_additive``, ``dropout`` and ``impl``).

The reference's CUDA pipeline (QKV GEMM, scaled masked softmax,
dropout, PV GEMM, output projection) is here one fused QKV projection
(cuBLAS), the port's ``flash_attention`` (K3 forward, K4 backward on
the card) and the output projection; ``include_norm_add`` puts
``fused_layer_norm_affine`` (K1/K2) in front and adds the residual.
"""

from apex_tpu_torch.contrib.multihead_attn.modules import (  # noqa: F401
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
    from_jax_params,
    to_jax_params,
)

"""≙ apex/contrib/clip_grad — the fused ``clip_grad_norm_``
(counterpart of ``apex_tpu/contrib/clip_grad``)."""

from apex_tpu_torch.optimizers.clip_grad import (  # noqa: F401
    clip_grad_norm,
    clip_grad_norm_,
)

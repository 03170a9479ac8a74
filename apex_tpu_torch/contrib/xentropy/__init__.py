"""≙ apex/contrib/xentropy — the fused softmax cross-entropy, the same op
as :mod:`apex_tpu_torch.ops.xentropy` (counterpart of
``apex_tpu/contrib/xentropy``)."""

from apex_tpu_torch.ops.xentropy import (  # noqa: F401
    SoftmaxCrossEntropyLoss,
    softmax_cross_entropy_loss,
)

"""Group batch norm, cuDNN flavour — ≙ ``apex/contrib/cudnn_gbn``
(``GroupBatchNorm2d``); counterpart of ``apex_tpu/contrib/cudnn_gbn``.

Upstream ships the same operation twice, on two native backends (hand
CUDA in ``groupbn``, cuDNN graphs here).  One implementation serves both
import paths: :class:`apex_tpu_torch.contrib.groupbn.BatchNorm2d_NHWC`.
"""

from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC

__all__ = ["GroupBatchNorm2d", "BatchNorm2d_NHWC"]

GroupBatchNorm2d = BatchNorm2d_NHWC

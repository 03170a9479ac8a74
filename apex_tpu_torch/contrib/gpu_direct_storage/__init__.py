"""≙ ``apex/contrib/gpu_direct_storage`` (counterpart of
``apex_tpu/contrib/gpu_direct_storage``): not part of this port.

The upstream module reads and writes tensors between NVMe and device
memory through cuFile (GPUDirect Storage).  This port does not bind
cuFile; :func:`load_data` and :func:`save_data` raise and name the
checkpoint path it has instead.
"""

from __future__ import annotations

__all__ = ["load_data", "save_data"]

_MSG = (
    "GPUDirect Storage (cuFile) is not part of apex_tpu_torch. For "
    "checkpoint I/O use apex_tpu_torch.checkpoint and the asynchronous "
    "engine of apex_tpu_torch.goodput (AsyncCheckpointEngine), which "
    "copies device tensors to the host and writes them beside the "
    "training steps."
)


def load_data(*args, **kwargs):
    raise NotImplementedError(_MSG)


def save_data(*args, **kwargs):
    raise NotImplementedError(_MSG)

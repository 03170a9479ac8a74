"""Batch broadcast across the tensor-parallel group.

Counterpart of ``apex_tpu/transformer/tensor_parallel/data.py``
(≙ apex's ``broadcast_data``): the ranks of a tp group must feed the
same batch, so tp rank 0 reads it and the others receive it.  Under
SPMD the reference only checks the schema (every device traces one
program); here each process has its own data, so after the same checks
the tensors are broadcast from the group's source rank, in place.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.parallel import comm

__all__ = ["broadcast_data"]


def _check(keys: Sequence[str], data: Dict, target_dtype) -> None:
    for k in keys:
        if k not in data:
            raise KeyError(f"broadcast_data: key {k!r} missing from data")
        if data[k].dtype != target_dtype:
            raise TypeError(
                f"broadcast_data: data[{k!r}] has dtype {data[k].dtype}, "
                f"expected {target_dtype}"
            )


def broadcast_data(keys: Sequence[str], data: Dict,
                   datatype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``{k: data[k]}`` for ``keys``, each tensor overwritten in place by
    tp rank 0's (shapes must agree across the group).  The identity at
    tp = 1."""
    _check(keys, data, datatype)
    out = {k: data[k] for k in keys}
    group = ps.get_group(ps.TENSOR_PARALLEL_AXIS)
    if group is not None:
        src = ps.get_tensor_model_parallel_src_rank()
        for k in keys:
            comm.broadcast(out[k], src, group)
    return out

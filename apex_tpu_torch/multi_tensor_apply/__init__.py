"""multi_tensor_apply — counterpart of ``apex_tpu/multi_tensor_apply``
(≙ ``apex/multi_tensor_apply/multi_tensor_apply.py`` ::
``MultiTensorApply`` and the global ``multi_tensor_applier``, and the
``apex_C`` flatten/unflatten pair of ``csrc/flatten_unflatten.cpp``).

The reference packs many tensors' pointers into one kernel launch.  The
port's cross-tensor ops (:mod:`apex_tpu_torch.optimizers.multi_tensor`,
re-exported here) go through ``torch._foreach_*``, which does that
packing itself, so the applier keeps the *interface*:

    multi_tensor_applier(op, noop_flag, tensor_lists, *args)

calls ``op(*tensor_lists, *args)``; ``chunk_size`` and ``noop_flag``
are accepted and unused (overflow detection lives in
:func:`scale_with_overflow_check`).
"""

from __future__ import annotations

from typing import Any, List, Sequence

import torch

from apex_tpu_torch.optimizers.multi_tensor import (  # noqa: F401
    axpby,
    global_norm,
    per_tensor_norm,
    scale_with_overflow_check,
)

__all__ = [
    "MultiTensorApply",
    "multi_tensor_applier",
    "flatten",
    "unflatten",
    "global_norm",
    "per_tensor_norm",
    "scale_with_overflow_check",
    "axpby",
]


class MultiTensorApply:
    """Callable shim ≙ ``MultiTensorApply(chunk_size)``."""

    available = True
    warned = False

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = chunk_size

    def __call__(self, op, noop_flag, tensor_lists: Sequence[List[Any]],
                 *args):
        return op(*tensor_lists, *args)


multi_tensor_applier = MultiTensorApply()


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One flat 1-D buffer of a tensor list of one dtype (≙
    ``apex_C.flatten``, the DDP flat-bucket primitive)."""
    if not tensors:
        return torch.zeros((0,), dtype=torch.float32)
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError("flatten requires a uniform dtype, got "
                         f"{sorted(str(d) for d in dtypes)}")
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
    """Views of ``flat`` shaped like ``like`` (≙ ``apex_C.unflatten``)."""
    sizes = [t.numel() for t in like]
    if flat.numel() != sum(sizes):
        raise ValueError(f"flat buffer has {flat.numel()} elements, need "
                         f"{sum(sizes)}")
    return [chunk.view(t.shape)
            for chunk, t in zip(torch.split(flat, sizes), like)]

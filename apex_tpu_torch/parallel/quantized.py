"""Quantized-wire gradient all-reduce over the data-parallel group.

Counterpart of ``apex_tpu/parallel/quantized.py`` (EQuARX's blockwise
int8 all-reduce, arXiv 2506.17615): every gradient of at least
``min_size`` elements joins one flat bucket, which costs one all-to-all
of int8 codes with their packed scales (the reduce-scatter phase, summed
in f32 on the receiving shard) and one all-gather of the re-quantized
shard — two collectives per chunk whatever the count of tensors.
Smaller tensors take the exact all-reduce.

Accuracy: with ``gradient_average=True`` an element is off by at most
about ``(0.5 * (world + 1) + 0.5) / 127`` of its block's max before the
sum (half a code per rank in the first phase, averaged, and half a code
again in the second); without averaging the error of the sum grows with
the world as the sum does.  Not bit-identical to the exact path: use
:func:`~apex_tpu_torch.parallel.all_reduce_gradients` when exactness
matters.  The machinery is :mod:`apex_tpu_torch.parallel.comm`.
"""

from __future__ import annotations

from typing import Any, Optional

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.parallel import comm

__all__ = ["quantized_all_reduce_gradients"]


def quantized_all_reduce_gradients(
    grads: Any,
    axis_name: str = ps.DATA_PARALLEL_AXIS,
    gradient_average: bool = True,
    gradient_predivide_factor: Optional[float] = None,
    min_size: int = 1024,
    block: int = 256,
    chunks: Optional[int] = 1,
):
    """int8-wire gradient sync over ``axis_name``, in place (a tensor,
    or a dict or list of them); ``comm.sync_gradients`` with
    ``wire="int8"``.  ``chunks=1`` keeps the two-collective contract;
    None takes the engine's chunking rule."""
    return comm.sync_gradients(
        grads, axis_name, wire="int8", chunks=chunks, block=block,
        min_size=min_size, gradient_average=gradient_average,
        gradient_predivide_factor=gradient_predivide_factor,
    )

"""Tensor-parallel sharded layers.

Counterpart of ``apex_tpu/transformer/tensor_parallel/layers.py``
(≙ apex's ``VocabParallelEmbedding``, ``ColumnParallelLinear`` and
``RowParallelLinear``), as ``nn.Module``\\ s on the tp group of
:mod:`apex_tpu_torch.parallel_state`:

- weights keep PyTorch's ``(out, in)`` layout (the reference stores
  flax's ``(in, out)``): a column-parallel weight is this rank's rows
  ``(out / tp, in)``, a row-parallel weight its columns ``(out, in / tp)``,
  an embedding its vocab rows ``(V / tp, hidden)``;
- every parameter is f32 and is cast to the compute ``dtype`` where the
  reference casts it: the product runs on compute-dtype operands with
  f32 accumulation, is cast back, and the bias is added in the compute
  dtype — at tp = 1 exactly ``apply_linear`` / ``embed_tokens`` of
  :mod:`apex_tpu_torch.models.gpt`;
- **init independent of tp**: :func:`sharded_init` and
  :meth:`_TPLinear.load_full_` cut each rank's shard out of a full-shape
  weight drawn from the same generator as at tp = 1 (the reference's
  ``sharded_init``, ≙ ``_initialize_affine_weight_cpu``), so a tp = 2
  model holds exactly the tp = 1 model's weights, split;
- under sequence parallelism the tp-replicated parameters inside the
  sequence-sharded region register with
  ``parallel_state.register_sequence_parallel_param`` when built (so
  build the model after ``initialize_model_parallel``).

``gradient_accumulation_fusion`` and
``no_async_tensor_model_parallel_allreduce`` are accepted for the
reference's signature and change nothing: the parameters are f32, so
their gradients land in f32 with no separate fused kernel.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    checkpoint_name,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    divide,
)

__all__ = [
    "VocabParallelEmbedding",
    "ColumnParallelLinear",
    "RowParallelLinear",
    "sharded_init",
    "shard_of",
]

_TP = ps.TENSOR_PARALLEL_AXIS


def shard_of(full: torch.Tensor, dim: int, axis_name: str = _TP):
    """This rank's contiguous slice of ``full`` along ``dim`` (``full``
    itself at tp = 1)."""
    world = ps.axis_size(axis_name)
    if world == 1:
        return full
    size = divide(full.shape[dim], world)
    return full.narrow(dim, ps.axis_rank(axis_name) * size, size)


def sharded_init(base_init: Callable, full_shape: Tuple[int, ...],
                 shard_axis: int, axis_name: str = _TP) -> Callable:
    """An initializer ``init(generator, shape, dtype, device)`` that draws
    the full ``full_shape`` weight with ``base_init(generator,
    full_shape, dtype, device)`` and returns this rank's shard along
    ``shard_axis`` — the same statistics (and, from the same generator,
    the same weights) whatever the tp degree."""

    def init(generator, shape, dtype=torch.float32, device=None):
        full = base_init(generator, full_shape, dtype, device)
        out = shard_of(full, shard_axis, axis_name)
        if tuple(out.shape) != tuple(shape):
            raise ValueError(
                f"local shard shape {tuple(shape)} inconsistent with full "
                f"shape {full_shape} split over {axis_name!r} along axis "
                f"{shard_axis}"
            )
        return out

    return init


def _matmul_bias(x, weight, bias, dtype, name):
    """``apply_linear``'s arithmetic: the compute-dtype product, and the
    bias added in the compute dtype under the checkpoint tag ``name``."""
    y = F.linear(x.to(dtype), weight.to(dtype))
    if bias is None:
        return y
    b = bias.to(dtype)
    with checkpoint_name(name):
        return y + b


class _TPLinear(nn.Linear):
    """An ``nn.Linear`` holding this rank's shard (f32), with the full
    sizes it was cut from (``input_size``, ``output_size``) and the dim
    of the weight that is sharded (``shard_dim``)."""

    shard_dim = 0

    def __init__(self, input_size, output_size, local_in, local_out, bias,
                 dtype, device, axis_name):
        super().__init__(local_in, local_out, bias=bias, dtype=torch.float32,
                         device=device)
        self.input_size = input_size
        self.output_size = output_size
        self.compute_dtype = dtype
        self.axis_name = axis_name

    @torch.no_grad()
    def load_full_(self, weight: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> None:
        """Copy this rank's shard of the full ``(output_size,
        input_size)`` weight (and full bias) into the parameters."""
        self.weight.copy_(shard_of(weight, self.shard_dim, self.axis_name))
        if bias is not None:
            b = (shard_of(bias, 0, self.axis_name) if self.shard_dim == 0
                 else bias)
            self.bias.copy_(b)


class ColumnParallelLinear(_TPLinear):
    """Y = XW^T + b with W's output rows sharded over tp.

    Forward: under sequence parallelism the input's sequence shards are
    all-gathered (reduce-scatter backward); otherwise the input enters
    through ``copy_to`` (all-reduce backward).  ``gather_output``
    all-gathers the output columns; ``skip_bias_add`` returns
    ``(output, bias)`` for the caller to add."""

    shard_dim = 0

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 gather_output: bool = False,
                 sequence_parallel_enabled: bool = False,
                 skip_bias_add: bool = False,
                 gradient_accumulation_fusion: bool = False,
                 no_async_tensor_model_parallel_allreduce: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None,
                 axis_name: str = _TP):
        if gather_output and sequence_parallel_enabled:
            raise ValueError(
                "gather_output and sequence_parallel_enabled are mutually "
                "exclusive (the reference asserts the same)"
            )
        world = ps.axis_size(axis_name)
        super().__init__(input_size, output_size, input_size,
                         divide(output_size, world), bias, dtype, device,
                         axis_name)
        self.gather_output = gather_output
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.skip_bias_add = skip_bias_add

    def forward(self, x, name: Optional[str] = None):
        """``name`` tags the bias add for the "sums" remat policy."""
        if ps.axis_size(self.axis_name) > 1:
            if self.sequence_parallel_enabled:
                x = gather_from_sequence_parallel_region(x, self.axis_name)
            else:
                x = copy_to_tensor_model_parallel_region(x, self.axis_name)
        dtype = self.compute_dtype or x.dtype
        bias = None if self.skip_bias_add else self.bias
        y = _matmul_bias(x, self.weight, bias, dtype, name)
        if self.gather_output and ps.axis_size(self.axis_name) > 1:
            y = gather_from_tensor_model_parallel_region(y, self.axis_name)
        if self.skip_bias_add:
            return y, (self.bias.to(dtype) if self.bias is not None else None)
        return y


class RowParallelLinear(_TPLinear):
    """Y = XW^T + b with W's input columns sharded over tp.

    Forward: the local product, then an all-reduce over tp (a
    reduce-scatter along the sequence under sequence parallelism), then
    the bias.  ``input_is_parallel``: the input already holds this
    rank's shard of the last dim (as after a ColumnParallelLinear).

    Under sequence parallelism the bias is added inside the
    sequence-sharded region, so it registers as sequence-parallel; with
    ``skip_bias_add`` the caller must add it inside that region too."""

    shard_dim = 1

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 input_is_parallel: bool = False,
                 sequence_parallel_enabled: bool = False,
                 skip_bias_add: bool = False,
                 gradient_accumulation_fusion: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None,
                 axis_name: str = _TP):
        if sequence_parallel_enabled and not input_is_parallel:
            raise ValueError(
                "sequence_parallel_enabled requires input_is_parallel "
                "(the reference asserts the same)"
            )
        world = ps.axis_size(axis_name)
        super().__init__(input_size, output_size, divide(input_size, world),
                         output_size, bias, dtype, device, axis_name)
        self.input_is_parallel = input_is_parallel
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.skip_bias_add = skip_bias_add
        if self.bias is not None and sequence_parallel_enabled:
            ps.register_sequence_parallel_param(self.bias)

    def forward(self, x, name: Optional[str] = None):
        world = ps.axis_size(self.axis_name)
        if world > 1 and not self.input_is_parallel:
            x = scatter_to_tensor_model_parallel_region(x, self.axis_name)
        dtype = self.compute_dtype or x.dtype
        if world == 1:
            bias = None if self.skip_bias_add else self.bias
            y = _matmul_bias(x, self.weight, bias, dtype, name)
        else:
            y = F.linear(x.to(dtype), self.weight.to(dtype))
            if self.sequence_parallel_enabled:
                y = reduce_scatter_to_sequence_parallel_region(
                    y, self.axis_name)
            else:
                y = reduce_from_tensor_model_parallel_region(y, self.axis_name)
            if self.bias is not None and not self.skip_bias_add:
                b = self.bias.to(dtype)
                with checkpoint_name(name):
                    y = y + b
        if self.skip_bias_add:
            return y, (self.bias.to(dtype) if self.bias is not None else None)
        return y


class VocabParallelEmbedding(nn.Module):
    """Vocab-row-sharded embedding: ids outside this rank's rows look up
    zeros, and the rows are summed over tp in f32 (reduce-scattered
    along the sequence under sequence parallelism: seq-first ``(S, ...)``
    ids then), then cast to ``dtype``.  At tp = 1 the lookup on the f32
    table, then the cast."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 sequence_parallel_enabled: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None,
                 axis_name: str = _TP):
        super().__init__()
        world = ps.axis_size(axis_name)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.num_embeddings_per_partition = divide(num_embeddings, world)
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.compute_dtype = dtype
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.empty(
            self.num_embeddings_per_partition, embedding_dim,
            dtype=torch.float32, device=device))

    @torch.no_grad()
    def load_full_(self, weight: torch.Tensor) -> None:
        """Copy this rank's rows of the full ``(V, hidden)`` table."""
        self.weight.copy_(shard_of(weight, 0, self.axis_name))

    def forward(self, ids):
        world = ps.axis_size(self.axis_name)
        if world == 1:
            out = F.embedding(ids.long(), self.weight)
        else:
            per = self.num_embeddings_per_partition
            start, end = VocabUtility.vocab_range_from_per_partition_vocab_size(
                per, ps.axis_rank(self.axis_name), world)
            ids = ids.long()
            in_range = (ids >= start) & (ids < end)
            out = F.embedding((ids - start).clamp(0, per - 1), self.weight)
            out = torch.where(in_range[..., None], out, 0.0)
            if self.sequence_parallel_enabled:
                out = reduce_scatter_to_sequence_parallel_region(
                    out, self.axis_name)
            else:
                out = reduce_from_tensor_model_parallel_region(
                    out, self.axis_name)
        if self.compute_dtype is not None:
            out = out.to(self.compute_dtype)
        return out

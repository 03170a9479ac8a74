"""Shard arithmetic — counterpart of
``apex_tpu/transformer/tensor_parallel/utils.py`` (≙ apex's
``split_tensor_along_last_dim``, ``VocabUtility`` and ``divide``)."""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.parallel_state import divide  # noqa: F401  (re-export)

__all__ = ["divide", "split_tensor_along_last_dim", "VocabUtility"]


def split_tensor_along_last_dim(tensor: torch.Tensor, num_partitions: int,
                                contiguous_split_chunks: bool = False):
    """``num_partitions`` equal views along the last dim (contiguous
    copies with ``contiguous_split_chunks``)."""
    chunk = divide(tensor.shape[-1], num_partitions)
    parts = torch.split(tensor, chunk, dim=-1)
    if contiguous_split_chunks:
        return tuple(p.contiguous() for p in parts)
    return parts


class VocabUtility:
    """Vocab range arithmetic of row-sharded embeddings: rank r owns
    ids ``[first, last)``."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
        per_partition_vocab_size: int, rank: int, world_size: int
    ) -> Tuple[int, int]:
        first = rank * per_partition_vocab_size
        return first, first + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(
        global_vocab_size: int, rank: int, world_size: int
    ) -> Tuple[int, int]:
        per = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per, rank, world_size
        )

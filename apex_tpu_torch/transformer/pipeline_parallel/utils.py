"""Microbatch bookkeeping (counterpart of
``apex_tpu/transformer/pipeline_parallel/utils.py``, ≙ apex/transformer/
pipeline_parallel/utils.py): ``setup_microbatch_calculator``,
``get_num_microbatches``, ``get_current_global_batch_size``,
``update_num_microbatches``, ``_reconfigure_microbatch_calculator``,
``listify_model``, ``get_kth_microbatch`` and
``split_batch_into_microbatches``.  Host-side Python; the batch helpers
map over a tree (dicts, lists, tuples) of tensors."""

from __future__ import annotations

from typing import Any, List, Optional

from apex_tpu_torch.analysis.sharding import tree_map
from apex_tpu_torch.transformer.microbatches import (
    build_num_microbatches_calculator,
)

__all__ = [
    "setup_microbatch_calculator",
    "get_num_microbatches",
    "get_current_global_batch_size",
    "update_num_microbatches",
    "listify_model",
    "get_kth_microbatch",
    "split_batch_into_microbatches",
]

_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None


def setup_microbatch_calculator(
    rank: int,
    rampup_batch_size: Optional[list],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
) -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    if _GLOBAL_NUM_MICROBATCHES_CALCULATOR is not None:
        raise RuntimeError("num microbatches calculator is already initialized")
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size,
    )


def _reconfigure_microbatch_calculator(
    rank: int,
    rampup_batch_size: Optional[list],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
) -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size,
    )


def destroy_microbatch_calculator() -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None


def _calc():
    if _GLOBAL_NUM_MICROBATCHES_CALCULATOR is None:
        raise RuntimeError(
            "microbatch calculator is not initialized — call "
            "setup_microbatch_calculator first"
        )
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR


def get_num_microbatches() -> int:
    return _calc().get()


def get_current_global_batch_size() -> int:
    return _calc().get_current_global_batch_size()


def update_num_microbatches(consumed_samples, consistency_check=True) -> None:
    _calc().update(consumed_samples, consistency_check)


def listify_model(model: Any) -> List[Any]:
    """≙ listify_model (interleaved schedules carry a list of chunks)."""
    if isinstance(model, list):
        return model
    return [model]


def get_kth_microbatch(batch, k: int):
    """≙ get_kth_microbatch: microbatch ``k`` of stacked ``(nm, ...)``
    leaves."""
    return tree_map(lambda x: x[k], batch)


def split_batch_into_microbatches(batch, num_microbatches: int):
    """Reshape (global, ...) leaves into (num_microbatches, mb, ...)."""

    def f(x):
        if x.shape[0] % num_microbatches != 0:
            raise ValueError(
                f"batch dim {x.shape[0]} not divisible by num_microbatches "
                f"{num_microbatches}"
            )
        return x.reshape(num_microbatches, x.shape[0] // num_microbatches,
                         *x.shape[1:])

    return tree_map(f, batch)

"""Microbatch calculators (counterpart of
``apex_tpu/transformer/microbatches.py``, ≙ apex/transformer/
microbatches.py): ``ConstantNumMicroBatches``,
``RampupBatchsizeNumMicroBatches`` and
``build_num_microbatches_calculator``, host-side Python with the
reference's validation and messages."""

from __future__ import annotations

from typing import Optional

__all__ = [
    "ConstantNumMicroBatches",
    "RampupBatchsizeNumMicroBatches",
    "build_num_microbatches_calculator",
]


class ConstantNumMicroBatches:
    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 data_parallel_size: int):
        micro_times_dp = micro_batch_size * data_parallel_size
        if global_batch_size % micro_times_dp != 0:
            raise ValueError(
                f"global batch size ({global_batch_size}) is not divisible by"
                f" micro batch size ({micro_batch_size}) times data parallel"
                f" size ({data_parallel_size})"
            )
        self.num_micro_batches = global_batch_size // micro_times_dp
        self.current_global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def update(self, consumed_samples, consistency_check=True):
        pass


class RampupBatchsizeNumMicroBatches:
    """Linear batch-size ramp: start → global over ramp_samples."""

    def __init__(
        self,
        start_batch_size: int,
        batch_size_increment: int,
        ramup_samples: int,
        global_batch_size: int,
        micro_batch_size: int,
        data_parallel_size: int,
    ):
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = ramup_samples
        self.global_batch_size = global_batch_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size
        )
        if batch_size_increment <= 0:
            raise ValueError("batch_size_increment must be positive")
        diff = global_batch_size - start_batch_size
        if diff < 0 or diff % batch_size_increment != 0:
            raise ValueError(
                "global batch size must be start batch size plus an integer "
                "number of increments"
            )
        num_increments = diff // batch_size_increment
        self.rampup_samples_per_increment = (
            ramup_samples / num_increments if num_increments > 0 else 0
        )
        self.update(0)

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def update(self, consumed_samples, consistency_check: bool = True):
        if (
            self.rampup_samples_per_increment == 0
            or consumed_samples > self.ramup_samples
        ):
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            self.current_global_batch_size = min(
                self.start_batch_size + steps * self.batch_size_increment,
                self.global_batch_size,
            )
        if consistency_check and (
            self.current_global_batch_size
            % self.micro_batch_times_data_parallel_size
            != 0
        ):
            raise ValueError(
                f"current global batch size "
                f"({self.current_global_batch_size}) is not divisible by "
                "micro-batch-size * data-parallel-size"
            )
        self.num_micro_batches = (
            self.current_global_batch_size
            // self.micro_batch_times_data_parallel_size
        )


def build_num_microbatches_calculator(
    rank: int,
    rampup_batch_size: Optional[list],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
):
    """≙ the reference factory (rampup_batch_size = [start, incr, samples])."""
    if rampup_batch_size is None:
        return ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size
        )
    if len(rampup_batch_size) != 3:
        raise ValueError(
            "rampup_batch_size must be [start_batch_size, increment, samples]"
        )
    return RampupBatchsizeNumMicroBatches(
        int(rampup_batch_size[0]),
        int(rampup_batch_size[1]),
        int(rampup_batch_size[2]),
        global_batch_size,
        micro_batch_size,
        data_parallel_size,
    )

"""Tensor and sequence parallelism (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel`, ≙
``apex.transformer.tensor_parallel``) on the tp process group of
:mod:`apex_tpu_torch.parallel_state`."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (  # noqa: F401
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.data import broadcast_data  # noqa: F401
from apex_tpu_torch.transformer.tensor_parallel.layers import (  # noqa: F401
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    sharded_init,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (  # noqa: F401
    _gather_along_first_dim,
    _gather_along_last_dim,
    _reduce,
    _reduce_scatter_along_first_dim,
    _split_along_first_dim,
    _split_along_last_dim,
    allreduce_sequence_parallel_gradients,
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (  # noqa: F401
    TPURNGStatesTracker,
    checkpoint,
    get_cuda_rng_tracker,
    get_tpu_rng_tracker,
    model_parallel_cuda_manual_seed,
    model_parallel_tpu_manual_seed,
    to_per_rank_key,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (  # noqa: F401
    VocabUtility,
    divide,
    split_tensor_along_last_dim,
)

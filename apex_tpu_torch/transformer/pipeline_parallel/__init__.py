"""Pipeline parallelism (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel`, ≙ apex/transformer/
pipeline_parallel): the stage-to-stage shift (:mod:`.p2p_communication`),
the five schedules and their dispatcher, the remat policy resolution
(:mod:`.schedules`) and the microbatch bookkeeping (:mod:`.utils`)."""

from apex_tpu_torch.transformer.pipeline_parallel import (  # noqa: F401
    p2p_communication,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (  # noqa: F401
    forward_backward_no_pipelining,
    forward_backward_pipelining_1f1b,
    forward_backward_pipelining_interleaved_1f1b,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func,
)
from apex_tpu_torch.transformer.pipeline_parallel.utils import (  # noqa: F401
    get_current_global_batch_size,
    get_kth_microbatch,
    get_num_microbatches,
    listify_model,
    setup_microbatch_calculator,
    split_batch_into_microbatches,
    update_num_microbatches,
)

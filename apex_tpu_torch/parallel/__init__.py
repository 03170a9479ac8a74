"""Data parallelism (counterpart of :mod:`apex_tpu.parallel`, ≙
``apex.parallel``) on ``torch.distributed`` process groups:

- :mod:`apex_tpu_torch.parallel.comm` — the gradient-sync engine (the
  f32/bf16/int8 wires, chunking, the collective plans and the call log)
  that DDP and the ZeRO optimizers share, and the int8 codec the serving
  stack's KV and weight wires use;
- :class:`DistributedDataParallel`, :func:`all_reduce_gradients`,
  :class:`Reducer`;
- :func:`quantized_all_reduce_gradients` (the int8 wire);
- :class:`DistributedFusedAdam` / :class:`DistributedFusedLAMB` (ZeRO);
- :class:`SyncBatchNorm`, :func:`convert_syncbn_model`;
- :func:`initialize_distributed` and the process helpers of
  :mod:`~apex_tpu_torch.parallel.multihost`;
- ``LARC``, re-exported from :mod:`apex_tpu_torch.optimizers.larc` as
  the reference re-exports it.
"""

from apex_tpu_torch.parallel import comm  # noqa: F401  (the sync engine)
from apex_tpu_torch.parallel.comm import (  # noqa: F401
    all_gather_flat,
    collective_summary,
    compiled_collectives,
    reduce_scatter_flat,
    sync_gradients,
)
from apex_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedDataParallel,
    Reducer,
    all_reduce_gradients,
)
from apex_tpu_torch.parallel.distributed_fused_optimizers import (  # noqa: F401
    DistributedFusedAdam,
    DistributedFusedLAMB,
    DistributedFusedLamb,
)
from apex_tpu_torch.optimizers.larc import LARC, larc  # noqa: F401
from apex_tpu_torch.parallel.multihost import (  # noqa: F401
    distributed_is_initialized,
    finalize_distributed,
    host_barrier,
    host_count,
    host_id,
    initialize_distributed,
)
from apex_tpu_torch.parallel.quantized import (  # noqa: F401
    quantized_all_reduce_gradients,
)
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    SyncBatchNorm,
    convert_syncbn_model,
)

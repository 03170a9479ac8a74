"""≙ apex/contrib/optimizers — the ZeRO-sharded distributed fused
optimizers, under the reference's contrib names (counterpart of
:mod:`apex_tpu.contrib.optimizers`).  They live in
:mod:`apex_tpu_torch.parallel.distributed_fused_optimizers`: gradients
reduce-scattered over the dp group, the update on this rank's shard,
the parameters all-gathered."""

from apex_tpu_torch.parallel.distributed_fused_optimizers import (  # noqa: F401
    DistributedFusedAdam,
    DistributedFusedLAMB,
    DistributedFusedLamb,
)

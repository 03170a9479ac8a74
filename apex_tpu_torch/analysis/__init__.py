"""Checks of a built program (counterpart of :mod:`apex_tpu.analysis`).

Only the rule tables and the findings surface the trainer needs are
ported (:mod:`apex_tpu_torch.analysis.sharding`); the graph linters over
compiled programs wait for ROADMAP item 9.
"""

from apex_tpu_torch.analysis.sharding import (  # noqa: F401
    ERROR,
    INFO,
    WARNING,
    Finding,
    P,
    PartitionSpec,
    Report,
    match_partition_rules,
    spec_dim_factors,
    tree_paths,
)

"""Checks of a built program (counterpart of :mod:`apex_tpu.analysis`).

Ported so far: the findings schema and its rule catalog
(:mod:`.findings`), the rule tables the trainer reads
(:mod:`.sharding`), the host-side source lints — lock discipline
(:mod:`.concurrency`) and replay purity (:mod:`.purity`) — and the
retrace sentinel (:mod:`.retrace`).  The graph linters over captured
programs, the memory estimate, the kernel checks and the lint driver
wait for ROADMAP item 9.
"""

from apex_tpu_torch.analysis import concurrency, purity, retrace  # noqa: F401
from apex_tpu_torch.analysis.findings import (  # noqa: F401
    RULES,
    make_finding,
)
from apex_tpu_torch.analysis.retrace import (  # noqa: F401
    RetraceSentinel,
    abstract_signature,
)
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

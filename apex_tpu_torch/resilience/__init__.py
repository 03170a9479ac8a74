"""Fault tolerance — make a run survive what production throws at it
(counterpart of :mod:`apex_tpu.resilience`).

- :mod:`apex_tpu_torch.resilience.chaos` — deterministic, seedable fault
  injection (the reference's sites, spec grammar and coin), driven from
  tests or the ``APEX_TPU_CHAOS`` env var.
- :mod:`apex_tpu_torch.resilience.retry` — bounded-backoff retry for
  checkpoint I/O and the process group's rendezvous
  (``robust_initialize_distributed``).
- :mod:`apex_tpu_torch.resilience.runner` — ``run_resilient``:
  SIGTERM-safe training loop with ``latest_step()`` auto-resume and
  skip-budget rollback to the last complete checkpoint.
- :mod:`apex_tpu_torch.resilience.guards` — the guarded amp update
  (``GradGuard``, ``guarded_amp_update``): NaN and spike skips on the
  device, with a consecutive-skip budget.
"""

from apex_tpu_torch.resilience import chaos  # noqa: F401
from apex_tpu_torch.resilience.guards import (  # noqa: F401
    GradGuard,
    GuardState,
    GuardVerdict,
    guard_metrics,
    guarded_amp_update,
)
from apex_tpu_torch.resilience.retry import (  # noqa: F401
    RetryPolicy,
    add_retry_listener,
    remove_retry_listener,
    retry_call,
    robust_initialize_distributed,
)
from apex_tpu_torch.resilience.runner import (  # noqa: F401
    ObserverFanout,
    PreemptionHandler,
    ResilientCheckpointManager,
    RunResult,
    run_resilient,
)

__all__ = [
    "chaos",
    "GradGuard",
    "GuardState",
    "GuardVerdict",
    "guard_metrics",
    "guarded_amp_update",
    "RetryPolicy",
    "add_retry_listener",
    "remove_retry_listener",
    "retry_call",
    "ObserverFanout",
    "PreemptionHandler",
    "ResilientCheckpointManager",
    "RunResult",
    "run_resilient",
]

"""Shared utilities — counterpart of :mod:`apex_tpu.utils`: the tracing
hooks, which live in :mod:`apex_tpu_torch.observability.trace`, under
the names callers of the reference import from here."""

from apex_tpu_torch.observability.trace import (  # noqa: F401
    annotate,
    nvtx_range,
    range_pop,
    range_push,
    trace,
)

__all__ = ["annotate", "nvtx_range", "range_push", "range_pop", "trace"]

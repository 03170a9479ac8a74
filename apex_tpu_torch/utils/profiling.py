"""Deprecated path of the tracing hooks — counterpart of
``apex_tpu/utils/profiling.py``: the five names re-exported from
:mod:`apex_tpu_torch.observability.trace`, where new code imports them."""

from apex_tpu_torch.observability.trace import (  # noqa: F401
    annotate,
    nvtx_range,
    range_pop,
    range_push,
    trace,
)

__all__ = ["annotate", "nvtx_range", "range_push", "range_pop", "trace"]

"""Observability of the port (counterpart of :mod:`apex_tpu.observability`):
the serving path's telemetry spine.

- :mod:`~apex_tpu_torch.observability.metrics` — :class:`MetricRegistry`
  (0-d f32 tensors updated in place, fetched on a double-buffered
  cadence) and the host-side :data:`board`;
- :mod:`~apex_tpu_torch.observability.ometrics` — the OpenMetrics
  exposition (:func:`render`, :func:`parse_exposition`,
  :class:`OpsServer`, :class:`Histogram`, :func:`metric_name`);
- :mod:`~apex_tpu_torch.observability.spans` — :class:`SpanRecorder`,
  the per-request and per-step causal record;
- :mod:`~apex_tpu_torch.observability.flight` — :class:`FlightRecorder`,
  the crash black box;
- :mod:`~apex_tpu_torch.observability.health` — :class:`Watchdog` and the
  serving rules;
- :mod:`~apex_tpu_torch.observability.meter` — :class:`StepMeter`,
  :class:`GoodputAccountant`, the H100's peak tables and
  :func:`percentile`;
- :mod:`~apex_tpu_torch.observability.locks` — the lock-order sanitizer;
- :mod:`~apex_tpu_torch.observability.export` — :class:`Reporter` and its
  JSONL, CSV, TensorBoard and timeline sinks;
- :mod:`~apex_tpu_torch.observability.memstats` — the allocator's live
  watermarks, held against the static memory estimates.

The rest of the reference's observability (traces, attribution, the fleet
view, SLOs and canaries) waits for ROADMAP item 8's next parts.
"""

from apex_tpu_torch.observability.export import (  # noqa: F401
    CSVSink,
    JSONLSink,
    Reporter,
    TensorBoardSink,
    TimelineSink,
    bench_record,
)
from apex_tpu_torch.observability.flight import (  # noqa: F401
    ENV_FLIGHT,
    FlightRecorder,
    json_safe,
    parse_flight_spec,
)
from apex_tpu_torch.observability.health import (  # noqa: F401
    HealthEvent,
    HungStepRule,
    QueueDepthRule,
    QueueWaitFractionRule,
    Rule,
    ServeFaultRule,
    SpecAcceptanceRule,
    StaleFetchRule,
    TTFTRule,
    Watchdog,
    serve_rules,
)
from apex_tpu_torch.observability.locks import (  # noqa: F401
    TrackedLock,
    sanitizer_report,
)
from apex_tpu_torch.observability.memstats import (  # noqa: F401
    DeviceMemoryProvider,
    FakeMemoryProvider,
    MemStatsMonitor,
    MemStatsRule,
    oom_forensics,
)
from apex_tpu_torch.observability.meter import (  # noqa: F401
    GoodputAccountant,
    StepMeter,
    chip_peak_flops,
    peak_flops_for,
    peak_hbm_bandwidth_for,
    peak_ici_bandwidth_for,
    percentile,
    total_peak_flops,
    transformer_train_flops,
)
from apex_tpu_torch.observability.metrics import (  # noqa: F401
    Board,
    MetricRegistry,
    board,
)
from apex_tpu_torch.observability.ometrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS_MS,
    ExportNamespace,
    Histogram,
    OpsServer,
    metric_name,
    ops_port_from_env,
    parse_exposition,
    render,
)
from apex_tpu_torch.observability.spans import (  # noqa: F401
    SpanRecorder,
    monotonic_to_epoch,
    parse_spans_spec,
    wall_clock_anchor,
)

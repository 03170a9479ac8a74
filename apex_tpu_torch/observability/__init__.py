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
- :mod:`~apex_tpu_torch.observability.health` — :class:`Watchdog`, the
  training, goodput and serving rules (:func:`default_rules`,
  :func:`goodput_rules`, :func:`serve_rules`);
- :mod:`~apex_tpu_torch.observability.trace` — :class:`TraceScheduler`
  (profiler windows armed by ``APEX_TPU_TRACE_STEPS``) and the
  annotation hooks;
- :mod:`~apex_tpu_torch.observability.attribution` — a trace's and a
  recorded step's compute / collective / host-stall split, the roofline;
- :mod:`~apex_tpu_torch.observability.fleet` — :class:`FleetAggregator`,
  every rank's metric row on one board;
- :mod:`~apex_tpu_torch.observability.slo` — SLOs, burn rates and
  :class:`SLORule`;
- :mod:`~apex_tpu_torch.observability.canary` — golden-probe
  fingerprints and the canary's drift verdicts;
- :mod:`~apex_tpu_torch.observability.meter` — :class:`StepMeter`,
  :class:`GoodputAccountant`, the H100's peak tables and
  :func:`percentile`;
- :mod:`~apex_tpu_torch.observability.locks` — the lock-order sanitizer;
- :mod:`~apex_tpu_torch.observability.export` — :class:`Reporter` and its
  JSONL, CSV, TensorBoard and timeline sinks;
- :mod:`~apex_tpu_torch.observability.memstats` — the allocator's live
  watermarks, held against the static memory estimates.
"""

from apex_tpu_torch.observability.attribution import (  # noqa: F401
    CostAttribution,
    TraceAttribution,
    attribute_cost_model,
    attribute_trace,
    attribute_trace_dir,
    hlo_bucket_map,
    publish_attribution,
    roofline_report,
)
from apex_tpu_torch.observability.canary import (  # noqa: F401
    CanaryAnalyzer,
    CanaryConfig,
    CanaryController,
    CanaryVerdict,
    GoldenProbeSet,
    binom_tail,
    fingerprint_distance,
    mann_whitney_p,
    model_fingerprint,
)
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
from apex_tpu_torch.observability.fleet import (  # noqa: F401
    FleetAggregator,
    FleetView,
)
from apex_tpu_torch.observability.health import (  # noqa: F401
    CheckpointStallRule,
    CollectiveFractionRule,
    GoodputFloorRule,
    HealthEvent,
    HostStallRule,
    HungStepRule,
    InputStallRule,
    LossSpikeRule,
    MemoryBudgetRule,
    MFUFloorRule,
    NaNRateRule,
    QueueDepthRule,
    QueueWaitFractionRule,
    Rule,
    ServeFaultRule,
    SpecAcceptanceRule,
    StaleFetchRule,
    StragglerRule,
    TTFTRule,
    Watchdog,
    default_rules,
    goodput_rules,
    serve_rules,
)
from apex_tpu_torch.observability.locks import (  # noqa: F401
    TrackedLock,
    lock_order_graph,
    reset_sanitizer,
    sanitizer_report,
)
from apex_tpu_torch.observability.locks import arm as locksan_arm  # noqa: F401
from apex_tpu_torch.observability.locks import (  # noqa: F401
    armed as locksan_armed,
)
from apex_tpu_torch.observability.locks import (  # noqa: F401
    attach_flight as locksan_attach_flight,
)
from apex_tpu_torch.observability.memstats import (  # noqa: F401
    DeviceMemoryProvider,
    FakeMemoryProvider,
    MemStatsMonitor,
    MemStatsRule,
    oom_forensics,
)
from apex_tpu_torch.observability.meter import (  # noqa: F401
    BUCKETS,
    GoodputAccountant,
    StepMeter,
    categorize_op,
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
from apex_tpu_torch.observability.slo import (  # noqa: F401
    SLO,
    BurnRateTracker,
    CounterRatioSLO,
    LatencySLO,
    SLORule,
    Window,
    fleet_slo_rules,
    serve_slo_rules,
)
# the trace() context manager is not re-exported: it would shadow the
# ``trace`` submodule on the package (reach it as ``trace.trace``)
from apex_tpu_torch.observability import trace  # noqa: F401
from apex_tpu_torch.observability.trace import (  # noqa: F401
    TraceScheduler,
    annotate,
    nvtx_range,
    range_pop,
    range_push,
)

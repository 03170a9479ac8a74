"""Step meters — so far only :func:`percentile`.

Counterpart of ``apex_tpu/observability/meter.py``.  The serving
scheduler's TTFT gauges and the chaos drill's artifact take their
percentiles here, so the two agree on the same data.  ``StepMeter``,
``GoodputAccountant`` and the peak tables (the H100's in the port) wait
for ROADMAP item 8.
"""

from __future__ import annotations

__all__ = ["percentile"]


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an already-sorted sequence: the one
    implementation behind the serving TTFT and latency statistics on
    every surface.  Returns NaN on an empty sequence ("no
    measurement")."""
    if not sorted_vals:
        return float("nan")
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]

"""Step meters: wall-clock step time, tokens/s, MFU, and goodput.

Counterpart of ``apex_tpu/observability/meter.py``.

:class:`StepMeter` answers "how fast is this run right now" from the
host side: mark each completed step with :meth:`StepMeter.tick` and read
the step time (median over a sliding window), tokens/s and the
model-FLOPs utilization against the card's dense bf16 peak
(:func:`peak_flops_for`; 6·N·T FLOPs for transformer training,
:func:`transformer_train_flops`).

:class:`GoodputAccountant` answers "how much of that speed is real
progress".  It is fed by :func:`apex_tpu_torch.resilience.run_resilient`'s
``observer`` events and reduces them to ``(accepted -
discarded_by_rollback) / executed_steps``.

:func:`percentile` is the nearest-rank percentile behind the serving
TTFT and latency statistics.

The peak tables hold the H100's public figures (dense bf16 989 TFLOP/s,
TF32 495, f32 67, HBM3 3.35 TB/s, NVLink 4 450 GB/s a direction, 227 KB
of shared memory a CTA may opt into), the ones ``PERF.md`` and
:func:`apex_tpu_torch.analysis.kernels.roofline` compute the bounds
with.  A card the tables do not know raises: an MFU against another
chip's peak would be a wrong number, not a floor.

:func:`categorize_op` buckets an op or a CUDA kernel's name into the
reference's :data:`BUCKETS` (step-time attribution's vocabulary), and
:func:`smem_bytes_for` is the counterpart of the reference's
``vmem_bytes_for``: the on-chip memory a kernel's CTA may take.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

__all__ = [
    "BUCKETS",
    "PEAK_BF16_FLOPS",
    "PEAK_TF32_FLOPS",
    "PEAK_F32_FLOPS",
    "SMEM_BYTES",
    "categorize_op",
    "peak_tf32_flops_for",
    "peak_f32_flops_for",
    "smem_bytes_for",
    "PEAK_HBM_GBPS",
    "PEAK_ICI_GBPS",
    "peak_flops_for",
    "peak_hbm_bandwidth_for",
    "peak_ici_bandwidth_for",
    "chip_peak_flops",
    "total_peak_flops",
    "transformer_train_flops",
    "StepMeter",
    "GoodputAccountant",
    "percentile",
]


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an already-sorted sequence: the one
    implementation behind the serving TTFT and latency statistics on
    every surface.  Returns NaN on an empty sequence ("no
    measurement")."""
    if not sorted_vals:
        return float("nan")
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


#: dense bf16 peak FLOP/s by device name prefix (public specs)
PEAK_BF16_FLOPS = {
    "NVIDIA H100": 989e12,
}

#: dense TF32 tensor-core peak FLOP/s by device name prefix (public specs)
PEAK_TF32_FLOPS = {
    "NVIDIA H100": 495e12,
}

#: f32 (CUDA-core FMA) peak FLOP/s by device name prefix (public specs)
PEAK_F32_FLOPS = {
    "NVIDIA H100": 67e12,
}

#: shared memory a CTA may opt into, by device name prefix (the CUDA
#: programming guide's table for compute capability 9.0)
SMEM_BYTES = {
    "NVIDIA H100": 227 * 1024,
}

#: HBM bytes/s by device name prefix (public specs)
PEAK_HBM_GBPS = {
    "NVIDIA H100": 3.35e12,
}

#: interconnect bytes/s a direction by device name prefix (NVLink 4:
#: 900 GB/s both directions)
PEAK_ICI_GBPS = {
    "NVIDIA H100": 450e9,
}


def _lookup(table: Dict[str, float], device_kind: str, what: str) -> float:
    for key, val in table.items():
        if device_kind.startswith(key):
            return val
    raise ValueError(
        f"no {what} known for device {device_kind!r} (have {sorted(table)})")


def peak_flops_for(device_kind: str) -> float:
    """Dense bf16 peak FLOP/s for a device name
    (``torch.cuda.get_device_name``)."""
    return _lookup(PEAK_BF16_FLOPS, device_kind, "bf16 peak")


def peak_hbm_bandwidth_for(device_kind: str) -> float:
    """HBM bytes/s for a device name (the roofline ceiling)."""
    return _lookup(PEAK_HBM_GBPS, device_kind, "HBM bandwidth")


def peak_ici_bandwidth_for(device_kind: str) -> float:
    """Interconnect bytes/s a direction for a device name."""
    return _lookup(PEAK_ICI_GBPS, device_kind, "interconnect bandwidth")


def peak_tf32_flops_for(device_kind: str) -> float:
    """Dense TF32 tensor-core peak FLOP/s for a device name."""
    return _lookup(PEAK_TF32_FLOPS, device_kind, "TF32 peak")


def peak_f32_flops_for(device_kind: str) -> float:
    """f32 FMA peak FLOP/s for a device name."""
    return _lookup(PEAK_F32_FLOPS, device_kind, "f32 peak")


def smem_bytes_for(device_kind: str) -> int:
    """Shared memory one CTA may opt into on a device name (the
    ``kernel-vmem-overflow`` gate's denominator: the reference's
    ``vmem_bytes_for``)."""
    return int(_lookup(SMEM_BYTES, device_kind, "shared memory"))


# ---------------------------------------------------------------------------
# the bucket model: one op-category vocabulary for attribution
# ---------------------------------------------------------------------------

#: the categories step-time attribution decomposes into (the reference's)
BUCKETS = ("matmul", "attention", "norm_elementwise", "collective", "other")

_COLLECTIVE_HINTS = (
    "all-reduce", "all_reduce", "allreduce", "all-gather", "all_gather",
    "allgather", "reduce-scatter", "reduce_scatter", "reducescatter",
    "all-to-all", "all_to_all", "alltoall", "collective-permute", "nccl",
    "sendrecv", "c10d",
)
#: the port's attention kernels (K3-K6) and PyTorch's own
_ATTENTION_HINTS = (
    "flash", "attention", "attn", "paged_decode", "fmha", "mha",
    "softmax_xent",
)
#: cuBLAS/CUTLASS GEMM kernels and the aten products
_MATMUL_HINTS = (
    "gemm", "cutlass", "xmma", "sm90_", "sm80_", "ampere_", "cublas",
    "matmul", "aten::mm", "aten::bmm", "aten::addmm", "aten::linear",
    "aten.mm.", "aten.bmm.", "aten.addmm.", "aten.baddbmm.", "aten.linear.",
    "dot", "einsum", "conv",
)
_NORM_ELEMENTWISE_HINTS = (
    "ln_fwd", "ln_bwd", "layer_norm", "norm", "softmax", "gelu", "relu",
    "tanh", "sigmoid", "dropout", "bias", "add", "mul", "rope", "rotary",
    "scale", "mean", "var", "rsqrt", "exp", "erf", "elementwise",
    "vectorized", "reduce", "copy", "fill", "cast", "where",
)


def categorize_op(opcode: str, op_name: str = "") -> str:
    """Bucket one op into :data:`BUCKETS` from its op name (an aten op,
    ``custom-call`` for a kernel of the port) and ``op_name`` (a CUDA
    kernel's name from a trace, or a recorded op's scope path).

    Priority: collective > attention > matmul > norm-elementwise > other,
    as the reference's: the attention bucket owns its products."""
    opcode = (opcode or "").lower()
    name = (op_name or "").lower()
    text = f"{opcode} {name}"
    if any(k in text for k in _COLLECTIVE_HINTS):
        return "collective"
    if any(k in text for k in _ATTENTION_HINTS):
        return "attention"
    if any(k in text for k in _MATMUL_HINTS):
        return "matmul"
    if any(k in text for k in _NORM_ELEMENTWISE_HINTS):
        return "norm_elementwise"
    return "other"


def chip_peak_flops(device) -> float:
    """Dense bf16 peak FLOP/s of one CUDA device (a ``torch.device`` or
    an index)."""
    import torch

    return peak_flops_for(torch.cuda.get_device_name(device))


def total_peak_flops(devices=None) -> float:
    """Summed peak over ``devices`` (default: this process's card)."""
    import torch

    if devices is None:
        devices = [torch.cuda.current_device()]
    return sum(chip_peak_flops(d) for d in devices)


def transformer_train_flops(n_params: int, tokens: int) -> float:
    """The 6·N·T training-FLOPs model (BASELINE.md's MFU contract)."""
    return 6.0 * float(n_params) * float(tokens)


class StepMeter:
    """Wall-clock step meter: tick once per completed step.

    The first :meth:`tick` only arms the clock (it closes no interval);
    step time is the median of the last ``window`` intervals, so a
    single stalled step does not poison the rate.  ``peak_flops``
    defaults lazily to this process's card's peak.  A tick reads the
    host clock only: on the card, call it after something that waits
    for the step (a loss read, a synchronize) for device time.
    """

    def __init__(
        self,
        *,
        tokens_per_step: float = 0.0,
        flops_per_step: float = 0.0,
        peak_flops: Optional[float] = None,
        window: int = 32,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.tokens_per_step = float(tokens_per_step)
        self.flops_per_step = float(flops_per_step)
        self._peak_flops = peak_flops
        self._window = window
        self._clock = clock
        self._last: Optional[float] = None
        self._times: list = []
        self.steps = 0  # completed (timed) intervals

    @property
    def peak_flops(self) -> float:
        if self._peak_flops is None:
            self._peak_flops = total_peak_flops()
        return self._peak_flops

    def tick(self) -> Optional[float]:
        """Mark a step boundary; returns the closed interval in seconds
        (None on the arming call)."""
        now = self._clock()
        if self._last is None:
            self._last = now
            return None
        dt = now - self._last
        self._last = now
        self._times.append(dt)
        if len(self._times) > self._window:
            self._times.pop(0)
        self.steps += 1
        return dt

    @property
    def step_time(self) -> float:
        """Median step seconds over the window (0.0 before any tick)."""
        if not self._times:
            return 0.0
        s = sorted(self._times)
        return s[len(s) // 2]

    @property
    def tokens_per_sec(self) -> float:
        t = self.step_time
        return self.tokens_per_step / t if t > 0 else 0.0

    @property
    def mfu(self) -> float:
        t = self.step_time
        if t <= 0 or self.flops_per_step <= 0:
            return 0.0
        return self.flops_per_step / (t * self.peak_flops)

    def summary(self) -> Dict[str, float]:
        return {
            "train/step": float(self.steps),
            "train/step_time_ms": self.step_time * 1e3,
            "train/tokens_per_sec": self.tokens_per_sec,
            "train/mfu": self.mfu,
        }


class GoodputAccountant:
    """Productive-work ledger over ``run_resilient`` observer events.

    Implements the observer protocol of ``run_resilient`` (every method
    optional on other observers): ``on_step`` / ``on_rollback`` /
    ``on_retry`` / ``on_resume`` / ``on_preempt``.  Counting rules:

    - an accepted step is *provisionally* productive;
    - a skipped step is executed-but-wasted;
    - a rollback discards the accepted-but-unsaved steps behind it —
      ``run_resilient`` passes the exact count (it tracks accepted
      steps against actual save results); when an older caller omits
      it, the fallback ``(step - anchor) - skips`` over-charges spans
      containing skip streaks broken by accepted steps, never
      under-charges;
    - a resume after restart only bumps ``resumes`` — work before the
      restart was paid for by a previous process, so charging it here
      would double-count across the job's lifetime.
    """

    def __init__(self):
        self.accepted = 0
        self.skipped = 0
        self.discarded = 0  # accepted steps a rollback threw away
        self.rollbacks = 0
        self.retries = 0
        self.resumes = 0
        self.preempted = False

    # -- observer protocol -------------------------------------------------
    def on_step(self, step: int, skipped: bool, info=None) -> None:
        if skipped:
            self.skipped += 1
        else:
            self.accepted += 1

    def on_rollback(
        self,
        step: int,
        anchor: int,
        skips: int = 0,
        discarded: Optional[int] = None,
    ) -> None:
        self.rollbacks += 1
        if discarded is None:
            # legacy fallback: the replay span minus the final skip
            # streak (an upper bound when the span holds earlier,
            # broken skip streaks)
            discarded = max(0, (step - anchor) - skips)
        self.discarded += discarded

    def on_retry(self, what: str = "", attempt: int = 0, error=None) -> None:
        self.retries += 1

    def on_resume(self, step: int) -> None:
        self.resumes += 1

    def on_preempt(self, step: int) -> None:
        self.preempted = True

    # -- ledger ------------------------------------------------------------
    @property
    def executed(self) -> int:
        return self.accepted + self.skipped

    @property
    def productive(self) -> int:
        return max(0, self.accepted - self.discarded)

    def goodput(self) -> float:
        """Productive fraction of executed steps (1.0 before any work —
        an idle job has wasted nothing yet)."""
        if self.executed == 0:
            return 1.0
        return self.productive / self.executed

    def snapshot(self) -> Dict[str, Any]:
        """The full ledger as plain values — monotonic event counts +
        the derived fractions.  The stable read API for consumers that
        would otherwise reach into fields (the flight recorder's dump,
        fleet aggregation rows, the resilient example's final goodput
        line): one place to keep key names honest."""
        return {
            "accepted": self.accepted,
            "skipped": self.skipped,
            "discarded": self.discarded,
            "rollbacks": self.rollbacks,
            "retries": self.retries,
            "resumes": self.resumes,
            "preempted": self.preempted,
            "executed": self.executed,
            "productive": self.productive,
            "goodput": self.goodput(),
        }

    def summary(self) -> Dict[str, float]:
        return {
            "train/goodput": self.goodput(),
            "train/steps_accepted": float(self.accepted),
            "train/steps_skipped": float(self.skipped),
            "train/steps_discarded": float(self.discarded),
            "train/rollbacks": float(self.rollbacks),
            "train/retries": float(self.retries),
            "train/resumes": float(self.resumes),
        }

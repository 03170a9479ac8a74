"""``apex_tpu_torch.goodput`` — the zero-stall I/O plane between trainer
and host (counterpart of :mod:`apex_tpu.goodput`).

- :mod:`apex_tpu_torch.goodput.async_ckpt` —
  :class:`~apex_tpu_torch.goodput.async_ckpt.AsyncCheckpointEngine`:
  pinned device→host snapshots issued on the step's stream, a background
  writer committing each step atomically, a barrier only at finalize,
  and phase events for the observer.
- :mod:`apex_tpu_torch.goodput.stream` —
  :class:`~apex_tpu_torch.goodput.stream.ResumableStream`: a
  deterministic step-indexed ``batch_fn`` with O(1) seek, device
  prefetch and a checkpointable cursor (:func:`stream_state` /
  :func:`verify_stream_state`), so a resumed run's batches are an
  uninterrupted run's, bit for bit.

``run_resilient`` adopts the engine by default (``checkpoint="async"``).
The engine publishes its ``goodput/ckpt/*`` gauges on the metrics board.
"""

from apex_tpu_torch.goodput.async_ckpt import (  # noqa: F401
    AsyncCheckpointEngine,
    host_snapshot,
    resolve_queue_depth,
)
from apex_tpu_torch.goodput.stream import (  # noqa: F401
    ResumableStream,
    StreamStateError,
    stream_state,
    verify_stream_state,
)

__all__ = [
    "AsyncCheckpointEngine",
    "host_snapshot",
    "resolve_queue_depth",
    "ResumableStream",
    "StreamStateError",
    "stream_state",
    "verify_stream_state",
]

"""Tracing hooks and scheduled profiler windows.

Counterpart of ``apex_tpu/observability/trace.py``.  The annotation half
names regions on the profiler's timelines:

- :func:`annotate` (``torch.profiler.record_function``) names a region
  of the computation; every op and kernel launched inside it lies under
  that span in the trace;
- :func:`nvtx_range` / :func:`range_push` / :func:`range_pop` name a
  span on the host timeline (``torch.cuda.nvtx``; a build without CUDA
  names it through ``record_function`` instead);
- :func:`trace` wraps a block in ``torch.profiler.profile`` (CPU and,
  where there is a card, CUDA activities) and writes a gzipped Chrome
  trace (``*.pt.trace.json.gz``) into ``log_dir``.

The scheduling half, :class:`TraceScheduler`, captures a profile of steps
``N..M`` of a running job without editing the training script::

    APEX_TPU_TRACE_STEPS="1200+3"            # steps 1200..1202
    APEX_TPU_TRACE_STEPS="1200..1205"        # explicit end (inclusive)
    APEX_TPU_TRACE_STEPS="1200+3:/tmp/prof"  # dir override inline
    APEX_TPU_TRACE_DIR=/tmp/prof             # dir the windows land in

and call ``scheduler.on_step(step)`` at the top of each step.  Each window
writes ``<dir>/steps_<start>_<end>/``, where
:func:`~apex_tpu_torch.observability.attribution.attribute_trace_dir`
finds it.
"""

from __future__ import annotations

import contextlib
import os
import re
import socket
import time
from typing import Iterator, List, Optional, Tuple

import torch

__all__ = [
    "annotate",
    "nvtx_range",
    "range_push",
    "range_pop",
    "trace",
    "start_trace",
    "stop_trace",
    "parse_trace_spec",
    "window_dir",
    "TraceScheduler",
    "ENV_TRACE_STEPS",
    "ENV_TRACE_DIR",
]

ENV_TRACE_STEPS = "APEX_TPU_TRACE_STEPS"
ENV_TRACE_DIR = "APEX_TPU_TRACE_DIR"
DEFAULT_TRACE_DIR = "/tmp/apex_tpu_trace"

# module-level stack for the push/pop API (host-side spans, NVTX-style)
_RANGE_STACK: List[contextlib.AbstractContextManager] = []

#: the profiler :func:`start_trace` started and :func:`stop_trace` closes,
#: with the directory it writes to
_ACTIVE: Optional[Tuple[torch.profiler.profile, str]] = None


def annotate(name: str):
    """Name a region of the computation (``record_function``): the ops
    and kernel launches inside it lie under the span in the trace."""
    return torch.profiler.record_function(name)


def _host_range(name: str) -> contextlib.AbstractContextManager:
    if torch.cuda.is_available():
        return torch.cuda.nvtx.range(name)
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def nvtx_range(name: str) -> Iterator[None]:
    """Host-timeline span (``torch.cuda.nvtx.range``)."""
    with _host_range(name):
        yield


def range_push(name: str) -> None:
    """``torch.cuda.nvtx.range_push``: begin a host-timeline span."""
    cm = _host_range(name)
    cm.__enter__()
    _RANGE_STACK.append(cm)


def range_pop() -> None:
    """``torch.cuda.nvtx.range_pop``: end the innermost span."""
    if not _RANGE_STACK:
        raise RuntimeError("range_pop() without matching range_push()")
    _RANGE_STACK.pop().__exit__(None, None, None)


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace(log_dir: str) -> None:
    """Start collecting a host and device profile for ``log_dir``
    (written by :func:`stop_trace`)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a profiler trace is already running")
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    _ACTIVE = (prof, log_dir)


def stop_trace() -> Optional[str]:
    """Stop the running profile and write it as
    ``<log_dir>/<host>_<pid>.<ms>.pt.trace.json.gz``; returns the path."""
    global _ACTIVE
    if _ACTIVE is None:
        raise RuntimeError("stop_trace() without a running trace")
    prof, log_dir = _ACTIVE
    _ACTIVE = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(
        log_dir, f"{socket.gethostname()}_{os.getpid()}."
        f"{int(time.time() * 1e3)}.pt.trace.json.gz")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Collect a host and device profile into ``log_dir`` (Perfetto and
    ``chrome://tracing`` read it).  Wrap a steady-state window, not the
    kernels' first build."""
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


def parse_trace_spec(spec: str) -> Tuple[int, int, Optional[str]]:
    """``(start, end_inclusive, dir_override)`` from a spec string.

    Accepted: ``"N"`` (one step), ``"N+K"`` (K steps from N),
    ``"N..M"`` (inclusive), each optionally followed by ``:DIR``.
    """
    spec = spec.strip()
    dir_override = None
    m = re.match(r"^([^:]+):(.+)$", spec)
    if m:
        spec, dir_override = m.group(1).strip(), m.group(2).strip()
    m = re.match(r"^(\d+)\s*(?:(\+|\.\.)\s*(\d+))?$", spec)
    if not m:
        raise ValueError(
            f"bad {ENV_TRACE_STEPS} spec {spec!r}; want 'N', 'N+K', "
            "or 'N..M' (optionally ':DIR')"
        )
    start = int(m.group(1))
    if m.group(2) is None:
        end = start
    elif m.group(2) == "+":
        k = int(m.group(3))
        if k < 1:
            raise ValueError(f"window length must be >= 1, got {k}")
        end = start + k - 1
    else:
        end = int(m.group(3))
    if end < start:
        raise ValueError(f"trace window ends ({end}) before it starts ({start})")
    return start, end, dir_override


def window_dir(base_dir: str, start: int, end: int) -> str:
    """The per-window directory: ``<base>/steps_<start>_<end>``."""
    return os.path.join(base_dir, f"steps_{start:06d}_{end:06d}")


class TraceScheduler:
    """Arm a profile window on a step schedule — env-driven by default.

    >>> sched = TraceScheduler()        # reads APEX_TPU_TRACE_STEPS
    >>> for step in range(num_steps):
    ...     sched.on_step(step)         # starts/stops the window
    ...     run_one_step()
    >>> sched.stop()                    # safety net past the last step

    With no spec configured every call is a cheap no-op.  The profiler
    collects from the ``on_step(start)`` call until the
    ``on_step(end + 1)`` call, i.e. steps ``start..end`` inclusive.
    A step that moves BACKWARD mid-window (a resilience rollback
    replaying from a checkpoint) aborts the capture and re-arms: the
    partial file would mix the restore with replayed earlier steps, so
    the window is taken cleanly on the replay pass instead (the newest
    file in the window dir is the good one, which
    :func:`~apex_tpu_torch.observability.attribution.load_trace_dir`
    reads).  A capture only ever begins at exactly ``start``: a resume
    or replay that lands INSIDE the window would produce a partial
    capture labelled with the full range, so it never triggers.
    """

    def __init__(
        self,
        spec: Optional[str] = None,
        base_dir: Optional[str] = None,
        *,
        spans=None,
        _start_fn=None,
        _stop_fn=None,
    ):
        #: optional :class:`~apex_tpu_torch.observability.spans.SpanRecorder`
        #: — each captured window records a ``trace/window`` span, so
        #: profile artifacts locate themselves on the merged timeline
        self.spans = spans
        self._capture_t0 = None
        spec = spec if spec is not None else os.environ.get(ENV_TRACE_STEPS)
        self.start = self.end = None
        dir_override = None
        if spec:
            self.start, self.end, dir_override = parse_trace_spec(spec)
        self.base_dir = (
            dir_override
            or base_dir
            or os.environ.get(ENV_TRACE_DIR, DEFAULT_TRACE_DIR)
        )
        self.log_dir = (
            window_dir(self.base_dir, self.start, self.end)
            if self.start is not None
            else None
        )
        self._tracing = False
        self._done = False
        self._prev_step = None
        # injectable for tests; default to the real profiler
        self._start_fn = _start_fn or start_trace
        self._stop_fn = _stop_fn or stop_trace

    @property
    def active(self) -> bool:
        """True when a window is configured and not yet captured."""
        return self.start is not None and not self._done

    def arm(self, start: int, length: int = 1,
            base_dir: Optional[str] = None) -> None:
        """(Re-)arm a window of ``length`` steps from ``start`` at run
        time — the escalation hook a health ``on_unhealthy`` callback
        uses to turn an alert into a profile in the same run.  An
        in-flight capture is closed first; a window already armed for a
        *future* start is left alone (first alert wins)."""
        if length < 1:
            raise ValueError(f"window length must be >= 1, got {length}")
        if self.active and (
            self._prev_step is None or self.start > self._prev_step
        ):
            return
        if self._tracing:
            self._abort("rearm")
        self.start, self.end = int(start), int(start) + length - 1
        if base_dir is not None:
            self.base_dir = base_dir
        self.log_dir = window_dir(self.base_dir, self.start, self.end)
        self._done = False

    @property
    def tracing(self) -> bool:
        return self._tracing

    def on_step(self, step: int) -> None:
        """Call at the TOP of every step (before dispatching its work)."""
        if not self.active:
            return
        rewound = self._prev_step is not None and step <= self._prev_step
        self._prev_step = step
        if self._tracing:
            if rewound:
                # rollback replay mid-window: abort and re-arm — the
                # replay pass recaptures the window cleanly
                self._abort("rollback")
            elif step > self.end:
                self._finish()
        # only ever start at exactly `start`: beginning mid-window would
        # write a partial capture under a dir named for the full range
        if not self._tracing and not self._done and step == self.start:
            os.makedirs(self.log_dir, exist_ok=True)
            self._start_fn(self.log_dir)
            self._tracing = True
            if self.spans is not None:
                self._capture_t0 = self.spans.now()

    def _abort(self, reason: str) -> None:
        """Close an in-flight capture WITHOUT marking the window done
        (it re-arms).  The partial artifacts exist on disk, so the
        window span is still recorded, marked ``aborted``."""
        self._stop_fn()
        self._tracing = False
        if self.spans is not None and self._capture_t0 is not None:
            self.spans.trace_window(
                self.start, self.end, self._capture_t0,
                self.spans.now(), log_dir=self.log_dir, aborted=reason,
            )
            self._capture_t0 = None

    def _finish(self) -> None:
        self._stop_fn()
        self._tracing = False
        self._done = True
        if self.spans is not None and self._capture_t0 is not None:
            self.spans.trace_window(
                self.start, self.end, self._capture_t0,
                self.spans.now(), log_dir=self.log_dir,
            )
            self._capture_t0 = None

    def stop(self) -> None:
        """Close an in-flight window (end of training / teardown)."""
        if self._tracing:
            self._finish()

"""Structured span recorder — the per-request / per-step causal record.

Counterpart of ``apex_tpu/observability/spans.py``, host code copied
over.  :class:`SpanRecorder` is a bounded ring of **spans** (named
intervals) and **instants** (point events) on a few stable tracks:

- recording is one dict append into a bounded ``deque``: no
  formatting, no IO, no device contact;
- timestamps are ``time.monotonic()``; the process's monotonic→epoch
  offset is captured once (:func:`wall_clock_anchor`) and written into
  span and flight dumps;
- serve requests walk the validated state machine ``queued → admitted
  → prefill → decode[i] → retrying → done | shed(reason)`` (an illegal
  transition or a timestamp running backwards raises ``ValueError``);
  every request span carries the request id as its ``lane``, and its
  decode span the engine iterations it rode (``first_iter`` /
  ``last_iter``);
- training steps, rollbacks, resumes, retries, checkpoints and
  preemption come from the ``run_resilient`` observer protocol.

Armed explicitly (``SpanRecorder()`` handed to the scheduler or to
``run_resilient``) or by ``APEX_TPU_SPANS=N[:DIR]`` inside any
``run_resilient`` loop.  The default directory is ``apex_tpu_spans``
under the temporary directory (``$TMPDIR``).
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "ENV_SPANS",
    "DEFAULT_SPANS_DIR",
    "DEFAULT_CAPACITY",
    "TRACK_REQUESTS",
    "TRACK_ENGINE",
    "TRACK_TRAIN",
    "TRACK_HEALTH",
    "TRACK_TRACE",
    "REQ_QUEUED",
    "REQ_ROUTED",
    "REQ_PREFILL",
    "REQ_DECODE",
    "REQ_RETRYING",
    "REQ_DONE",
    "REQ_SHED",
    "REQ_TERMINAL",
    "wall_clock_anchor",
    "monotonic_to_epoch",
    "SpanRecorder",
]

ENV_SPANS = "APEX_TPU_SPANS"
DEFAULT_SPANS_DIR = os.path.join(tempfile.gettempdir(), "apex_tpu_spans")
DEFAULT_CAPACITY = 4096

# -- track names (one Perfetto track per source) ----------------------------
TRACK_REQUESTS = "serve/requests"
TRACK_ENGINE = "serve/engine"
TRACK_TRAIN = "train"
TRACK_HEALTH = "health"
TRACK_TRACE = "trace"

# -- request lifecycle vocabulary -------------------------------------------
REQ_QUEUED = "queued"
#: fleet routing phase (the reference's ``fleetctl``): the request is in the
#: router's hands between replicas — on first submission (the router
#: picks a replica before the replica queues it) and on every
#: re-route after a drain handoff, replica crash, or preemption (the
#: span's ``replica`` arg names the destination)
REQ_ROUTED = "routed"
REQ_PREFILL = "prefill"
REQ_DECODE = "decode"
REQ_RETRYING = "retrying"
REQ_DONE = "done"
REQ_SHED = "shed"
REQ_TERMINAL = frozenset({REQ_DONE, REQ_SHED})

#: legal lifecycle transitions — anything else is an out-of-order event
#: and raises.  ``queued → prefill`` is the admission edge (the
#: recorder emits a ``req/admitted`` instant on it); a request can be
#: shed from any live phase but can never leave a terminal one.
#: ``retrying`` is the fault-recovery phase (the scheduler's
#: retries): a prefill/decode fault sends the request back through
#: bounded re-admission with its pages and generated prefix retained —
#: it can only re-enter through ``prefill``/``decode`` or be shed; it
#: can never complete straight from ``retrying`` (``retrying → done``
#: would claim tokens no decode produced), and a terminal ``shed``
#: can never be re-admitted (``shed → decode`` raises — recovery must
#: go through an explicit re-submission, a NEW request id).
#: ``routed`` is the fleet-router phase: it brackets the hop between
#: replicas (first submission, drain handoff, crash/preempt
#: evacuation).  A routed request can only be queued on its target
#: replica or shed by the router; ``queued``/``retrying`` can re-enter
#: ``routed`` (a re-route), but a request mid-``prefill``/``decode``
#: cannot — it must pass through ``retrying`` first (the re-route IS a
#: fault recovery and must be charged against the retry budget).
_REQ_TRANSITIONS: Dict[Optional[str], frozenset] = {
    None: frozenset({REQ_QUEUED, REQ_ROUTED}),
    REQ_ROUTED: frozenset({REQ_QUEUED, REQ_SHED}),
    REQ_QUEUED: frozenset({REQ_PREFILL, REQ_SHED, REQ_ROUTED}),
    REQ_PREFILL: frozenset({REQ_DECODE, REQ_DONE, REQ_SHED, REQ_RETRYING}),
    REQ_DECODE: frozenset({REQ_DONE, REQ_SHED, REQ_RETRYING}),
    REQ_RETRYING: frozenset({REQ_PREFILL, REQ_DECODE, REQ_SHED, REQ_ROUTED}),
}


_ANCHOR: Optional[Dict[str, float]] = None


def wall_clock_anchor() -> Dict[str, Any]:
    """The process's monotonic→epoch anchor, captured ONCE.

    ``epoch - monotonic`` is the offset that converts any
    ``time.monotonic()`` timestamp taken in this process to wall-clock
    epoch seconds.  Capturing it once (instead of stamping every event
    with ``time.time()``) keeps recording cheap and makes every
    artifact from one process share one consistent offset — the
    property multi-host merge relies on.
    """
    global _ANCHOR
    if _ANCHOR is None:
        m = time.monotonic()
        e = time.time()
        _ANCHOR = {"monotonic": m, "epoch": e, "pid": os.getpid()}
    return dict(_ANCHOR)


def monotonic_to_epoch(t: float) -> float:
    """Epoch seconds for a ``time.monotonic()`` timestamp ``t``."""
    a = wall_clock_anchor()
    return float(t) - a["monotonic"] + a["epoch"]


def parse_spans_spec(spec: str) -> Tuple[int, Optional[str]]:
    """``(capacity, dir_override)`` from an ``APEX_TPU_SPANS`` value —
    the ``"N"`` / ``"N:DIR"`` grammar the flight recorder uses."""
    from apex_tpu_torch.observability.flight import ENV_FLIGHT, parse_flight_spec

    try:
        return parse_flight_spec(spec)
    except ValueError as e:
        # same grammar, right env name in the error
        raise ValueError(str(e).replace(ENV_FLIGHT, ENV_SPANS)) from None


class SpanRecorder:
    """Bounded ring of spans + instants with a request state machine.

    Generic surface::

        rec.span("engine/decode", t0, t1, track=TRACK_ENGINE, iter=7)
        rec.instant("train/rollback", t, track=TRACK_TRAIN, step=120)

    Request lifecycle surface (validated)::

        rec.request_event(rid, REQ_QUEUED, t_submit, prompt_tokens=16)
        rec.request_event(rid, REQ_PREFILL, t_admit, bucket=32)
        rec.request_event(rid, REQ_DECODE, t_first, ttft_ms=..., ...)
        rec.request_event(rid, REQ_DONE, t_done, tokens=8)

    Each lifecycle event *closes* the previous phase as a span named
    ``req/<phase>`` on :data:`TRACK_REQUESTS` (lane = request id) —
    args given at the phase's open and close merge onto that span —
    and terminal events additionally emit a ``req/done`` / ``req/shed``
    instant carrying the terminal args (``reason=...`` for sheds).

    Implements the ``run_resilient`` observer protocol (``on_step`` /
    ``on_rollback`` / ``on_resume`` / ``on_preempt`` / ``on_retry`` /
    ``on_checkpoint``) so training runs record per-step spans by adding
    the recorder to the observer fan-out — or by env,
    ``APEX_TPU_SPANS=N[:DIR]`` (see :meth:`from_env`).
    """

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        directory: Optional[str] = None,
        *,
        run: Optional[Dict[str, Any]] = None,
        clock=time.monotonic,
    ):
        if capacity < 1:
            raise ValueError("span capacity must be >= 1")
        self.capacity = int(capacity)
        self.directory = directory or os.environ.get(
            ENV_SPANS + "_DIR", DEFAULT_SPANS_DIR
        )
        self.run = dict(run or {})
        self.clock = clock
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0
        self._appended = 0
        # rid -> (state, t_opened, open_args)
        self._open_req: Dict[Any, Tuple[str, float, Dict[str, Any]]] = {}
        # observer-bridge state
        self._step_tick: Optional[float] = None
        self._prev_step: Optional[int] = None
        #: True while a canary deploy window is open — the only time a
        #: ``canary=...`` routing annotation is legal
        self._deploy_window = False
        self.dumps: List[str] = []

    @classmethod
    def from_env(cls, spec: Optional[str] = None, **kwargs):
        """A recorder armed by ``APEX_TPU_SPANS=N[:DIR]``, or ``None``
        when the env is unset/empty/``0``."""
        spec = spec if spec is not None else os.environ.get(ENV_SPANS)
        if not spec:
            return None
        capacity, dir_override = parse_spans_spec(spec)
        if capacity == 0:
            return None
        if dir_override:
            kwargs["directory"] = dir_override
        return cls(capacity, **kwargs)

    # -- core recording ----------------------------------------------------
    def now(self) -> float:
        return self.clock()

    def _append(self, entry: Dict[str, Any]) -> None:
        entry["seq"] = self._seq
        self._seq += 1
        self._appended += 1
        self._ring.append(entry)

    def span(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        track: str = TRACK_TRAIN,
        lane=None,
        **args,
    ) -> None:
        """Record a completed interval.  ``t1 < t0`` raises — a span
        that ends before it starts is corrupt evidence, not data."""
        t0, t1 = float(t0), float(t1)
        if t1 < t0:
            raise ValueError(
                f"span {name!r} ends before it starts: t0={t0} t1={t1}"
            )
        entry: Dict[str, Any] = {
            "name": name, "track": track, "t0": t0, "t1": t1,
        }
        if lane is not None:
            entry["lane"] = lane
        if args:
            entry["args"] = args
        self._append(entry)

    def instant(
        self, name: str, t: float, *, track: str = TRACK_TRAIN,
        lane=None, **args,
    ) -> None:
        """Record a point event."""
        entry: Dict[str, Any] = {"name": name, "track": track,
                                 "t": float(t)}
        if lane is not None:
            entry["lane"] = lane
        if args:
            entry["args"] = args
        self._append(entry)

    # -- request lifecycle -------------------------------------------------
    def request_event(self, rid, state: str, t: Optional[float] = None,
                      **args) -> None:
        """Advance request ``rid``'s lifecycle to ``state`` at time
        ``t`` (defaults to :meth:`now`).  Illegal transitions and
        backwards timestamps raise ``ValueError`` loudly."""
        t = self.now() if t is None else float(t)
        if "canary" in args:
            # the canary routing annotation is part of the exposure
            # PROOF (timeline --json re-derives the bound from these
            # spans), so it is validated like a state transition: only
            # a routing hop can carry it, and only while a deploy
            # window is open — a canary tag outside a window would be
            # unfalsifiable noise
            if state != REQ_ROUTED:
                raise ValueError(
                    f"canary annotation on {state!r} event for "
                    f"rid={rid}: only {REQ_ROUTED!r} hops carry it"
                )
            if not self._deploy_window:
                raise ValueError(
                    f"canary annotation for rid={rid} outside a "
                    f"deploy window (begin_deploy_window not open)"
                )
        cur = self._open_req.get(rid)
        cur_state = cur[0] if cur is not None else None
        allowed = _REQ_TRANSITIONS.get(cur_state, frozenset())
        if state not in allowed:
            raise ValueError(
                f"out-of-order request event: rid={rid} "
                f"{cur_state!r} -> {state!r} "
                f"(allowed: {sorted(allowed) or 'none — terminal'})"
            )
        if cur is not None:
            _, t_open, open_args = cur
            if t < t_open:
                raise ValueError(
                    f"out-of-order request timestamp: rid={rid} "
                    f"{state!r} at t={t} before {cur_state!r} opened "
                    f"at t={t_open}"
                )
            merged = dict(open_args)
            merged.update(args)
            self.span(
                f"req/{cur_state}", t_open, t,
                track=TRACK_REQUESTS, lane=rid, **merged,
            )
            if cur_state == REQ_QUEUED and state == REQ_PREFILL:
                # the admission edge — keep the vocabulary's explicit
                # "admitted" marker without a separate scheduler call
                self.instant(
                    "req/admitted", t, track=TRACK_REQUESTS, lane=rid
                )
        if state in REQ_TERMINAL:
            self.instant(
                f"req/{state}", t, track=TRACK_REQUESTS, lane=rid, **args
            )
            self._open_req.pop(rid, None)
        else:
            self._open_req[rid] = (state, t, dict(args))

    @property
    def open_requests(self) -> Dict[Any, str]:
        """``{rid: current_phase}`` for requests not yet terminal."""
        return {rid: st for rid, (st, _, _) in self._open_req.items()}

    # -- canary deploy windows ---------------------------------------------
    def begin_deploy_window(self, t: Optional[float] = None, *,
                            canary: str, frac: float) -> None:
        """Open a canary deploy window: emits a
        ``fleet/deploy_window_open`` instant on :data:`TRACK_HEALTH`
        carrying the canary replica's name + its router load-share
        ceiling, and arms the ``canary`` routing-annotation validator.
        A timeline tool pairs open/close markers into
        windows and re-proves the exposure bound per-request from the
        annotated ``req/routed`` spans inside them."""
        if self._deploy_window:
            raise RuntimeError(
                "begin_deploy_window: a deploy window is already open "
                "(one canary at a time per recorder)"
            )
        self._deploy_window = True
        self.instant(
            "fleet/deploy_window_open",
            self.now() if t is None else float(t),
            track=TRACK_HEALTH, canary=str(canary), frac=float(frac),
        )

    def end_deploy_window(self, t: Optional[float] = None, *,
                          verdict: str) -> None:
        """Close the open deploy window with its verdict (``"pass"`` /
        ``"fail"`` / ``"inconclusive"``)."""
        if not self._deploy_window:
            raise RuntimeError(
                "end_deploy_window: no deploy window is open"
            )
        self._deploy_window = False
        self.instant(
            "fleet/deploy_window_close",
            self.now() if t is None else float(t),
            track=TRACK_HEALTH, verdict=str(verdict),
        )

    @property
    def deploy_window_open(self) -> bool:
        return self._deploy_window

    # -- run_resilient observer bridge -------------------------------------
    def on_step(self, step: int, skipped: bool = False, info=None) -> None:
        """One ``train/step`` span per completed step interval (the
        first call only sets the baseline tick — the recorder cannot
        know when step 0 started)."""
        now = self.now()
        step = int(step)
        if self._step_tick is not None:
            span_args: Dict[str, Any] = {
                "step": step, "skipped": bool(skipped),
            }
            if self._prev_step is not None and step <= self._prev_step:
                # a rollback replay rewound the counter — mark it, the
                # timeline must render the rewind, not hide it
                span_args["replay"] = True
            self.span(
                "train/step", self._step_tick, now,
                track=TRACK_TRAIN, **span_args,
            )
        self._step_tick = now
        self._prev_step = step

    def on_rollback(self, step: int, anchor: int, skips: int = 0,
                    discarded: Optional[int] = None) -> None:
        self.instant(
            "train/rollback", self.now(), track=TRACK_TRAIN,
            step=int(step), anchor=int(anchor), skips=int(skips),
            discarded=None if discarded is None else int(discarded),
        )

    def on_resume(self, step: int) -> None:
        self.instant(
            "train/resume", self.now(), track=TRACK_TRAIN, step=int(step)
        )

    def on_preempt(self, step: int) -> None:
        self.instant(
            "train/preempt", self.now(), track=TRACK_TRAIN, step=int(step)
        )

    def on_retry(self, what: str = "", attempt: int = 0, error=None) -> None:
        self.instant(
            "train/retry", self.now(), track=TRACK_TRAIN,
            what=str(what), attempt=int(attempt),
            error=None if error is None else
            f"{type(error).__name__}: {error}",
        )

    def on_checkpoint(self, step: int, info=None) -> None:
        """A checkpoint event.  Bare (``info=None``): the enqueue
        instant, as before.  With ``info`` (an async-engine phase
        record — ``run_resilient`` forwards
        :meth:`apex_tpu_torch.goodput.AsyncCheckpointEngine.drain_events`):
        the completed phase lands as a real interval on the train
        track — ``ckpt/snapshot`` + ``ckpt/write`` for a background
        write, ``ckpt/finalize`` for a drain barrier — so the Perfetto
        timeline shows checkpoint I/O overlapping the steps it ran
        under."""
        step = -1 if step is None else int(step)
        if info is None:
            self.instant(
                "train/checkpoint", self.now(), track=TRACK_TRAIN,
                step=step,
            )
            return
        phase = info.get("phase", "write")
        if phase == "write":
            s0, s1 = info.get("snapshot_t0"), info.get("snapshot_t1")
            if s0 is not None and s1 is not None:
                self.span(
                    "ckpt/snapshot", s0, s1, track=TRACK_TRAIN, step=step,
                )
            self.span(
                "ckpt/write", info["t0"], info["t1"], track=TRACK_TRAIN,
                step=step, ok=bool(info.get("ok", True)),
            )
        else:
            self.span(
                f"ckpt/{phase}", info["t0"], info["t1"],
                track=TRACK_TRAIN, step=step,
            )

    def note_health(self, event) -> None:
        """Record a :class:`~apex_tpu_torch.observability.health.HealthEvent`
        on the health track (same shape the flight recorder logs)."""
        self.instant(
            f"health/{event.rule}", self.now(), track=TRACK_HEALTH,
            severity=event.severity, step=int(event.step),
            value=event.value, threshold=event.threshold,
            message=event.message, host=event.host,
        )

    def trace_window(self, start_step: int, end_step: int,
                     t0: float, t1: float,
                     log_dir: Optional[str] = None,
                     aborted: Optional[str] = None) -> None:
        """A profiler window (the reference's ``TraceScheduler``) — so on-chip profile artifacts locate
        themselves on the same timeline.  ``aborted`` names why a
        capture was closed early (a rollback rewind, a watchdog
        re-arm): the partial artifacts still exist in ``log_dir`` and
        the span says exactly how far they cover."""
        args: Dict[str, Any] = {
            "start_step": int(start_step), "end_step": int(end_step),
            "log_dir": log_dir,
        }
        if aborted is not None:
            args["aborted"] = str(aborted)
        self.span("trace/window", t0, t1, track=TRACK_TRACE, **args)

    # -- introspection / export --------------------------------------------
    @property
    def dropped(self) -> int:
        """Entries the ring evicted (0 means the record is complete)."""
        return self._appended - len(self._ring)

    def snapshot(self) -> List[Dict[str, Any]]:
        return [dict(e) for e in self._ring]

    def header(self) -> Dict[str, Any]:
        from apex_tpu_torch.parallel import multihost

        host = {"id": multihost.host_id(), "count": multihost.host_count()}
        return {
            "version": 1,
            "kind": "apex_tpu_spans",
            "anchor": wall_clock_anchor(),
            "host": host,
            "capacity": self.capacity,
            "dropped": self.dropped,
            "run": self.run,
        }

    def dump(self, reason: str = "", path: Optional[str] = None,
             directory: Optional[str] = None) -> str:
        """Write the span record atomically (tmp + ``os.replace``) and
        return the path.  ``path`` names the file exactly; otherwise a
        ``spans_<ts>_<pid>.json`` lands in ``directory`` (default: the
        recorder's)."""
        if path is None:
            directory = directory or self.directory
            os.makedirs(directory, exist_ok=True)
            ts = time.strftime("%Y%m%d_%H%M%S")
            path = os.path.join(
                directory, f"spans_{ts}_{os.getpid()}_{self._seq}.json"
            )
        else:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
        payload = dict(self.header())
        payload["reason"] = str(reason)
        payload["open_requests"] = {
            str(rid): st for rid, st in self.open_requests.items()
        }
        payload["spans"] = self.snapshot()
        # the flight recorder's non-finite encoding ("NaN"/"Infinity"
        # strings): a NaN health value is evidence, and a bare NaN
        # token is invalid JSON
        from apex_tpu_torch.observability.flight import json_safe

        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(json_safe(payload), f, indent=1, allow_nan=False)
            f.write("\n")
        os.replace(tmp, path)
        self.dumps.append(path)
        return path

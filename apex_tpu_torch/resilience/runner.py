"""Preemption-safe auto-resume training loop.

Counterpart of ``apex_tpu/resilience/runner.py``, host code copied over.
:func:`run_resilient` composes the resilience stack into the loop a
production job runs:

- **auto-resume** — on startup, ``latest_step()`` of the checkpoint
  directory decides where training continues; a fresh directory starts
  at step 0.  An interrupted save is invisible to ``latest_step`` (the
  commit-marker rule of :mod:`apex_tpu_torch.checkpoint`).
- **guarded steps** — the caller's ``step_fn`` reports whether the step
  was skipped; after ``rollback_after`` consecutive skips the loop
  restores the last checkpoint and replays.
- **preemption** — SIGTERM sets a flag via :class:`PreemptionHandler`;
  the loop finishes the in-flight step, writes a final checkpoint, and
  returns with ``preempted=True``.
- **retries** — checkpoint I/O goes through
  :class:`ResilientCheckpointManager` (retry + the chaos
  ``CHECKPOINT_SAVE`` / ``CHECKPOINT_RESTORE`` sites).

``step_fn(state, batch) -> (state, info)`` with ``info`` anything that
has a ``skipped`` entry/attribute (or None); ``batch_fn(step) -> batch``
is indexed by step.  A state of tensors is restored **in place** into
the tensors of the state the loop holds (the checkpoint's template), so
a ``step_fn`` that updates a model's parameters in place resumes them.

The loop narrates itself to an optional duck-typed ``observer``:
``on_step(step, skipped, info)``, ``on_rollback(step, anchor, skips,
discarded)``, ``on_resume(step)``, ``on_preempt(step)``,
``on_checkpoint(step)`` when a save is enqueued and ``on_checkpoint(step,
info)`` when the async engine's write or finalize completes, and
``on_retry(what, attempt, error)``.  ``discarded`` is the exact count of
accepted-but-unsaved steps a rollback threw away.  ``flight=`` and
``spans=`` take recorders with the same protocol plus ``dump(reason)``;
when they are None, ``APEX_TPU_FLIGHT=N[:DIR]`` and
``APEX_TPU_SPANS=N[:DIR]`` arm a
:class:`~apex_tpu_torch.observability.flight.FlightRecorder` and a
:class:`~apex_tpu_torch.observability.spans.SpanRecorder` from the
environment.  The
pre-preemption barrier is ``parallel.multihost.host_barrier`` (the chaos
``COLLECTIVE`` site, and a ``torch.distributed`` barrier when the
process is in a group).
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Any, Callable, NamedTuple, Optional, Tuple

from apex_tpu_torch.checkpoint import CheckpointManager
from apex_tpu_torch.resilience import chaos
from apex_tpu_torch.resilience import retry as _retry
from apex_tpu_torch.resilience.retry import RetryPolicy, retry_call

__all__ = [
    "PreemptionHandler",
    "ResilientCheckpointManager",
    "ObserverFanout",
    "RunResult",
    "run_resilient",
]


class PreemptionHandler:
    """Context manager turning SIGTERM into a queryable flag.

    The handler only records the request (async-signal-safe); the training
    loop decides when to act — after the in-flight step, before the next.
    Outside the main thread (where CPython forbids ``signal.signal``) it
    degrades to a never-set flag instead of failing.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = signals
        self._prev = {}
        self._event = threading.Event()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def _on_signal(self, signum, frame):
        self._event.set()

    def __enter__(self):
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()


class ResilientCheckpointManager:
    """Checkpoint engine + retry + chaos, behind one manager surface.

    ``engine="async"`` (the default) rides the
    :class:`apex_tpu_torch.goodput.AsyncCheckpointEngine` —
    copy-on-snapshot to host, background write, barrier only at
    finalize — so the step path never pays the write.  ``engine="sync"``
    keeps :class:`apex_tpu_torch.checkpoint.CheckpointManager`, which
    writes on the calling thread; its saves get the same
    **copy-on-snapshot isolation** here (the state is host-snapshotted
    ONCE before the write, outside the retries).

    Save/restore I/O errors are retried per ``policy`` and only then
    raised.  The chaos ``partial`` save mode drops orbax-style
    uncommitted debris (``<step>.orbax-checkpoint-tmp-*``) into the
    directory before failing — the on-disk shape of a host that died
    mid-write — which is exactly what ``latest_step`` must ignore.

    Scope note: on the async engine ``save`` returns after the
    enqueue, so the retry here covers the enqueue path (plus any
    deferred background-write error surfaced at the next ``save`` call;
    retrying that call clears the stale error and re-queues the current
    step).  A background write that fails permanently loses that one
    step's checkpoint, never crash consistency: the incomplete step
    stays invisible to ``latest_step`` and resume falls back one
    interval.
    """

    def __init__(
        self,
        directory,
        *,
        max_to_keep: Optional[int] = None,
        save_interval_steps: int = 1,
        policy: Optional[RetryPolicy] = None,
        engine: str = "async",
    ):
        self._directory = os.path.abspath(os.fspath(directory))
        if engine == "async":
            from apex_tpu_torch.goodput import AsyncCheckpointEngine

            self._inner = AsyncCheckpointEngine(
                self._directory,
                max_to_keep=max_to_keep,
                save_interval_steps=save_interval_steps,
            )
        elif engine == "sync":
            self._inner = CheckpointManager(
                self._directory,
                max_to_keep=max_to_keep,
                save_interval_steps=save_interval_steps,
            )
        else:
            raise ValueError(
                f"engine must be 'async' or 'sync', got {engine!r}"
            )
        #: which save engine backs this manager ("async" | "sync") —
        #: run_resilient keys its durability bookkeeping on it
        self.engine = engine
        self._policy = policy or RetryPolicy(backoff=0.05, max_backoff=1.0)

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._inner.close()

    def wait_until_finished(self):
        self._inner.wait_until_finished()

    # -- delegated queries -------------------------------------------------
    def latest_step(self) -> Optional[int]:
        return self._inner.latest_step()

    def all_steps(self):
        return self._inner.all_steps()

    def should_save(self, step: int) -> bool:
        return self._inner.should_save(step)

    # -- guarded io --------------------------------------------------------
    def drain_events(self):
        """Completed checkpoint phase events (async engine only; [] on
        sync) — ``run_resilient`` forwards them to ``on_checkpoint``."""
        drain = getattr(self._inner, "drain_events", None)
        return drain() if drain is not None else []

    def stats(self):
        """The async engine's cumulative ledger ({} on sync)."""
        stats = getattr(self._inner, "stats", None)
        return stats() if stats is not None else {}

    def save(self, step: int, state, *, force: bool = False) -> bool:
        if self.engine == "sync" and (
            force or self._inner.should_save(step)
        ):
            # copy-on-snapshot for the sync path too (the async engine
            # snapshots internally, inside its own stall accounting):
            # the write must never read live caller buffers.
            # Gated on the interval policy: run_resilient calls save on
            # every accepted step, and paying a full host copy of the
            # state on interval-skipped steps would be a step-path
            # stall, not isolation.  ONE snapshot, outside the retry
            # closure: retries re-use it.
            from apex_tpu_torch.goodput import host_snapshot

            state = host_snapshot(state)

        def _save():
            chaos.maybe_fail(
                chaos.CHECKPOINT_SAVE, step, partial_dir=self._directory
            )
            return self._inner.save(step, state, force=force)

        return retry_call(
            _save,
            policy=self._policy,
            describe=f"checkpoint save (step {step})",
        )

    def restore(self, step: Optional[int] = None, *, template=None):
        def _restore():
            chaos.maybe_fail(
                chaos.CHECKPOINT_RESTORE,
                step if step is not None else (self.latest_step() or 0),
            )
            return self._inner.restore(step, template=template)

        return retry_call(
            _restore,
            policy=self._policy,
            describe=f"checkpoint restore (step {step})",
        )


class RunResult(NamedTuple):
    state: Any
    last_step: int  # last completed step index; -1 when nothing ran
    resumed_from: Optional[int]  # checkpoint step training continued from
    steps_run: int  # steps executed by THIS invocation
    skipped_steps: int  # steps the guard dropped (this invocation)
    rollbacks: int  # checkpoint rollbacks (this invocation)
    preempted: bool  # stopped early on SIGTERM


class ObserverFanout:
    """Compose several ``run_resilient`` observers into one.

    Each event forwards to every child that implements it, in order;
    observer errors propagate (the same contract as a single observer —
    a telemetry bug must not silently corrupt the ledgers).  ``None``
    entries are dropped so call sites can write
    ``ObserverFanout([goodput, watchdog, maybe_none])``.
    """

    def __init__(self, observers):
        self.observers = [o for o in observers if o is not None]

    def _fan(self, event: str, *args) -> None:
        for o in self.observers:
            fn = getattr(o, event, None)
            if fn is not None:
                fn(*args)

    def on_step(self, *args) -> None:
        self._fan("on_step", *args)

    def on_rollback(self, *args) -> None:
        self._fan("on_rollback", *args)

    def on_resume(self, *args) -> None:
        self._fan("on_resume", *args)

    def on_preempt(self, *args) -> None:
        self._fan("on_preempt", *args)

    def on_checkpoint(self, step, info=None) -> None:
        # per-child arity adaptation: a legacy 1-arg child still gets
        # the enqueue instants; only 2-arg children see phase records
        for o in self.observers:
            fn = getattr(o, "on_checkpoint", None)
            if fn is None:
                continue
            if info is None:
                fn(step)
            elif _takes_checkpoint_info(fn):
                fn(step, info)

    def on_retry(self, *args, **kwargs) -> None:
        for o in self.observers:
            fn = getattr(o, "on_retry", None)
            if fn is not None:
                fn(*args, **kwargs)


def _safe_dump(recorder, reason: str, label: str = "flight") -> None:
    """Write a recorder dump without masking the failure being dumped."""
    try:
        path = recorder.dump(reason)
        print(f"[{label}] black box written: {path}", flush=True)
    except Exception as e:
        import warnings

        warnings.warn(
            f"{label} dump failed ({type(e).__name__}: {e}) — "
            "continuing with the original failure",
            RuntimeWarning,
        )


def _notify(observer, event: str, *args) -> None:
    """Invoke ``observer.<event>(*args)`` if present.  Observer errors
    propagate — a telemetry bug must not silently corrupt the ledger it
    exists to keep honest."""
    if observer is None:
        return
    fn = getattr(observer, event, None)
    if fn is not None:
        fn(*args)


def _skipped(info) -> bool:
    if info is None:
        return False
    if hasattr(info, "skipped"):
        return bool(info.skipped)
    try:
        return bool(info["skipped"])
    except (TypeError, KeyError, IndexError):
        return False


def run_resilient(
    step_fn: Callable[[Any, Any], Tuple[Any, Any]],
    init_state: Any,
    batch_fn: Callable[[int], Any],
    *,
    directory,
    num_steps: int,
    save_interval_steps: int = 1,
    max_to_keep: Optional[int] = None,
    rollback_after: Optional[int] = None,
    max_rollbacks: int = 3,
    policy: Optional[RetryPolicy] = None,
    signals=(signal.SIGTERM,),
    observer: Any = None,
    flight: Any = None,
    spans: Any = None,
    checkpoint: str = "async",
) -> RunResult:
    """Drive ``step_fn`` for ``num_steps`` with auto-resume, preemption
    handling, checkpoint retries, and skip-budget rollback.

    ``checkpoint`` selects the save engine: ``"async"`` (default)
    snapshots to host and writes in the background — the step path pays
    only the snapshot, in-flight writes drain at rollback anchoring /
    preemption / shutdown, and every completed write lands on the
    observer stream as ``on_checkpoint(step, info)``; ``"sync"`` writes
    on the step path.

    Idempotent by construction: call it again after any interruption and
    it continues from the last complete checkpoint.  Returns a
    :class:`RunResult`; ``preempted=True`` means SIGTERM arrived, the
    final checkpoint is on disk, and a relaunch will resume within one
    step of where training stopped.  After ``max_rollbacks`` rollbacks
    the loop raises instead of livelocking on a deterministic skip.

    ``flight`` / ``spans``: recorders that join the observer fan-out and
    whose ``dump(reason)`` is called on any unhandled exception and on
    preemption (an explicitly passed recorder otherwise stays with its
    caller).  When ``flight`` is None, ``APEX_TPU_FLIGHT=N[:DIR]`` arms
    a flight recorder from the environment (no sources attached: its
    frames carry steps, skips and events); when ``spans`` is None,
    ``APEX_TPU_SPANS=N[:DIR]`` arms a span recorder, which also dumps at
    normal completion (a good run's timeline is the baseline a
    postmortem compares against).
    """
    spans_env_armed = False
    if spans is None:
        from apex_tpu_torch.observability.spans import SpanRecorder

        spans = SpanRecorder.from_env()
        spans_env_armed = spans is not None
    if flight is None:
        from apex_tpu_torch.observability.flight import FlightRecorder

        flight = FlightRecorder.from_env()
    if flight is not None or spans is not None:
        observer = ObserverFanout([observer, flight, spans])
    on_retry = getattr(observer, "on_retry", None)
    if on_retry is not None:
        _retry.add_retry_listener(on_retry)
    try:
        result = _run_resilient_inner(
            step_fn, init_state, batch_fn, directory=directory,
            num_steps=num_steps, save_interval_steps=save_interval_steps,
            max_to_keep=max_to_keep, rollback_after=rollback_after,
            max_rollbacks=max_rollbacks, policy=policy, signals=signals,
            observer=observer, checkpoint=checkpoint,
        )
    except BaseException as e:
        # BaseException on purpose: KeyboardInterrupt / SystemExit are
        # exactly the deaths a black box exists for
        if flight is not None:
            _safe_dump(flight, f"{type(e).__name__}: {e}")
        if spans is not None:
            _safe_dump(spans, f"{type(e).__name__}: {e}", label="spans")
        raise
    finally:
        if on_retry is not None:
            _retry.remove_retry_listener(on_retry)
    if result.preempted:
        if flight is not None:
            _safe_dump(
                flight, f"preemption (SIGTERM) at step {result.last_step}"
            )
        if spans is not None:
            _safe_dump(
                spans,
                f"preemption (SIGTERM) at step {result.last_step}",
                label="spans",
            )
    elif spans_env_armed:
        _safe_dump(spans, "completed", label="spans")
    return result


#: memo for _takes_checkpoint_info, keyed on the underlying function
#: (bound methods are recreated per attribute access; their __func__
#: is stable) — the answer never changes per callable, and paying
#: inspect.signature per phase event per observer would put repeated
#: introspection on the step loop
_CKPT_INFO_ARITY: dict = {}


def _takes_checkpoint_info(fn) -> bool:
    """True if ``fn(step, info)`` is callable — the 2-arg
    ``on_checkpoint`` protocol.  Observers written to the pre-goodput
    protocol (``on_checkpoint(step)`` only) keep working: they get the
    enqueue instants and simply never see the phase records."""
    import inspect

    key = getattr(fn, "__func__", fn)
    try:
        return _CKPT_INFO_ARITY[key]
    except (KeyError, TypeError):  # TypeError: unhashable callable
        pass
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        out = True  # builtins/partials we can't introspect: assume new
    else:
        n = 0
        out = False
        for p in sig.parameters.values():
            if p.kind is p.VAR_POSITIONAL:
                out = True
                break
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
                n += 1
        out = out or n >= 2
    try:
        _CKPT_INFO_ARITY[key] = out
    except TypeError:
        pass
    return out


def _drain_writes_best_effort(mgr, where: str) -> None:
    """Drain in-flight writes, but keep a mid-run drain from turning a
    single lost background write into a run abort: the anchor/forced
    save that follows falls back to the previous COMPLETE step — which
    is the failure contract — so warn and continue.  The SHUTDOWN
    drain deliberately does not use this: there the error must
    propagate."""
    try:
        mgr.wait_until_finished()
    except Exception as e:
        import warnings

        warnings.warn(
            f"checkpoint write failed, surfaced at {where} "
            f"({type(e).__name__}: {e}); falling back to the previous "
            "complete checkpoint",
            RuntimeWarning,
        )


def _drain_ckpt_events(mgr, observer):
    """Forward completed checkpoint phases (background writes,
    finalize barriers) onto the observer stream — the span layer
    renders them as ``ckpt/*`` intervals on the Perfetto timeline.
    Legacy 1-arg ``on_checkpoint`` observers are skipped, not crashed:
    the phase records are additive telemetry.  Returns the drained
    events for the caller's own bookkeeping (durability retirement)."""
    events = mgr.drain_events()
    if not events or observer is None:
        return events
    fn = getattr(observer, "on_checkpoint", None)
    if fn is None or not _takes_checkpoint_info(fn):
        return events
    for ev in events:
        fn(ev.get("step"), ev)
    return events


def _run_resilient_inner(
    step_fn, init_state, batch_fn, *, directory, num_steps,
    save_interval_steps, max_to_keep, rollback_after, max_rollbacks,
    policy, signals, observer, checkpoint,
) -> RunResult:
    state = init_state
    resumed_from = None
    steps_run = skipped_steps = rollbacks = 0
    consecutive_skips = 0
    # Accepted steps that a rollback might discard, reconciled against
    # the ACTUAL anchor at rollback time (not at save time: async saves
    # return when enqueued).  On a
    # successful save we retain one full prior interval — exactly the
    # "a failed background write falls back one interval" failure mode
    # the ResilientCheckpointManager scope note documents — so the
    # discarded count stays exact through a lost background save;
    # memory stays bounded at ~two save intervals.
    unsaved_accepted = []
    prev_save_step = -1

    with ResilientCheckpointManager(
        directory,
        max_to_keep=max_to_keep,
        save_interval_steps=save_interval_steps,
        policy=policy,
        engine=checkpoint,
    ) as mgr, PreemptionHandler(signals=signals) as preempt:
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(latest, template=state)
            resumed_from = latest
            _notify(observer, "on_resume", latest)
        start = (latest + 1) if latest is not None else 0
        completed = start - 1

        step = start
        while step < num_steps and not preempt.requested:
            state, info = step_fn(state, batch_fn(step))
            steps_run += 1
            # Simulated eviction lands "while the step runs": checking the
            # flag only after step_fn means the interrupted step still
            # completes and checkpoints, so a relaunch under the same
            # chaos spec (preemption@N fires again in the new process)
            # always makes at least one step of progress.
            chaos.maybe_preempt(step)
            was_skipped = _skipped(info)
            _notify(observer, "on_step", step, was_skipped, info)
            if was_skipped:
                # A skipped step is never checkpointed: its state is by
                # contract unchanged, and recording it would drag the
                # rollback anchor into the middle of the skip streak —
                # the replay must restart from the last ACCEPTED step.
                skipped_steps += 1
                consecutive_skips += 1
                if (
                    rollback_after is not None
                    and consecutive_skips >= rollback_after
                ):
                    if rollbacks >= max_rollbacks:
                        raise RuntimeError(
                            f"step {step}: skip budget exhausted again "
                            f"after {rollbacks} rollbacks — the failure "
                            "replays deterministically; refusing to "
                            "livelock"
                        )
                    _drain_writes_best_effort(mgr, "rollback anchoring")
                    _drain_ckpt_events(mgr, observer)
                    anchor = mgr.latest_step()
                    rollbacks += 1
                    streak = consecutive_skips
                    consecutive_skips = 0
                    anchor_val = anchor if anchor is not None else -1
                    discarded = sum(
                        1 for s in unsaved_accepted if s > anchor_val
                    )
                    # > anchor: discarded; <= anchor: proven durable —
                    # either way no longer at risk
                    unsaved_accepted = []
                    prev_save_step = anchor_val
                    _notify(
                        observer, "on_rollback", step, anchor_val,
                        streak, discarded,
                    )
                    if anchor is not None:
                        state = mgr.restore(anchor, template=init_state)
                        completed = anchor
                        step = anchor + 1
                    else:
                        # no checkpoint yet: restart from the initial state
                        state = init_state
                        completed = -1
                        step = 0
                    continue
            else:
                consecutive_skips = 0
                completed = step
                saved = mgr.save(step, state)
                unsaved_accepted.append(step)
                if saved:
                    if mgr.engine == "sync":
                        # no write-completion events on the sync manager
                        # — keep the reference's one-save-lag rule:
                        # steps at or before the PREVIOUS save are
                        # presumed durable once this save returns
                        unsaved_accepted = [
                            s for s in unsaved_accepted
                            if s > prev_save_step
                        ]
                        prev_save_step = step
                    # checkpoint ENQUEUED (saves are async): the
                    # event a timeline wants next to rollback anchors
                    _notify(observer, "on_checkpoint", step)
            # completed background writes land on the observer stream
            # as they finish — one cheap deque drain per step.  A
            # CONFIRMED commit is the async engine's durability signal
            # for retiring at-risk steps: an ENQUEUE is not durable —
            # with queue_depth > 1 an older in-flight write can still
            # fail, and `discarded` is documented as EXACT.
            for ev in _drain_ckpt_events(mgr, observer):
                if ev.get("phase") == "write" and ev.get("ok"):
                    durable = int(ev["step"])
                    unsaved_accepted = [
                        s for s in unsaved_accepted if s > durable
                    ]
            step += 1

        if preempt.requested:
            _notify(observer, "on_preempt", completed)
        if preempt.requested and completed >= 0:
            # Final checkpoint so a relaunch resumes within one step.  The
            # step may already be on disk when save_interval_steps == 1.
            # Barrier first (the chaos COLLECTIVE site): every process
            # agrees training stopped at `completed` — best-effort,
            # because a peer already torn down by the eviction must not
            # keep THIS host from reaching its final checkpoint.
            try:
                from apex_tpu_torch.parallel import multihost

                multihost.host_barrier(f"resilient-stop-{completed}",
                                       completed)
            except Exception as e:
                import warnings

                warnings.warn(
                    f"pre-checkpoint host barrier failed ({type(e).__name__}:"
                    f" {e}); writing the final checkpoint anyway",
                    RuntimeWarning,
                )
            _drain_writes_best_effort(mgr, "pre-preemption-save drain")
            if completed not in mgr.all_steps():
                mgr.save(completed, state, force=True)
        # the shutdown drain: in-flight background writes commit before
        # the run returns (the finalize barrier — the ONLY blocking
        # point the async engine has).  This one PROPAGATES a deferred
        # write error: a run must never return success claiming a final
        # checkpoint that never reached disk.
        mgr.wait_until_finished()
        _drain_ckpt_events(mgr, observer)
        return RunResult(
            state=state,
            last_step=completed,
            resumed_from=resumed_from,
            steps_run=steps_run,
            skipped_steps=skipped_steps,
            rollbacks=rollbacks,
            preempted=preempt.requested,
        )

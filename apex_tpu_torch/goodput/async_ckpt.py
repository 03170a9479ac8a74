"""Async checkpoint engine — snapshot to host, write behind.

Counterpart of ``apex_tpu/goodput/async_ckpt.py``.  The synchronous path
(:class:`apex_tpu_torch.checkpoint.CheckpointManager`) writes on the
step path, so checkpoint cadence trades directly against step time.
:class:`AsyncCheckpointEngine` splits the save:

1. **snapshot** — :func:`host_snapshot` copies the state tree to host
   buffers.  For CUDA tensors every device→host copy is issued
   ``non_blocking`` into pinned memory on the current stream, and one
   event is recorded after the last; the step path pays only the issue
   and the enqueue.  The stream orders the next step's in-place updates
   (FusedLAMB's) after the copies, so the snapshot is
   **copy-on-snapshot**: the caller may mutate the state the moment
   ``save`` returns.  CPU tensors and numpy arrays are copied; Python
   scalars pass through.  The pinned buffers come from a fixed pool of
   ``queue_depth + 1`` slots (one per queued write and the one being
   written), allocated as saves first need them or up front by
   :meth:`AsyncCheckpointEngine.reserve`: a slot goes back to the pool
   only when its write is done, so a queue deeper than one never
   overwrites a buffer a pending write still reads, and a save that
   finds every slot taken waits for the writer, as a full queue makes
   it wait.
2. **background write** — one writer thread drains a bounded queue: it
   waits on the snapshot's event, then writes ``<dir>/<step>`` through
   :func:`apex_tpu_torch.checkpoint.save_checkpoint` (staged, marked,
   renamed), so a crash or SIGTERM mid-write leaves only debris that
   :func:`apex_tpu_torch.checkpoint.all_steps` ignores.
3. **barrier only at finalize** — :meth:`wait_until_finished` joins the
   queue (``run_resilient`` calls it at rollback anchoring, before the
   forced preemption checkpoint, and at shutdown).

Every completed phase lands as an event (:meth:`drain_events`;
``run_resilient`` forwards them to the observer's ``on_checkpoint``) and
in :meth:`stats` / :meth:`stall_fraction`, and each save, write and
finalize publishes the board's ``goodput/ckpt/*`` gauges (saves,
writes, failures, the last snapshot's and write's ms, the stall
fraction).

Failure contract (the reference's): a background write that fails
permanently loses that one step's checkpoint, never crash consistency —
the error is deferred and raised at the next synchronization point, the
next ``save`` or :meth:`wait_until_finished`.  The incomplete step stays
invisible to ``latest_step``; resume falls back one interval.
"""

from __future__ import annotations

import collections
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from apex_tpu_torch import checkpoint as _ckpt
from apex_tpu_torch.observability.locks import TrackedLock

__all__ = [
    "host_snapshot",
    "resolve_queue_depth",
    "AsyncCheckpointEngine",
]


def _map(fn, tree):
    if isinstance(tree, _ckpt.PerRank):
        return _ckpt.PerRank(_map(fn, tree.tree))
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(
            out)
    return fn(tree)


def _pinned(buffers, i, x):
    """The ``i``-th pinned buffer of ``buffers`` (a slot: a list of pinned
    tensors in the order of a state's CUDA leaves), allocated anew where
    the slot is short or the leaf's shape or dtype changed."""
    if i == len(buffers):
        buffers.append(None)
    host = buffers[i]
    if host is None or host.shape != x.shape or host.dtype != x.dtype:
        host = buffers[i] = torch.empty(x.shape, dtype=x.dtype,
                                        pin_memory=True)
    return host


def _snapshot(state, buffers=None):
    """``(host tree, event)``: CUDA tensor leaves copied ``non_blocking``
    into the pinned tensors of ``buffers`` (a fresh slot when None) on
    the current stream, then one event recorded (None when no leaf is on
    the card); CPU tensors cloned, numpy arrays copied, numpy scalars
    made 0-d arrays, the rest passed through."""
    buffers = [] if buffers is None else buffers
    cuda = []

    def copy(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                host = _pinned(buffers, len(cuda), x)
                host.copy_(x, non_blocking=True)
                cuda.append(x.device)
                return host
            return x.clone()
        if isinstance(x, np.ndarray):
            return np.array(x, copy=True)
        if isinstance(x, np.generic):
            return np.asarray(x)
        return x

    host = _map(copy, state)
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(cuda[-1]))
    return host, event


def host_snapshot(state):
    """Copy a state tree to host buffers, snapshot-isolated, and wait for
    the copies: CUDA tensors land in pinned CPU tensors, CPU tensors are
    cloned, numpy arrays copied (a caller mutating them after ``save``
    must not corrupt the checkpoint), numpy scalars become 0-d arrays,
    Python scalars pass through.  The snapshot holds one full host copy
    of the state: budget host RAM for it per in-flight save."""
    host, event = _snapshot(state)
    if event is not None:
        event.synchronize()
    return host


_SENTINEL = object()

#: env override for the write-queue depth (same idiom as
#: ``APEX_TPU_COMM_CHUNKS``): env > explicit ``queue_depth`` arg >
#: default 4.  The default absorbs a few intervals of write jitter at
#: production cadences (saves minutes apart, writes seconds long); a
#: compressed-timescale harness (the CI storm drill saves every few
#: hundred ms onto whatever disk the runner has) raises it so the
#: measured stall fraction keeps meaning "the step path pays only the
#: snapshot" instead of "this machine's disk was slow today".
ENV_QUEUE_DEPTH = "APEX_TPU_CKPT_QUEUE"


def resolve_queue_depth(queue_depth: Optional[int] = None) -> int:
    """Write-queue depth: env :data:`ENV_QUEUE_DEPTH` > explicit arg >
    default 4.  Always >= 1 — depth 0 would turn every save into a
    synchronous write."""
    env = os.environ.get(ENV_QUEUE_DEPTH)
    if env:
        depth = int(env)
    elif queue_depth is not None:
        depth = int(queue_depth)
    else:
        depth = 4
    return max(1, depth)


class AsyncCheckpointEngine:
    """Step-numbered async checkpoints: host snapshot + background write.

    API-compatible with :class:`apex_tpu_torch.checkpoint.CheckpointManager`
    (``save``/``restore``/``latest_step``/``all_steps``/``should_save``/
    ``wait_until_finished``/``close``, context-managed), so
    ``run_resilient`` swaps between the two behind one name.  On top:

    - ``save`` returns the moment the host snapshot is enqueued; the
      bounded queue (``queue_depth`` — :func:`resolve_queue_depth`:
      env ``APEX_TPU_CKPT_QUEUE`` > arg > default 4, which absorbs a
      few intervals of write jitter) is the backpressure valve: a writer that falls behind
      stalls the NEXT save's enqueue, never unboundedly buffering
      snapshots in RAM.
    - ``drain_events()`` hands back completed phase records
      (``{"phase": "write"|"finalize", "step", "t0", "t1", ...}``,
      monotonic seconds) for the observer/span layer.
    - ``stats()`` is the cumulative ledger (saves, failures, snapshot/
      enqueue/write milliseconds, stall fraction).

    Step enumeration and the interval policy are resume-aware: a fresh
    engine on an existing directory continues the cadence from the
    newest complete step on disk.
    """

    def __init__(
        self,
        directory,
        *,
        max_to_keep: Optional[int] = None,
        save_interval_steps: int = 1,
        queue_depth: Optional[int] = None,
    ):
        if save_interval_steps < 1:
            raise ValueError("save_interval_steps must be >= 1")
        self._directory = os.path.abspath(os.fspath(directory))
        os.makedirs(self._directory, exist_ok=True)
        self._interval = int(save_interval_steps)
        self._max_to_keep = max_to_keep
        self._last_saved: Optional[int] = _ckpt.latest_step(self._directory)
        # several processes: every rank's writer takes part in each save
        # over a gloo group of the engine's own (made here, on the
        # calling thread, by every rank in the same order)
        self._rank, world = _ckpt._world()
        self._group = (torch.distributed.new_group(backend="gloo")
                       if world > 1 else None)
        depth = resolve_queue_depth(queue_depth)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        # the pinned snapshot slots: at most one per queued write plus
        # the one being written; free ones wait in ``_free``
        self._max_slots = depth + 1
        self._n_slots = 0
        self._free: "queue.Queue" = queue.Queue()
        self._events: "collections.deque" = collections.deque(maxlen=1024)
        # one lock for everything the writer thread and the step path
        # both touch: _error, _stats, _phase, _first_save_t.
        # TrackedLock so the LOCKSAN lock-order graph sees it and
        # close() can name the holder when a drain times out.
        self._lock = TrackedLock("ckpt")
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._phase = "idle"  # writer's current phase, for close() diag
        self._first_save_t: Optional[float] = None
        self._stats: Dict[str, float] = {
            "saves": 0.0,
            "writes": 0.0,
            "failures": 0.0,
            "snapshot_ms_total": 0.0,
            "enqueue_wait_ms_total": 0.0,
            "pinned_slots": 0.0,
            "reserve_ms_total": 0.0,
            "write_ms_total": 0.0,
            "finalize_ms_total": 0.0,
            "last_snapshot_ms": 0.0,
            "last_write_ms": 0.0,
        }

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="apex-tpu-torch-ckpt-writer",
            )
            self._thread.start()

    def close(self, timeout: float = 120.0) -> None:
        """Drain pending writes and stop the writer.
        Never raises (it runs from ``__exit__``, possibly during
        exception handling) — but a deferred write error is WARNED,
        not swallowed: without a later ``save``/finalize to raise it,
        close is the last place a lost final write can be reported.

        The drain is a BOUNDED wait: after ``timeout`` seconds the
        warning names what the writer was doing when it wedged — its
        current phase (``write step N`` / ``prune`` / ``bootstrap``),
        the queue backlog, and who holds the engine lock (TrackedLock
        state) — instead of a bare "still busy"."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None and self._thread.is_alive():
            # FIFO: queued snapshots are written before the sentinel
            # stops the loop — close() IS the shutdown drain
            while True:
                try:
                    self._q.put(_SENTINEL, timeout=0.5)
                    break
                except queue.Full:
                    if not self._thread.is_alive():
                        break
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                # the daemon writer dies with the process; whatever is
                # still queued/mid-write never reaches disk — that must
                # not be silent (run_resilient drains via
                # wait_until_finished first, but a bare context-manager
                # user's last checkpoints are on the line here).  Name
                # the stuck phase so the postmortem starts at the right
                # layer (a wedged write step vs. a slow prune vs.
                # a lock-holder that never released).
                import warnings

                # deliberately lock-free reads: if the writer wedged
                # WHILE holding the lock, taking it here would hang the
                # very diagnostic meant to explain the hang
                phase = self._phase
                holder = self._lock.holder
                warnings.warn(
                    f"checkpoint writer still busy after {timeout:g}s "
                    f"close() drain (stuck phase: {phase}; "
                    f"{self._q.qsize()} item(s) still queued; engine "
                    f"lock held by: {holder or 'nobody'}); pending "
                    "background writes will be lost when the process "
                    "exits",
                    RuntimeWarning,
                )
        # drop the free slots' pinned buffers (a slot still held by a
        # wedged write goes with its write)
        while True:
            try:
                self._free.get_nowait()
            except queue.Empty:
                break
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            import warnings

            warnings.warn(
                f"checkpoint write failed during close "
                f"({type(err).__name__}: {err}); the failed step is "
                "not on disk — resume falls back one interval",
                RuntimeWarning,
            )

    # -- queries -----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        """Newest COMPLETE step on disk (queued writes excluded — a
        step is not a checkpoint until its commit rename lands)."""
        return _ckpt.latest_step(self._directory)

    def all_steps(self) -> List[int]:
        return _ckpt.all_steps(self._directory)

    def should_save(self, step: int) -> bool:
        """Interval policy: first save always, then ``interval`` steps
        after the last saved one."""
        return (
            self._last_saved is None
            or step >= self._last_saved + self._interval
        )

    # -- io ----------------------------------------------------------------
    def save(self, step: int, state, *, force: bool = False) -> bool:
        """Snapshot ``state`` to host and enqueue the background write.

        Returns False when the interval policy skips the step.  Raises
        a deferred background-write error from a PREVIOUS save (one
        shot: the caller's retry re-enters with the error cleared and
        the current step is enqueued — the failed step falls back one
        interval, exactly the sync manager's documented semantics).
        """
        if self._closed:
            # a save after close() would silently resurrect a writer
            # nothing ever drains again — the drain-on-exit guarantee
            # only holds if the lifecycle stays closed
            raise RuntimeError("save() on a closed AsyncCheckpointEngine")
        self._raise_deferred()
        if not force and not self.should_save(step):
            return False
        self._ensure_thread()
        t_wait = time.monotonic()
        buffers = self._take_slot()
        t0 = time.monotonic()
        try:
            host, event = _snapshot(state, buffers)
        except BaseException:
            self._free.put(buffers)
            raise
        t1 = time.monotonic()
        # the enqueue wait is only known after put() returns, but the
        # writer may already hold the item by then — hand it a shared
        # slot instead.  The writer reads it when emitting the write
        # event (after the save, long past the fill below), so
        # the event's step-path cost is snapshot AND enqueue.
        enq_slot: List[float] = []
        # the bounded put blocks when the writer is behind — it must
        # stay OUTSIDE the lock (the writer needs the same lock to
        # finish the write that frees the slot: holding it here is the
        # textbook race-lock-across-blocking deadlock)
        self._q.put((int(step), host, event, bool(force), t0, t1, enq_slot,
                     buffers))
        t2 = time.monotonic()
        # waiting for a free slot is the same backpressure as waiting for
        # queue room: both mean the writer is behind
        wait_ms = (t0 - t_wait + t2 - t1) * 1e3
        enq_slot.append(wait_ms)
        self._last_saved = int(step)
        with self._lock:
            st = self._stats
            st["saves"] += 1.0
            st["snapshot_ms_total"] += (t1 - t0) * 1e3
            st["enqueue_wait_ms_total"] += wait_ms
            st["last_snapshot_ms"] = (t1 - t0) * 1e3
            if self._first_save_t is None:
                self._first_save_t = t_wait
        self._publish()
        return True

    def _take_slot(self) -> list:
        """A free snapshot slot: a released one, else a new (empty) one
        while fewer than ``queue_depth + 1`` exist, else the next one
        the writer releases."""
        try:
            return self._free.get_nowait()
        except queue.Empty:
            pass
        with self._lock:
            grow = self._n_slots < self._max_slots
            if grow:
                self._n_slots += 1
                self._stats["pinned_slots"] = float(self._n_slots)
        return [] if grow else self._free.get()

    def reserve(self, state) -> None:
        """Allocate every snapshot slot's pinned buffers for ``state``'s
        CUDA leaves now, off the step path (set-up, like building the
        model); without it a save allocates a slot's buffers the first
        time it takes the slot.  Port-only: the reference snapshots
        through the runtime's own host buffers."""
        t0 = time.monotonic()
        leaves = []
        _map(lambda x: leaves.append(x) if isinstance(
            x, torch.Tensor) and x.is_cuda else None, state)
        slots = []
        while True:
            try:
                slots.append(self._free.get_nowait())
            except queue.Empty:
                break
        with self._lock:
            grow = self._max_slots - self._n_slots
            self._n_slots = self._max_slots
            self._stats["pinned_slots"] = float(self._n_slots)
        slots += [[] for _ in range(grow)]
        for buffers in slots:
            for i, x in enumerate(leaves):
                _pinned(buffers, i, x)
            self._free.put(buffers)
        with self._lock:
            self._stats["reserve_ms_total"] += (time.monotonic() - t0) * 1e3

    def _raise_deferred(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def restore(self, step: Optional[int] = None, *, template=None):
        """Restore ``step`` (default: newest complete) — drains pending
        writes first so a just-enqueued save is restorable.  A deferred
        write error stays deferred (to the next ``save``/finalize): a
        lost write must not block restoring the previous complete step
        — that fall-back IS the failure contract."""
        self._q.join()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint under {self._directory}"
                )
        return _ckpt.restore_step_dir(
            self._directory, int(step), template=template
        )

    def wait_until_finished(self) -> None:
        """The finalize barrier: block until every enqueued write has
        committed, then raise any deferred write error (cleared, like
        ``save`` — but a shutdown/preemption drain must never report
        success for a checkpoint that never reached disk)."""
        t0 = time.monotonic()
        self._q.join()
        dt = time.monotonic() - t0
        if dt > 1e-4:  # an actual wait, not the no-op fast path
            with self._lock:
                self._stats["finalize_ms_total"] += dt * 1e3
            self._events.append({
                "phase": "finalize", "step": self._last_saved,
                "t0": t0, "t1": t0 + dt,
            })
            self._publish()
        self._raise_deferred()

    # -- the background writer ---------------------------------------------
    def _writer_loop(self) -> None:
        try:
            with self._lock:
                self._phase = "bootstrap"
            _ckpt._dcp()
            with self._lock:
                self._phase = "idle"
        except BaseException as e:
            # bootstrap failed (torch.distributed.checkpoint missing or
            # broken): become a pure drainer — ``q.join()`` callers must
            # never deadlock on items this writer can no longer write.
            # The error surfaces through the normal deferral contract
            # (next save/finalize); close()'s sentinel ends the loop.
            with self._lock:
                self._error = e
                self._stats["failures"] += 1.0
                self._phase = "drain (bootstrap failed)"
            while True:
                item = self._q.get()
                if item is not _SENTINEL:
                    # every snapshot this drainer swallows is a LOST
                    # checkpoint: re-arm the error each time (a save()
                    # raising it clears it one-shot), BEFORE task_done so
                    # a q.join() waiter observes it the moment it returns
                    with self._lock:
                        if self._error is None:
                            self._error = e
                        self._stats["failures"] += 1.0
                    self._free.put(item[-1])
                self._q.task_done()
                if item is _SENTINEL:
                    return
        while True:
            item = self._q.get()
            try:
                if item is _SENTINEL:
                    return
                self._write_one(*item)
            finally:
                self._q.task_done()

    def _write_one(
        self, step, host, event, force, snap_t0, snap_t1, enq_slot, buffers,
    ) -> None:
        path = os.path.join(self._directory, str(step))
        w0 = time.monotonic()
        ok = True
        try:
            with self._lock:
                self._phase = f"write step {int(step)}"
            if event is not None:
                event.synchronize()  # the snapshot's device->host copies
            if self._commit_hook is not None:
                self._commit_hook(step)
            _ckpt.save_checkpoint(path, host,
                                  force=force or os.path.exists(path),
                                  group=self._group)
            with self._lock:
                self._phase = "prune"
            try:
                self._prune()
            finally:
                if self._group is not None:
                    # the write returns on every rank only once rank 0's
                    # retention prune is done: a rank that reads the
                    # directory after wait_until_finished sees it final
                    _ckpt._round(0, self._group)
        except BaseException as e:  # deferred to the next save() call
            ok = False
            with self._lock:
                self._error = e
                self._stats["failures"] += 1.0
        self._free.put(buffers)  # the write no longer reads them
        w1 = time.monotonic()
        with self._lock:
            self._phase = "idle"
            st = self._stats
            if ok:
                st["writes"] += 1.0
                st["write_ms_total"] += (w1 - w0) * 1e3
                st["last_write_ms"] = (w1 - w0) * 1e3
        self._events.append({
            "phase": "write", "step": int(step), "ok": ok,
            "t0": w0, "t1": w1,
            "snapshot_t0": snap_t0, "snapshot_t1": snap_t1,
            "enqueue_ms": enq_slot[0] if enq_slot else 0.0,
        })
        self._publish()

    def _publish(self) -> None:
        """The engine's gauges on the board."""
        from apex_tpu_torch.observability.metrics import board

        with self._lock:
            st = dict(self._stats)
        board.set("goodput/ckpt/saves", st["saves"])
        board.set("goodput/ckpt/writes", st["writes"])
        board.set("goodput/ckpt/failures", st["failures"])
        board.set("goodput/ckpt/last_snapshot_ms", st["last_snapshot_ms"])
        board.set("goodput/ckpt/last_write_ms", st["last_write_ms"])
        board.set("goodput/ckpt/stall_frac", self.stall_fraction())

    #: test hook: raises planted mid-write failures INSIDE the writer
    #: (after the snapshot, before the commit) — the on-disk shape of a
    #: host that died mid-save, without killing the test process
    _commit_hook = None

    def _prune(self) -> None:
        # failed-write debris first (on the writer thread between writes,
        # so nothing of OURS is in flight): the port's staging dirs and
        # markerless digit dirs are dead crash/kill leftovers, which on a
        # preemptible fleet would otherwise accumulate one full-state
        # payload per eviction.  Orbax-style ``*.orbax-checkpoint-tmp-*``
        # dirs are not the port's (it never writes them) and stay; they
        # are invisible to all_steps either way.  Single-writer only: in
        # a multi-process job the directory would be shared.
        if self._rank != 0:
            return  # rank 0 keeps the shared directory
        if self._group is None:
            try:
                entries = os.listdir(self._directory)
            except OSError:
                entries = []
            for name in entries:
                path = os.path.join(self._directory, name)
                if not os.path.isdir(path):
                    continue
                if _ckpt.STAGING_INFIX in name or (
                    name.isdigit()
                    and not _ckpt._is_complete_step_dir(path)
                ):
                    shutil.rmtree(path, ignore_errors=True)
        if self._max_to_keep is None:
            return
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self._max_to_keep)]:
            shutil.rmtree(
                os.path.join(self._directory, str(s)), ignore_errors=True
            )

    # -- telemetry ---------------------------------------------------------
    def drain_events(self) -> List[dict]:
        """Completed phase records since the last drain (write spans
        land here from the writer thread; ``run_resilient`` forwards
        them to ``observer.on_checkpoint(step, info)``)."""
        out = []
        while True:
            try:
                out.append(self._events.popleft())
            except IndexError:
                return out

    #: below this much wall time since the first save the fraction is
    #: statistically meaningless (one snapshot over a near-zero
    #: denominator reads as a huge stall) — report 0.0 = "no evidence
    #: yet" instead of paging the watchdog on cold start
    MIN_STALL_WINDOW_S = 1.0

    def stall_fraction(self) -> float:
        """Fraction of wall time since the first save that the STEP
        PATH spent inside ``save`` (snapshot + enqueue wait).  Background
        write time is deliberately excluded: it overlaps training.
        0.0 until :data:`MIN_STALL_WINDOW_S` of wall time has accrued
        (a cold-start fraction over milliseconds is noise, not a
        stall)."""
        with self._lock:
            first_t = self._first_save_t
            stalled_ms = (
                self._stats["snapshot_ms_total"]
                + self._stats["enqueue_wait_ms_total"]
            )
        if first_t is None:
            return 0.0
        wall = time.monotonic() - first_t
        if wall < self.MIN_STALL_WINDOW_S:
            return 0.0
        return min(1.0, (stalled_ms / 1e3) / wall)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._stats)
        out["pending"] = float(self._q.qsize())
        out["stall_frac"] = self.stall_fraction()
        return out

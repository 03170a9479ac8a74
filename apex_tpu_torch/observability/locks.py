"""TrackedLock — the runtime lock-order sanitizer (``APEX_TPU_LOCKSAN``).

Counterpart of ``apex_tpu/observability/locks.py``, host code copied
over.  :class:`TrackedLock` is a drop-in ``threading.Lock`` (context
manager, ``acquire``/``release``) that always tracks cheap diagnostics
— :attr:`holder` (the owning thread's name) and :attr:`acquires` — so
``AsyncCheckpointEngine.close()`` can name a stuck phase instead of
hanging silently.  When the sanitizer is armed (``APEX_TPU_LOCKSAN=1``,
or :func:`arm` in tests) every acquisition is also recorded into a
per-thread held-stack and a global **lock-order graph**: acquiring ``B``
while holding ``A`` adds edge ``A -> B``.  A new edge that closes a
cycle is a potential deadlock and is reported loudly: a
``RuntimeWarning``, a ``locksan_cycle`` event on an attached flight
recorder (:func:`attach_flight`), and an entry of
:func:`sanitizer_report`; the count of cycles is published on the
board as ``locksan/cycles``.  Unarmed, the overhead is one cached
flag check per acquire.
"""

from __future__ import annotations

import os
import threading
import warnings
from typing import Dict, List, Optional, Set

__all__ = [
    "ENV_LOCKSAN",
    "TrackedLock",
    "arm",
    "armed",
    "attach_flight",
    "lock_order_graph",
    "cycles",
    "sanitizer_report",
    "reset_sanitizer",
]

ENV_LOCKSAN = "APEX_TPU_LOCKSAN"


class _Sanitizer:
    """Process-global lock-order bookkeeping (armed-only)."""

    def __init__(self):
        self._mu = threading.Lock()
        #: lock name -> set of lock names acquired while holding it
        self._edges: Dict[str, Set[str]] = {}
        #: name -> acquire count (every TrackedLock seen while armed)
        self._counts: Dict[str, int] = {}
        self._cycles: List[dict] = []
        self._cycle_keys: Set[frozenset] = set()
        self._held = threading.local()
        self._flight = None
        self._armed: Optional[bool] = None  # None = read env lazily

    def armed(self) -> bool:
        if self._armed is None:
            self._armed = os.environ.get(ENV_LOCKSAN, "") == "1"
        return self._armed

    def arm(self, on: Optional[bool]) -> None:
        """True/False force the state; None re-reads the env."""
        self._armed = on

    def attach_flight(self, flight) -> None:
        self._flight = flight

    def _stack(self) -> List[str]:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = self._held.stack = []
        return stack

    # -- recording ---------------------------------------------------------
    def on_acquire(self, name: str) -> None:
        stack = self._stack()
        new_cycles = []
        with self._mu:
            self._counts[name] = self._counts.get(name, 0) + 1
            for prev in stack:
                if prev == name:  # reentrant re-acquire, not an edge
                    continue
                succ = self._edges.setdefault(prev, set())
                if name not in succ:
                    succ.add(name)
                    path = self._find_cycle(name, prev)
                    if path is not None:
                        key = frozenset(path)
                        if key not in self._cycle_keys:
                            self._cycle_keys.add(key)
                            record = {
                                "cycle": path,
                                "closing_edge": [prev, name],
                                "thread": threading.current_thread().name,
                            }
                            self._cycles.append(record)
                            new_cycles.append(record)
        stack.append(name)
        for record in new_cycles:
            self._report_cycle(record)

    def on_release(self, name: str) -> None:
        stack = self._stack()
        # remove the most recent occurrence (locks usually release LIFO
        # but the API does not require it)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    def _find_cycle(self, start: str, target: str):
        """DFS ``start -> ... -> target`` through the edge set (caller
        holds ``_mu``); the found path + the just-added closing edge
        ``target -> start`` is the cycle."""
        seen = {start}
        path = [start]

        def dfs(node: str) -> bool:
            for nxt in sorted(self._edges.get(node, ())):
                if nxt == target:
                    path.append(nxt)
                    return True
                if nxt not in seen:
                    seen.add(nxt)
                    path.append(nxt)
                    if dfs(nxt):
                        return True
                    path.pop()
            return False

        return path if dfs(start) else None

    def _report_cycle(self, record: dict) -> None:
        chain = " -> ".join(record["cycle"] + [record["cycle"][0]])
        warnings.warn(
            f"LOCKSAN: lock-order cycle {chain} (edge "
            f"{record['closing_edge'][0]} -> {record['closing_edge'][1]}"
            f" closed it on thread '{record['thread']}') — two threads "
            "taking these locks in opposite orders can deadlock",
            RuntimeWarning,
            stacklevel=4,
        )
        from apex_tpu_torch.observability.metrics import board

        board.set("locksan/cycles", len(self._cycles))
        if self._flight is not None:
            try:
                self._flight.note("locksan_cycle", **record)
            except Exception:  # the report must never kill the holder
                pass

    # -- reporting ---------------------------------------------------------
    def graph(self) -> Dict[str, list]:
        with self._mu:
            return {a: sorted(bs) for a, bs in sorted(self._edges.items())}

    def cycles(self) -> List[dict]:
        with self._mu:
            return [dict(c) for c in self._cycles]

    def report(self) -> dict:
        with self._mu:
            return {
                "armed": self.armed(),
                "locks": dict(sorted(self._counts.items())),
                "edges": [
                    [a, b]
                    for a, bs in sorted(self._edges.items())
                    for b in sorted(bs)
                ],
                "cycles": [dict(c) for c in self._cycles],
            }

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._counts.clear()
            self._cycles.clear()
            self._cycle_keys.clear()
        self._held = threading.local()


_SAN = _Sanitizer()


class TrackedLock:
    """Drop-in ``threading.Lock`` with sanitizer hooks and diagnostics.

    ``name`` keys the lock-order graph — give every lock a stable,
    human-readable name (``"ckpt.stats"``, ``"ops.scrape"``).
    ``reentrant=True`` wraps an ``RLock`` for the rare owner-recursive
    path; re-acquiring a held reentrant lock adds no graph edge.

    :attr:`holder` / :attr:`acquires` are best-effort diagnostics
    (written only by the owning thread between acquire and release) —
    what ``AsyncCheckpointEngine.close()`` prints when the writer
    wedges.
    """

    def __init__(self, name: str, *, reentrant: bool = False):
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self.name = str(name)
        self._holder: Optional[str] = None
        self._acquires = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._holder = threading.current_thread().name
            self._acquires += 1
            if _SAN.armed():
                _SAN.on_acquire(self.name)
        return got

    def release(self) -> None:
        if _SAN.armed():
            _SAN.on_release(self.name)
        self._holder = None
        self._lock.release()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    @property
    def holder(self) -> Optional[str]:
        """Thread name currently holding the lock (None when free)."""
        return self._holder

    @property
    def acquires(self) -> int:
        """Total successful acquisitions (diagnostic counter)."""
        return self._acquires

    def locked(self) -> bool:
        return self._holder is not None

    def __repr__(self):
        state = f"held by {self._holder}" if self._holder else "free"
        return f"TrackedLock({self.name!r}, {state}, " \
               f"acquires={self._acquires})"


def armed() -> bool:
    """Whether the sanitizer records acquisitions (env or :func:`arm`)."""
    return _SAN.armed()


def arm(on: Optional[bool] = True) -> None:
    """Force the sanitizer on/off for this process (tests, drills);
    ``arm(None)`` reverts to the ``APEX_TPU_LOCKSAN`` env check."""
    _SAN.arm(on)


def attach_flight(flight) -> None:
    """Route cycle reports onto a flight recorder's event log
    (``locksan_cycle`` events) — ``run_resilient`` attaches its armed
    recorder so a potential deadlock lands in the crash dump."""
    _SAN.attach_flight(flight)


def lock_order_graph() -> Dict[str, list]:
    """``{lock: [locks acquired while holding it]}`` observed so far."""
    return _SAN.graph()


def cycles() -> List[dict]:
    """Distinct lock-order cycles detected (each a potential deadlock)."""
    return _SAN.cycles()


def sanitizer_report() -> dict:
    """The artifact section the goodput drill records: armed flag,
    per-lock acquire counts, the edge list, and any cycles."""
    return _SAN.report()


def reset_sanitizer() -> None:
    """Clear graph/counters/cycles (test isolation)."""
    _SAN.reset()

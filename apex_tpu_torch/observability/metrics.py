"""Metric registry — step telemetry without host syncs.

Counterpart of ``apex_tpu/observability/metrics.py``.  The reference
threads its metrics through the jitted step as a pytree of f32 scalars;
here the state is a dict of 0-d f32 tensors on the registry's
``device``, and :meth:`MetricRegistry.update` folds values into it in
place (counters add, gauges replace, ``min``/``max`` fold), so a
caller's state stays the same tensors for its life:

- **on the step's device** a training loop keeps its metrics there
  (``device="cuda"``): an update is one small in-place op per value,
  queued behind the step, and the host never reads them per step;
- **on the host** (``device="cpu"``, the default) live values the host
  owns anyway — the serving scheduler's queue depth and counters — cost
  no kernel launch and no copy.

:meth:`MetricRegistry.observe` is called once per step with the state.
Off the cadence it only stashes it.  Every ``fetch_every`` steps it
reads the copy started one cadence earlier and starts a copy of the
newest stash: for a state on the card a ``non_blocking`` copy into
pinned host memory behind a CUDA event, which the next rotation waits
on.  A value is at most ``2 * fetch_every`` steps stale, and the host
never waits for the device between fetches.  The stash is the state as
it was when observed: the first :meth:`update` after an observe takes a
snapshot of it before writing (one copy of the vector that :meth:`init`'s
tensors view), as the reference's immutable pytree keeps it.

Host-side values (wall-clock timings, build gauges, lock cycles) go on
the module-level :data:`board` — a plain dictionary.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Mapping, Optional

import torch

__all__ = ["MetricRegistry", "Board", "board"]

_KINDS = ("counter", "gauge", "min", "max")


class _Copy:
    """A state's values on their way to the host: one f32 vector in the
    state's name order (pinned, behind ``event``, for a state on the
    card)."""

    def __init__(self, names, values: torch.Tensor):
        self.names = names
        if values.device.type == "cuda":
            self.host = torch.empty(values.shape, dtype=values.dtype,
                                    pin_memory=True)
            self.host.copy_(values, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = values, None

    def floats(self) -> Dict[str, float]:
        if self.event is not None:
            self.event.synchronize()
        return dict(zip(self.names, self.host.tolist()))


class MetricRegistry:
    """Declare metrics, accumulate them in place, fetch them on a cadence.

    >>> reg = MetricRegistry(fetch_every=32)
    >>> reg.gauge("train/loss")
    >>> reg.counter("train/skips")
    >>> state = reg.init()                 # dict of 0-d f32 tensors
    >>> reg.update(state, {"train/loss": loss, "train/skips": skipped})
    >>> reg.observe(step, state)           # once per step, on the host
    >>> reg.fetch()                        # force-drain at the end
    >>> reg.values()                       # {name: float}

    ``update`` raises ``KeyError`` on an undeclared name — a typo'd
    metric must fail at once, not vanish silently.
    """

    def __init__(self, *, fetch_every: int = 32, device="cpu"):
        if fetch_every < 1:
            raise ValueError("fetch_every must be >= 1")
        from apex_tpu_torch.observability.ometrics import ExportNamespace

        self.fetch_every = fetch_every
        self.device = torch.device(device)
        self._kinds: Dict[str, str] = {}
        self._units: Dict[str, str] = {}
        # every declared key must round-trip through the OpenMetrics
        # name mapping without collisions: a key a scrape cannot
        # represent fails here, at declaration
        self._export = ExportNamespace()
        self._values: Dict[str, float] = {}
        self._fetched_step: Optional[int] = None
        # double buffer: _pending is the newest observed state (the live
        # dict until an update snapshots it), _inflight the copy started
        # one cadence earlier
        self._pending = None  # (step, state dict, snapshot or None)
        self._inflight = None  # (step, _Copy)
        self._timings: Dict[str, Dict[str, float]] = {}

    # -- declaration -------------------------------------------------------
    def _declare(self, name: str, kind: str, unit: str) -> None:
        assert kind in _KINDS
        prev = self._kinds.get(name)
        if prev is not None and prev != kind:
            raise ValueError(
                f"metric {name!r} already declared as {prev!r}"
            )
        # ValueError on an exporter-illegal key or a collision after the
        # name mapping (idempotent on re-declares)
        self._export.declare(name, kind)
        self._kinds[name] = kind
        self._units[name] = unit

    def counter(self, name: str, unit: str = "count") -> None:
        """A monotonically accumulating value (``update`` adds)."""
        self._declare(name, "counter", unit)

    def gauge(self, name: str, unit: str = "") -> None:
        """A point-in-time value (``update`` replaces)."""
        self._declare(name, "gauge", unit)

    def minimum(self, name: str, unit: str = "") -> None:
        self._declare(name, "min", unit)

    def maximum(self, name: str, unit: str = "") -> None:
        self._declare(name, "max", unit)

    def unit(self, name: str) -> str:
        return self._units.get(name, "")

    def kind(self, name: str) -> str:
        """``"counter" | "gauge" | "min" | "max"`` for a declared metric
        (the OpenMetrics exporter's type source)."""
        return self._kinds[name]

    @property
    def names(self):
        return tuple(self._kinds)

    # -- the state ---------------------------------------------------------
    def init(self) -> Dict[str, torch.Tensor]:
        """A fresh state: one 0-d f32 tensor per declared metric on the
        registry's device (``min``/``max`` seed at ±inf).  The tensors are
        views of one vector in the state's order, so a snapshot of the
        state is one copy."""
        seed = {"min": float("inf"), "max": float("-inf")}
        flat = torch.tensor([seed.get(kind, 0.0)
                             for kind in self._kinds.values()],
                            dtype=torch.float32, device=self.device)
        return {name: flat[i] for i, name in enumerate(self._kinds)}

    def update(self, state: Dict[str, torch.Tensor],
               values: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Fold ``values`` into ``state`` in place and return it.  A value
        is a number or a tensor on the state's device; each is taken as
        f32 (booleans count 0/1, so a skip flag feeds a counter)."""
        for name in values:
            if name not in self._kinds:
                raise KeyError(
                    f"metric {name!r} not declared on this registry "
                    f"(have {sorted(self._kinds)})"
                )
        pending = self._pending
        if pending is not None and pending[1] is state and pending[2] is None:
            # the observed state is about to change: keep it as observed
            self._pending = (pending[0], state, self._snapshot(state))
        for name, value in values.items():
            kind = self._kinds[name]
            t = state[name]
            # a number stays a Python scalar (rounded to f32 by the op):
            # no host tensor, no copy to the state's device
            v = (value.to(torch.float32) if isinstance(value, torch.Tensor)
                 else float(value))
            if kind == "counter":
                t.add_(v)
            elif kind == "gauge" and isinstance(v, torch.Tensor):
                t.copy_(v)
            elif kind == "gauge":
                t.fill_(v)
            else:
                if not isinstance(v, torch.Tensor):
                    v = torch.full_like(t, v)
                fold = torch.minimum if kind == "min" else torch.maximum
                fold(t, v, out=t)
        return state

    @staticmethod
    def _snapshot(state) -> torch.Tensor:
        """The state's values as one new vector in its order: a copy of
        the vector that :meth:`init`'s tensors view."""
        if not state:
            return torch.zeros((0,), dtype=torch.float32)
        return next(iter(state.values()))._base.clone()

    # -- host side ---------------------------------------------------------
    def observe(self, step: int, state: Mapping[str, torch.Tensor]) -> None:
        """Stash the step's state; fetch on the cadence.  Off the cadence
        this is one tuple assignment, with no device contact."""
        self._pending = (int(step), state, None)
        if step % self.fetch_every == 0:
            self._rotate()

    def _stash_copy(self, stash) -> "_Copy":
        _, state, snap = stash
        return _Copy(tuple(state),
                     self._snapshot(state) if snap is None else snap)

    def _rotate(self) -> None:
        if self._inflight is not None:
            self._materialize(self._inflight)
            self._inflight = None
        if self._pending is not None:
            self._inflight = (self._pending[0], self._stash_copy(self._pending))
            self._pending = None

    def _materialize(self, inflight) -> None:
        step, copy = inflight
        self._values.update(copy.floats())
        self._fetched_step = step

    def fetch(self) -> Dict[str, float]:
        """Force-drain both buffers (blocks) and return the values — call
        at checkpoints and shutdown, not per step.  The newest stash is
        read in a ``finally``: even when the older copy fails, the newest
        values land."""
        inflight, self._inflight = self._inflight, None
        pending, self._pending = self._pending, None
        try:
            if inflight is not None:
                self._materialize(inflight)
        finally:
            if pending is not None:
                self._materialize((pending[0], self._stash_copy(pending)))
        return dict(self._values)

    def close(self) -> Dict[str, float]:
        """Best-effort drain for exception paths: :meth:`fetch` that never
        raises.  A stash that cannot be read keeps the previous values
        (the flight recorder's dump relies on this)."""
        for stash in (self._inflight, self._pending):
            if stash is None:
                continue
            try:
                if isinstance(stash[1], _Copy):
                    self._materialize(stash)
                else:
                    self._materialize((stash[0], self._stash_copy(stash)))
            except Exception:  # noqa: BLE001 — a poisoned stash is skipped
                pass
        self._inflight = self._pending = None
        return dict(self._values)

    def values(self) -> Dict[str, float]:
        """Latest fetched values (no device contact; possibly stale by up
        to ``2 * fetch_every`` steps)."""
        return dict(self._values)

    @property
    def fetched_step(self) -> Optional[int]:
        """The step the current :meth:`values` were observed at."""
        return self._fetched_step

    # -- host-side timings -------------------------------------------------
    @contextlib.contextmanager
    def timing(self, name: str):
        """Host-side duration stat: ``with reg.timing("io/save"): ...``
        accumulates {count, total_s, last_s} of wall-clock time."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            rec = self._timings.setdefault(
                name, {"count": 0.0, "total_s": 0.0, "last_s": 0.0}
            )
            rec["count"] += 1.0
            rec["total_s"] += dt
            rec["last_s"] = dt

    def timings(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in self._timings.items()}


class Board:
    """Host-side gauge board: module-level, no device state.  Values are
    plain Python scalars or short strings."""

    def __init__(self):
        self._values: Dict[str, Any] = {}

    def set(self, name: str, value) -> None:
        self._values[name] = value

    def get(self, name: str, default=None):
        return self._values.get(name, default)

    def snapshot(self) -> Dict[str, Any]:
        return dict(self._values)

    def clear(self) -> None:
        self._values.clear()


#: The process-wide board (cleared by tests via ``board.clear()``).
board = Board()

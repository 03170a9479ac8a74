"""Cross-host fleet aggregation — every host's telemetry on one board.

Counterpart of ``apex_tpu/observability/fleet.py``.  Each process owns its
own :class:`~apex_tpu_torch.observability.metrics.MetricRegistry` and
:class:`~apex_tpu_torch.observability.meter.StepMeter`: rank 0's JSONL
shows rank 0's numbers, and a straggler on another host runs invisibly.
:class:`FleetAggregator` folds every member's metric row through ONE
all-gather over the data-parallel group of
:mod:`~apex_tpu_torch.parallel_state`
(:func:`apex_tpu_torch.parallel.comm.all_gather_rows`, so it shows in the
comm engine's call log like any other wire traffic) into a
``(hosts, n_metrics)`` matrix of **per-host columns**, then publishes
min/median/max rollups on rank 0's board.

The cadence discipline matches the registry — **no per-step host sync**:

- ``observe(step, values)`` on an off-cadence step is one tuple
  assignment (no device or group contact);
- on the cadence (``every``) the newest row is gathered with
  ``async_op=True`` and the handle of the gather started one cadence
  earlier is waited on and read, so the fleet view is at most
  ``2 * every`` steps stale and the host never blocks between cadences
  (:attr:`FleetAggregator.gathers` and :attr:`FleetAggregator.waits`
  count both).

At world 1 there is no group: the gathered matrix is the local row.
Each rank maps to its host through ``LOCAL_WORLD_SIZE`` (ranks
``h * L .. h * L + L - 1`` share host ``h``); a view keeps one row per
host once the group spans several, and every rank's row when all of
them share one host (the single-machine simulation, where each rank
stands in for a host).  :meth:`FleetAggregator.gather_rows` is the
synchronous path tests use to inject skewed rows.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch import parallel_state as ps

__all__ = ["FleetView", "FleetAggregator"]


class FleetView(NamedTuple):
    """One materialized fleet snapshot: per-host columns + rollups.

    ``host_ids`` labels each row with its host on a multi-host fleet
    (rows are collapsed to one per host before the view is built); None
    means row index == host label (every rank on one host, one row per
    group member).
    """

    step: int
    names: Tuple[str, ...]
    rows: Any  # np.ndarray (hosts, n_metrics)
    host_ids: Optional[Tuple[int, ...]] = None

    @property
    def hosts(self) -> int:
        return int(self.rows.shape[0])

    @property
    def labels(self) -> Tuple[int, ...]:
        """The host label of each row."""
        if self.host_ids is not None:
            return tuple(self.host_ids)
        return tuple(range(self.hosts))

    def per_host(self, name: str) -> List[float]:
        """``name``'s value on every host (row order = :attr:`labels`)."""
        i = self.names.index(name)
        return [float(v) for v in self.rows[:, i]]

    def rollup(self, name: str) -> Dict[str, float]:
        vals = sorted(self.per_host(name))
        return {
            "min": vals[0],
            "median": vals[len(vals) // 2],
            "max": vals[-1],
        }

    def as_dict(self) -> Dict[str, Any]:
        """Board-shaped flat dict: ``fleet/<name>/host<i>`` columns +
        ``fleet/<name>/{min,median,max}`` rollups."""
        out: Dict[str, Any] = {"fleet/step": self.step}
        labels = self.labels
        for name in self.names:
            vals = self.per_host(name)
            for label, v in zip(labels, vals):
                out[f"fleet/{name}/host{label}"] = v
            roll = self.rollup(name)
            for k, v in roll.items():
                out[f"fleet/{name}/{k}"] = v
        return out


class FleetAggregator:
    """Gather each member's metric row into per-host columns.

    >>> agg = FleetAggregator(("train/step_time_ms", "train/mfu"),
    ...                       every=32)
    >>> agg.observe(step, {**registry.values(), **meter.summary()})
    >>> view = agg.view()           # latest materialized FleetView
    >>> view.per_host("train/step_time_ms")

    ``names`` fixes the row layout (every rank declares the same names
    in the same order).  Missing values observe as NaN, which survives
    the gather and reads back as "this host had no measurement".  The
    rows ride the current card under NCCL, the CPU under gloo or at
    world 1.
    """

    def __init__(
        self,
        names,
        *,
        axis: str = ps.DATA_PARALLEL_AXIS,
        every: int = 32,
        publish: bool = True,
    ):
        if every < 1:
            raise ValueError("every must be >= 1")
        self.names = tuple(names)
        if not self.names:
            raise ValueError("need at least one metric name")
        self.n = len(self.names)
        self.axis = axis
        grouped = ps.model_parallel_is_initialized()
        self.world = ps.axis_size(axis) if grouped else 1
        self.rank = ps.axis_rank(axis) if grouped else 0
        self.group = ps.get_group(axis) if self.world > 1 else None
        self.every = every
        self.publish = publish
        self.device = self._default_device()
        self.local_world_size = max(
            1, int(os.environ.get("LOCAL_WORLD_SIZE", "1")))
        self._row_host = self._axis_row_hosts()
        self._pending: Optional[Tuple[int, Dict[str, float]]] = None
        self._inflight: Optional[Tuple[int, torch.Tensor, Any]] = None
        self._view: Optional[FleetView] = None
        #: gathers dispatched and handles waited on (each at a cadence
        #: step, a forced :meth:`fetch` or :meth:`gather_rows` only)
        self.gathers = 0
        self.waits = 0

    def _default_device(self) -> torch.device:
        if self.group is not None:
            backend = torch.distributed.get_backend(self.group)
            if backend == "nccl":
                return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def _axis_row_hosts(self) -> List[int]:
        """The host of each member along the axis (global rank //
        ``LOCAL_WORLD_SIZE``): the map that collapses a host's several
        ranks into one column, so they are not scored as several hosts."""
        if self.world == 1:
            return [0]
        ranks = ps.get_mesh().ranks[self.axis]
        return [int(r) // self.local_world_size for r in ranks]

    # -- the collective ----------------------------------------------------
    def _dispatch(self, row: np.ndarray):
        from apex_tpu_torch.parallel import comm

        local = torch.from_numpy(row).to(self.device)
        if self.world == 1:
            out, work = local.reshape(1, self.n).clone(), None
        else:
            out, work = comm.all_gather_rows(local, self.axis, async_op=True)
        self.gathers += 1
        return out, work

    def _wait(self, out: torch.Tensor, work) -> np.ndarray:
        if work is not None:
            work.wait()
            self.waits += 1
        return out.cpu().numpy()

    def gather_rows(self, rows) -> np.ndarray:
        """Gather a prepared ``(world, n)`` matrix (each rank contributes
        its own row of it) and block for the result — the synchronous
        path tests (and offline analysis) use to inject per-host skew;
        production goes through :meth:`observe`'s double buffer."""
        rows = np.asarray(rows, np.float32)
        if rows.shape != (self.world, self.n):
            raise ValueError(
                f"rows must be ({self.world}, {self.n}), got {rows.shape}"
            )
        out, work = self._dispatch(np.ascontiguousarray(rows[self.rank]))
        return self._wait(out, work)

    # -- cadence / double buffer ------------------------------------------
    def observe(self, step: int, values: Mapping[str, Any]) -> None:
        """Stash this step's host-local values; gather on the cadence.

        Off-cadence: one tuple assignment.  On-cadence: dispatch the
        gather (async) and materialize the previous one.
        """
        self._pending = (int(step), dict(values))
        if step % self.every == 0:
            self._rotate()

    def _row(self, values: Mapping[str, Any]) -> np.ndarray:
        return np.asarray(
            [float(values.get(name, float("nan"))) for name in self.names],
            np.float32,
        )

    def _rotate(self) -> None:
        if self._inflight is not None:
            self._materialize(self._inflight)
            self._inflight = None
        if self._pending is not None:
            step, values = self._pending
            self._pending = None
            self._inflight = (step, *self._dispatch(self._row(values)))

    def _materialize(self, stash) -> None:
        step, out, work = stash
        self._view = self._collapse(step, self._wait(out, work))
        self._publish(self._view)

    def _collapse(self, step: int, rows: np.ndarray) -> FleetView:
        """One row per HOST.  When every member shares one host the raw
        per-member rows stay (labelled by row); otherwise the first row
        of each host stays, labelled with the host, so straggler events
        name hosts and ``fleet/*/host<i>`` columns mean host ``i``."""
        distinct = sorted(set(self._row_host))
        if len(distinct) <= 1:
            return FleetView(step, self.names, rows)
        first_row = {}
        for j, host in enumerate(self._row_host):
            first_row.setdefault(host, j)
        keep = [first_row[h] for h in distinct]
        return FleetView(step, self.names, rows[keep], tuple(distinct))

    def _publish(self, view: FleetView) -> None:
        """Columns + rollups onto the board — rank 0 only (the process
        whose Reporter feeds the job-level JSONL/dashboard)."""
        if not self.publish:
            return
        from apex_tpu_torch.parallel import multihost

        if multihost.host_id() != 0:
            return
        from apex_tpu_torch.observability.metrics import board

        for key, value in view.as_dict().items():
            board.set(key, value)

    def view(self) -> Optional[FleetView]:
        """Latest materialized fleet view (no device or group contact; at
        most ``2 * every`` steps stale), or None before the first
        cadence."""
        return self._view

    def fetch(self) -> Optional[FleetView]:
        """Force-drain both buffers (blocks) — shutdown/dump path.  Every
        rank must call it (it may gather)."""
        if self._inflight is not None:
            self._materialize(self._inflight)
            self._inflight = None
        if self._pending is not None:
            step, values = self._pending
            self._pending = None
            self._materialize((step, *self._dispatch(self._row(values))))
        return self._view

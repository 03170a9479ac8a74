"""Deterministic, resumable streaming input — the batch side of goodput.

Counterpart of ``apex_tpu/goodput/stream.py``.  ``run_resilient``'s data
contract is ``batch_fn(step)``: step-indexed, so rollback replay and
auto-resume feed the same bytes for the same step number.
:class:`ResumableStream` implements it over the port's
:class:`apex_tpu_torch.data.DataLoader` (or any loader with its
``iter_from`` and identity fields):

- **deterministic** — batch ``k`` is a pure function of ``(seed, epoch,
  k)``;
- **O(1) seek** — a non-sequential step (rollback, resume) re-seeks via
  ``loader.iter_from`` instead of replaying the prefix;
- **prefetching** — ``prefetch=N`` rides a
  :class:`~apex_tpu_torch.data.DevicePrefetcher` onto ``device`` behind
  the cursor; it is closed and rebuilt on every seek, so its lookahead
  never leaks stale batches across a rollback;
- **checkpointable** — :meth:`ResumableStream.state` is a flat dict of
  numpy int64 scalars (the reference's dict, key for key), carried inside
  the training state; :func:`verify_stream_state` re-checks the identity
  (seed / shard / batch geometry) on resume and raises on a mismatch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

__all__ = [
    "StreamStateError",
    "ResumableStream",
    "stream_state",
    "verify_stream_state",
]

_STATE_VERSION = 1

#: the identity fields a resumed cursor is only valid for — a mismatch
#: in any of them means the cursor indexes a DIFFERENT stream
_IDENTITY = ("seed", "rank", "world", "batch_size", "shuffle",
             "num_samples")


class StreamStateError(ValueError):
    """A restored stream state does not match the loader it is being
    resumed onto (wrong seed/shard/geometry) or is structurally
    invalid."""


def stream_state(loader, next_batch: int) -> Dict[str, np.ndarray]:
    """The full iterator state as a flat dict of numpy int64 scalars —
    a checkpointable pytree leaf.  ``next_batch`` is the global batch
    index the stream will yield NEXT (epoch and in-epoch position are
    derived, recorded for human readers and cross-checks)."""
    next_batch = int(next_batch)
    if next_batch < 0:
        raise StreamStateError(f"next_batch must be >= 0, got {next_batch}")
    epoch, in_epoch = divmod(next_batch, loader.batches_per_epoch)
    return {
        "version": np.asarray(_STATE_VERSION, np.int64),
        "next_batch": np.asarray(next_batch, np.int64),
        "epoch": np.asarray(epoch, np.int64),
        "batch_in_epoch": np.asarray(in_epoch, np.int64),
        "seed": np.asarray(loader.seed, np.int64),
        "rank": np.asarray(loader.rank, np.int64),
        "world": np.asarray(loader.world, np.int64),
        "batch_size": np.asarray(loader.batch_size, np.int64),
        "shuffle": np.asarray(int(loader.shuffle), np.int64),
        "num_samples": np.asarray(len(loader.dataset), np.int64),
    }


def verify_stream_state(loader, state: Dict[str, Any]) -> int:
    """Validate a restored state against ``loader`` and return the
    ``next_batch`` cursor.  Raises :class:`StreamStateError` naming
    every mismatched identity field — resuming a cursor onto a
    different stream must fail loudly, not train on the wrong data."""
    try:
        version = int(state["version"])
        next_batch = int(state["next_batch"])
    except (KeyError, TypeError, ValueError) as e:
        raise StreamStateError(f"malformed stream state: {e}") from e
    if version != _STATE_VERSION:
        raise StreamStateError(
            f"stream state version {version} != {_STATE_VERSION}"
        )
    expect = stream_state(loader, 0)
    mismatches = [
        f"{k}: saved={int(state[k])} loader={int(expect[k])}"
        for k in _IDENTITY
        if k in state and int(state[k]) != int(expect[k])
    ]
    missing = [k for k in _IDENTITY if k not in state]
    if missing:
        mismatches.append(f"missing fields: {missing}")
    if mismatches:
        raise StreamStateError(
            "restored stream state does not match this loader — the "
            "cursor indexes a different sample sequence: "
            + "; ".join(mismatches)
        )
    return next_batch


class ResumableStream:
    """Step-indexed ``batch_fn`` over a :class:`~apex_tpu_torch.data.
    DataLoader` with O(1) reseek and optional device prefetch.

    >>> stream = ResumableStream(loader, prefetch=2, device="cuda")
    >>> run_resilient(step_fn, state, stream, directory=d, ...)
    >>> stream.close()

    Calling ``stream(step)`` yields the batch for global step ``step``
    (one loader batch per step): the loader's own batch without
    prefetch, tensors on ``device`` with it.  Sequential calls ride one
    iterator (and its prefetcher); any jump — backwards after a rollback,
    forwards after a resume — re-seeks (:attr:`seeks` counts them, not
    the first positioning).  ``state(next_step)`` /
    :func:`verify_stream_state` round-trip the cursor through a
    checkpoint.
    """

    def __init__(self, loader, *, prefetch: int = 0, device="cuda"):
        self.loader = loader
        self.prefetch = int(prefetch)
        self.device = device
        self._it = None
        self._pf = None
        self._expect: Optional[int] = None
        self.seeks = 0  # non-sequential repositionings (rollback/resume)

    # -- the batch_fn contract ---------------------------------------------
    def __call__(self, step: int):
        step = int(step)
        if step < 0:
            raise IndexError(f"batch step must be >= 0, got {step}")
        if self._it is None or step != self._expect:
            self._seek(step)
        batch = next(self._it)
        self._expect = step + 1
        return batch

    def _seek(self, step: int) -> None:
        if self._it is not None:
            self.seeks += 1
        self._close_prefetcher()
        src = self.loader.iter_from(step)
        if self.prefetch > 0:
            from apex_tpu_torch.data import DevicePrefetcher

            self._pf = DevicePrefetcher(
                src, device=self.device, depth=self.prefetch
            )
            self._it = iter(self._pf)
        else:
            self._it = src
        self._expect = step

    # -- checkpoint round-trip ---------------------------------------------
    def state(self, next_step: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The checkpointable cursor.  ``next_step`` defaults to the
        stream's own position (the step it would serve next)."""
        if next_step is None:
            next_step = self._expect if self._expect is not None else 0
        return stream_state(self.loader, next_step)

    def verify(self, state: Dict[str, Any]) -> int:
        """Validate a restored state against this stream's loader and
        return its ``next_batch`` cursor (raises on identity drift)."""
        return verify_stream_state(self.loader, state)

    def stall_fraction(self) -> float:
        """The prefetcher's input-stall fraction (0.0 without
        prefetch)."""
        return self._pf.stall_fraction if self._pf is not None else 0.0

    # -- lifecycle ---------------------------------------------------------
    def _close_prefetcher(self) -> None:
        if self._pf is not None:
            self._pf.close()
            self._pf = None

    def close(self) -> None:
        self._close_prefetcher()
        self._it = None
        self._expect = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""Retry/backoff for the flaky host-side operations of a long run.

Counterpart of ``apex_tpu/resilience/retry.py``, host code copied over.
The policy is deliberately boring — bounded attempts, exponential
backoff, then *raise*.  Checkpoint I/O goes through :func:`retry_call`
(:class:`apex_tpu_torch.resilience.ResilientCheckpointManager`), and
:func:`robust_initialize_distributed` retries the process group's
rendezvous (the chaos ``RENDEZVOUS`` site).
"""

from __future__ import annotations

import itertools
import time
import warnings
from typing import Callable, Optional, Sequence, Tuple, Type

from apex_tpu_torch.resilience import chaos

__all__ = [
    "RetryPolicy",
    "retry_call",
    "add_retry_listener",
    "remove_retry_listener",
    "robust_initialize_distributed",
]

# Observability bridge: each about-to-be-retried failure is announced to
# the registered listeners as ``fn(what, attempt, error)`` (attempt is
# 0-based).  run_resilient registers its observer's ``on_retry`` here
# for the duration of a run, so retry churn reaches its observer without
# threading a callback through every call site.
_LISTENERS: list = []


def add_retry_listener(fn: Callable) -> None:
    _LISTENERS.append(fn)


def remove_retry_listener(fn: Callable) -> None:
    if fn in _LISTENERS:
        _LISTENERS.remove(fn)


class RetryPolicy:
    """Bounded exponential backoff: ``backoff * factor**attempt``, capped.

    ``max_attempts`` counts total tries (first try included), so
    ``max_attempts=1`` means no retry.  ``sleep`` is injectable for tests.
    """

    def __init__(
        self,
        max_attempts: int = 3,
        backoff: float = 0.5,
        factor: float = 2.0,
        max_backoff: float = 30.0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.backoff = backoff
        self.factor = factor
        self.max_backoff = max_backoff
        self.sleep = sleep

    def delay(self, attempt: int) -> float:
        return min(self.backoff * self.factor**attempt, self.max_backoff)


def retry_call(
    fn: Callable,
    *args,
    policy: Optional[RetryPolicy] = None,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    describe: str = "",
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``; retry per ``policy`` on ``retry_on``.

    Each failed attempt emits a ``RuntimeWarning`` naming the attempt and
    the error (a silent retry hides a sick filesystem until the run dies);
    the final failure re-raises the last exception unchanged.
    """
    policy = policy or RetryPolicy()
    what = describe or getattr(fn, "__name__", repr(fn))
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            last = e
            if attempt + 1 >= policy.max_attempts:
                break
            for listener in list(_LISTENERS):
                listener(what, attempt, e)
            pause = policy.delay(attempt)
            warnings.warn(
                f"{what} failed (attempt {attempt + 1}/"
                f"{policy.max_attempts}: {type(e).__name__}: {e}); "
                f"retrying in {pause:.2g}s",
                RuntimeWarning,
                stacklevel=2,
            )
            policy.sleep(pause)
    assert last is not None
    raise last


def robust_initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    policy: Optional[RetryPolicy] = None,
    **kwargs,
) -> Tuple[int, int]:
    """Join the process group, retrying a flaky rendezvous.

    Against :func:`apex_tpu_torch.parallel.initialize_distributed`: no
    rendezvous given and no cluster environment is the same one-process
    no-op, ``(0, 1)``, with no retry; a join that fails is retried with
    backoff and then **raised** (``strict``), never degraded to one
    process.  ``kwargs`` (``backend``, ``device``, ``init_method``,
    ``timeout_s``) go to ``initialize_distributed``."""
    from apex_tpu_torch.parallel import multihost

    policy = policy or RetryPolicy()
    attempts = itertools.count()  # chaos attempt index across retries

    def _join():
        chaos.maybe_fail(chaos.RENDEZVOUS, next(attempts))
        return multihost.initialize_distributed(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
            strict=True,
            **kwargs,
        )

    return retry_call(
        _join,
        policy=policy,
        retry_on=(RuntimeError, chaos.InjectedFault),
        describe="distributed rendezvous",
    )

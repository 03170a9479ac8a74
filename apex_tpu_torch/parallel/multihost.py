"""Process start-up — ≙ ``torch.distributed.init_process_group``.

Counterpart of ``apex_tpu/parallel/multihost.py``, where each host joins
the global JAX runtime.  Here each process joins a ``torch.distributed``
process group: :func:`initialize_distributed` reads the rendezvous from
the environment (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``,
as ``torchrun`` sets them) or from its arguments (an ``init_method``
such as ``file:///path/store`` or ``tcp://host:port``, the world size
and this process's rank), with an explicit ``backend`` and ``device``:
``nccl`` on ``cuda`` by default, ``gloo`` for the CPU (or, staged
through the host, for several processes sharing one card, which NCCL
refuses).  Every group it creates carries a ``timeout``.

Typical start::

    from apex_tpu_torch.parallel import initialize_distributed
    from apex_tpu_torch import parallel_state as ps

    initialize_distributed()                    # torchrun's environment
    ps.initialize_model_parallel(tensor_model_parallel_size=2)
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Optional, Sequence, Tuple

import torch

from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = [
    "initialize_distributed",
    "distributed_is_initialized",
    "finalize_distributed",
    "cluster_env_hints",
    "host_barrier",
    "host_id",
    "host_count",
    "DEFAULT_TIMEOUT_S",
]

#: the default timeout of the process group and its collectives
DEFAULT_TIMEOUT_S = 600.0

#: environment variables whose presence means the process was launched
#: into a multi-process job (a failed join is then an error)
_CLUSTER_ENV_HINTS = (
    "MASTER_ADDR",
    "TORCHELASTIC_RUN_ID",
    "SLURM_JOB_NUM_NODES",
)


def cluster_env_hints() -> Tuple[str, ...]:
    """The cluster-environment variables set for this process."""
    return tuple(k for k in _CLUSTER_ENV_HINTS if os.environ.get(k))


def _dist():
    return torch.distributed


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    strict: bool = False,
    *,
    backend: str = "nccl",
    device="cuda",
    init_method: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Tuple[int, int]:
    """Join the process group; returns ``(rank, world_size)``.

    The rendezvous is ``init_method`` (or ``coordinator_address`` as
    ``tcp://host:port``) with ``num_processes`` and ``process_id``, or
    else the environment (``env://``).  Without either — no argument and
    no ``MASTER_ADDR`` — it is the one-process run: a no-op that reports
    ``(0, 1)``.  With ``device="cuda"`` the process takes the card
    ``local_device_ids[0]``, or ``LOCAL_RANK`` modulo the cards it sees
    (so several processes on one card share card 0); it raises without
    a card.

    A failed join raises, with the cluster environment it found (never a
    silent fall back to one process).  ``strict`` keeps the reference's
    signature and changes nothing: every failure raises."""
    dist = _dist()
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = resolve_device(device)
    if init_method is None and coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if init_method is None and not os.environ.get("MASTER_ADDR"):
        if num_processes not in (None, 1):
            raise RuntimeError(
                f"num_processes={num_processes} needs a rendezvous: pass "
                "init_method or set MASTER_ADDR/MASTER_PORT")
        return 0, 1
    if dev.type == "cuda":
        if local_device_ids:
            index = int(local_device_ids[0])
        else:
            index = (int(os.environ.get("LOCAL_RANK", "0"))
                     % torch.cuda.device_count())
        torch.cuda.set_device(index)
    kw = dict(backend=backend,
              timeout=datetime.timedelta(seconds=timeout_s))
    if init_method is not None:
        kw.update(init_method=init_method,
                  world_size=1 if num_processes is None else num_processes,
                  rank=0 if process_id is None else process_id)
    else:
        kw.update(init_method="env://")
        if num_processes is not None:
            kw["world_size"] = num_processes
        if process_id is not None:
            kw["rank"] = process_id
    try:
        dist.init_process_group(**kw)
    except (RuntimeError, ValueError) as e:
        hints = cluster_env_hints()
        raise RuntimeError(
            f"process group join failed ({type(e).__name__}: {e})"
            + (f"; cluster environment {', '.join(hints)}" if hints else "")
        ) from e
    return dist.get_rank(), dist.get_world_size()


def distributed_is_initialized() -> bool:
    """Whether this process joined a process group."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def host_barrier(tag: str, step: int = 0) -> None:
    """Block until every process reaches the barrier (a no-op in one
    process).  The chaos ``COLLECTIVE`` site: an injected ``raise``
    stands in for a collective abort, ``stall`` for a straggler."""
    from apex_tpu_torch.resilience import chaos

    chaos.maybe_fail(chaos.COLLECTIVE, step)
    if distributed_is_initialized():
        dist = _dist()
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def host_id() -> int:
    """This process's rank (0 in one process or on a torn-down group)."""
    try:
        return _dist().get_rank() if distributed_is_initialized() else 0
    except (RuntimeError, ValueError):
        return 0


def host_count() -> int:
    """The number of processes (1 in one process)."""
    try:
        return (_dist().get_world_size() if distributed_is_initialized()
                else 1)
    except (RuntimeError, ValueError):
        return 1


def finalize_distributed() -> None:
    """≙ ``destroy_process_group`` (idempotent, best effort: a teardown
    that raises only warns, so a dying run still reaches its final
    checkpoint)."""
    if not distributed_is_initialized():
        return
    try:
        _dist().destroy_process_group()
    except (RuntimeError, ValueError) as e:
        warnings.warn(
            f"destroy_process_group failed mid-teardown "
            f"({type(e).__name__}: {e})", RuntimeWarning, stacklevel=2)

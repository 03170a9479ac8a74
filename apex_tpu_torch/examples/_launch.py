"""The examples' process start: the rendezvous flags and one call that
joins the process group and lays out the model-parallel groups.

A run at world size > 1 starts one process per rank, either under
``torchrun --nproc-per-node N`` (the rendezvous from the environment) or
by hand with ``--init-method file:///shared/path --world-size N --rank
r`` (or ``tcp://host:port``).  ``--backend`` is ``nccl`` by default;
``gloo`` stages the collectives through the host, which also runs
several processes on one card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import argparse

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.parallel import initialize_distributed

__all__ = ["add_distributed_args", "start_distributed"]


def add_distributed_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--backend", default="nccl",
                   help="torch.distributed backend (nccl, or gloo)")
    p.add_argument("--init-method", default=None,
                   help="rendezvous URL (file:// or tcp://); default: "
                   "torchrun's environment, or one process")
    p.add_argument("--world-size", type=int, default=None)
    p.add_argument("--rank", type=int, default=None)


def start_distributed(args, tensor_model_parallel_size: int = 1,
                      **sizes):
    """Join the process group (a no-op for one process without a
    rendezvous) and initialize ``parallel_state`` anew with the given tp
    size and the other sizes ``sizes`` (``pipeline_model_parallel_size``,
    ``context_parallel_size``, ...); returns the mesh."""
    initialize_distributed(
        backend=args.backend, device=args.device,
        init_method=args.init_method, num_processes=args.world_size,
        process_id=args.rank)
    ps.destroy_model_parallel()
    return ps.initialize_model_parallel(tensor_model_parallel_size, **sizes)

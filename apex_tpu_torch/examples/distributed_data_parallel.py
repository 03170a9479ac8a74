"""Minimal data-parallel training — the counterpart of
``examples/simple/distributed/distributed_data_parallel.py``.

One process per rank (the reference's per-GPU launch), each with its
rows of the batch; ``DistributedDataParallel`` averages the gradients
over the world after ``backward()``:

    torchrun --nproc-per-node 2 -m apex_tpu_torch.examples.distributed_data_parallel
    # two processes by hand over a file store, on the CPU:
    python -m apex_tpu_torch.examples.distributed_data_parallel --device cpu \\
        --backend gloo --init-method file:///tmp/ddp-store --world-size 2 --rank 0 &
    python -m apex_tpu_torch.examples.distributed_data_parallel --device cpu \\
        --backend gloo --init-method file:///tmp/ddp-store --world-size 2 --rank 1
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import torch

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.examples._launch import (
    add_distributed_args,
    start_distributed,
)
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.parallel import DistributedDataParallel

D = 16


class Mlp(torch.nn.Module):
    """pred = tanh(x @ w) @ w2, the reference script's model."""

    def __init__(self, generator: torch.Generator, device):
        super().__init__()
        self.w = torch.nn.Parameter(
            (torch.randn(D, D, generator=generator) * 0.3).to(device))
        self.w2 = torch.nn.Parameter(
            (torch.randn(D, D, generator=generator) * 0.3).to(device))

    def forward(self, x, y):
        return ((torch.tanh(x @ self.w) @ self.w2 - y) ** 2).mean()


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Train 20 SGD steps; returns the dp-mean losses."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=20)
    add_distributed_args(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    start_distributed(args)
    dp = ps.get_data_parallel_world_size()
    rank = ps.get_data_parallel_rank()
    print(f"ranks: {dp} ({dev})", flush=True)
    model = Mlp(torch.Generator().manual_seed(0), dev)
    data = torch.Generator().manual_seed(1)
    x = torch.randn(8 * dp, D, generator=data)[rank * 8:(rank + 1) * 8]
    y = torch.randn(8 * dp, D, generator=data)[rank * 8:(rank + 1) * 8]
    ddp = DistributedDataParallel(model)
    step = ddp.make_step(torch.optim.SGD(model.parameters(), lr=0.1))
    losses = []
    for i in range(args.steps):
        losses.append(float(step(x.to(dev), y.to(dev))))
        if i % 5 == 0:
            print(f"step {i:2d}  loss {losses[-1]:.5f}", flush=True)
    print("final loss:", losses[-1], flush=True)
    return losses


if __name__ == "__main__":
    main()

"""Test helpers — counterpart of
``apex_tpu/transformer/testing/commons.py`` (≙
``apex/transformer/testing/commons.py`` :: ``set_random_seed``,
``print_separator``, ``initialize_distributed``, ``IdentityLayer``).

:func:`cpu_mesh` is the reference's one-host world as a context
manager: where the JAX package builds a mesh over the host's CPU
devices, this starts a one-process gloo group (when no process group
exists yet), builds the model-parallel state over it, and tears both
down on exit.  One process is one rank here, so a world of more than one
rank is spawned as processes instead (``tests/torch_dist_workers.py``).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = [
    "set_random_seed",
    "print_separator",
    "initialize_distributed",
    "cpu_mesh",
    "IdentityLayer",
]


def set_random_seed(seed: int) -> torch.Generator:
    """Seed numpy's and torch's global generators (≙
    ``commons.set_random_seed``) and return a CPU generator seeded with
    ``seed`` (the reference returns the key of its seed)."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def print_separator(message: str) -> None:
    """≙ ``commons.print_separator``."""
    print(f"\n{'-' * 31}\n{message:^31}\n{'-' * 31}", flush=True)


def initialize_distributed(tensor_model_parallel_size: int = 1,
                           pipeline_model_parallel_size: int = 1,
                           context_parallel_size: int = 1, **kwargs):
    """(Re)build the model-parallel state over the current process group
    and return its mesh (≙ ``commons.initialize_distributed``; a test
    fixture, distinct from :func:`apex_tpu_torch.parallel.
    initialize_distributed`, which joins the processes)."""
    if ps.model_parallel_is_initialized():
        ps.destroy_model_parallel()
    return ps.initialize_model_parallel(
        tensor_model_parallel_size=tensor_model_parallel_size,
        pipeline_model_parallel_size=pipeline_model_parallel_size,
        context_parallel_size=context_parallel_size, **kwargs)


@contextlib.contextmanager
def cpu_mesh(tensor_model_parallel_size: int = 1,
             pipeline_model_parallel_size: int = 1,
             context_parallel_size: int = 1,
             n_devices: Optional[int] = None):
    """A one-process world with the model-parallel state built over it:
    yields the mesh, destroys the state (and the gloo group it started)
    on exit.  ``n_devices`` may be None or 1: a larger world is that many
    processes."""
    world = (tensor_model_parallel_size * pipeline_model_parallel_size
             * context_parallel_size)
    if n_devices not in (None, 1) or world != 1:
        raise ValueError(
            f"cpu_mesh runs one process (one rank); a world of "
            f"{max(world, n_devices or 1)} ranks is that many processes "
            "(tests/torch_dist_workers.py)")
    started = False
    store = None
    if not dist.is_initialized():
        fd, store = tempfile.mkstemp(prefix="apex_tpu_torch_mesh_")
        os.close(fd)
        os.unlink(store)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=1, rank=0)
        started = True
    try:
        yield initialize_distributed(tensor_model_parallel_size,
                                     pipeline_model_parallel_size,
                                     context_parallel_size)
    finally:
        ps.destroy_model_parallel()
        if started:
            dist.destroy_process_group()
            if store is not None and os.path.exists(store):
                os.unlink(store)


class IdentityLayer(nn.Module):
    """≙ ``commons.IdentityLayer``: a learnable tensor of ``shape``
    (``scale`` times a standard normal draw) that the module returns."""

    def __init__(self, shape, scale: float = 1.0, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.weight = nn.Parameter(scale * torch.randn(
            tuple(shape), generator=generator).to(dev))

    def forward(self):
        return self.weight

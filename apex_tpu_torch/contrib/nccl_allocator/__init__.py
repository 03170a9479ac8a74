"""≙ ``apex/contrib/nccl_allocator`` (counterpart of
``apex_tpu/contrib/nccl_allocator``): explicit no-ops.

The upstream module plugs an ``ncclMemAlloc``-backed allocator into
PyTorch so that NCCL (>= 2.19) can register communication buffers and
skip its staging copies.  This port's collectives run over
``torch.distributed`` process groups on PyTorch's own caching allocator
(and over gloo where a test or the card check spawns workers), so there
is no buffer to register: ``init()`` and the ``nccl_mem`` context do
nothing, and code written against the upstream API runs unchanged.
"""

from __future__ import annotations

import contextlib

__all__ = ["init", "nccl_mem"]


def init(*args, **kwargs) -> None:
    """No-op (see the module docstring)."""


@contextlib.contextmanager
def nccl_mem(*args, **kwargs):
    """No-op context (≙ ``with nccl_allocator.nccl_mem(): ...``)."""
    yield

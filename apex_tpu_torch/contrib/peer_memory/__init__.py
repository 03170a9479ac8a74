"""Halo exchange over a parallel axis — ≙ ``apex/contrib/peer_memory``
(``PeerMemoryPool``, ``PeerHaloExchanger1d``); counterpart of
``apex_tpu/contrib/peer_memory``.

Upstream keeps a pool of CUDA-IPC buffers so that neighbouring GPUs can
write each other's halo rows directly.  Here the exchange is
:func:`apex_tpu_torch.parallel.comm.shift` over the axis's process
group (through the pipeline module's differentiable wrappers: the
backward sends each cotangent back to the rank it came from), and the
pool has nothing to hold: each rank sends its edge rows to its
neighbours and receives theirs, and the ranks at the two ends receive
zeros, as a convolution's zero padding does at the true borders.  With
no group (world 1) both halos are zeros.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.transformer.pipeline_parallel.p2p_communication import (
    send_backward_recv_backward,
    send_forward_recv_forward,
)

__all__ = ["halo_exchange_1d", "PeerHaloExchanger1d", "PeerMemoryPool"]


def halo_exchange_1d(x: torch.Tensor, halo: int, *, axis: int = 1,
                     axis_name: str = "dp") -> torch.Tensor:
    """``x`` (this rank's shard, split along ``axis``: 1 is H in NHWC)
    with ``halo`` rows of each ring neighbour around it: the size along
    ``axis`` grows by ``2 * halo``.  Every rank of ``axis_name`` calls
    it; rank 0's upper halo and the last rank's lower halo are zeros."""
    n = x.shape[axis]
    top = x.narrow(axis, 0, halo)
    bottom = x.narrow(axis, n - halo, halo)
    # bottom rows travel down (r -> r + 1), top rows up (r -> r - 1)
    from_above = send_forward_recv_forward(bottom, axis_name)
    from_below = send_backward_recv_backward(top, axis_name)
    return torch.cat([from_above, x, from_below], dim=axis)


class PeerHaloExchanger1d:
    """≙ ``PeerHaloExchanger1d(ranks, rank_id, peer_pool, half_halo)``:
    calls :func:`halo_exchange_1d` with ``half_halo`` rows along
    ``spatial_axis`` over ``axis_name``."""

    def __init__(self, axis_name: str = "dp", half_halo: int = 1,
                 spatial_axis: int = 1):
        self.axis_name = axis_name
        self.half_halo = half_halo
        self.spatial_axis = spatial_axis

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return halo_exchange_1d(x, self.half_halo, axis=self.spatial_axis,
                                axis_name=self.axis_name)


class PeerMemoryPool:
    """≙ ``PeerMemoryPool``: can be built, holds nothing.  The port
    exchanges halos through process-group collectives, so there are no
    peer buffers to allocate."""

    def __init__(self, *args, **kwargs):
        pass

    def allocate_peer_tensors(self, *args, **kwargs):
        raise NotImplementedError(
            "apex_tpu_torch keeps no CUDA-IPC peer buffers: halos travel "
            "over the axis's process group — use halo_exchange_1d or "
            "PeerHaloExchanger1d")

"""Neighbour send/receive of halos — ≙ ``apex/contrib/nccl_p2p``
(``left_right_halo_exchange``); counterpart of
``apex_tpu/contrib/nccl_p2p``.

Upstream calls ``ncclSend``/``ncclRecv`` directly, around
``torch.distributed``.  Here both directions are
:func:`apex_tpu_torch.parallel.comm.shift` over the axis's group (one
wire, differentiable), with zeros at the global edges.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.contrib.peer_memory import halo_exchange_1d
from apex_tpu_torch.transformer.pipeline_parallel.p2p_communication import (
    send_backward_recv_backward,
    send_forward_recv_forward,
)

__all__ = ["left_right_halo_exchange", "halo_exchange_1d"]


def left_right_halo_exchange(left_output_halo: torch.Tensor,
                             right_output_halo: torch.Tensor,
                             axis_name: str = "dp"):
    """Send this rank's left halo to the left neighbour and its right
    halo to the right one; returns ``(left_input_halo,
    right_input_halo)``, what those neighbours sent (zeros at rank 0's
    left and the last rank's right)."""
    right_input_halo = send_backward_recv_backward(left_output_halo,
                                                   axis_name)
    left_input_halo = send_forward_recv_forward(right_output_halo, axis_name)
    return left_input_halo, right_input_halo

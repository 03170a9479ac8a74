"""Stage-to-stage exchange (counterpart of
``apex_tpu/transformer/pipeline_parallel/p2p_communication.py``, ≙
apex/transformer/pipeline_parallel/p2p_communication.py).

The reference's exchange is ``jax.lax.ppermute`` along the ``pp`` axis:
a collective every rank calls, where each rank sends its value to its
neighbour and a rank with no inbound edge receives **zeros**.  Here it
is :func:`comm.shift <apex_tpu_torch.parallel.comm.shift>` over the
axis's process group (the call log records it as
``collective-permute``), wrapped in an ``autograd.Function`` whose
backward is the inverse shift (``ppermute``'s transpose): the cotangent
goes back to the rank the value came from, and the rank that sent
nothing gets zeros.  The reference's send/recv pairs collapse as in
JAX: ``recv_forward(x)`` ≡ ``send_forward(x)`` ≡ "what this rank
receives from the previous stage when every rank sends ``x``".

All functions take and return a tensor or a tree (dicts, lists,
tuples) of tensors; each leaf is shifted in tree order.
"""

from __future__ import annotations

from typing import Any

import torch

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.analysis.sharding import tree_map
from apex_tpu_torch.parallel import comm

__all__ = [
    "send_forward",
    "recv_forward",
    "send_backward",
    "recv_backward",
    "send_forward_recv_backward",
    "send_backward_recv_forward",
    "send_forward_recv_forward",
    "send_backward_recv_backward",
]

_PP = ps.PIPELINE_PARALLEL_AXIS


class _Shift(torch.autograd.Function):
    """``comm.shift`` by ``delta`` over ``axis_name``; the backward
    shifts the cotangent by ``-delta`` (zeros where nothing comes)."""

    @staticmethod
    def forward(ctx, x, delta, axis_name, cyclic):
        ctx.delta, ctx.axis_name, ctx.cyclic = delta, axis_name, cyclic
        return comm.shift(x, delta, ps.get_group(axis_name), cyclic)

    @staticmethod
    def backward(ctx, g):
        return (comm.shift(g.contiguous(), -ctx.delta,
                           ps.get_group(ctx.axis_name), ctx.cyclic),
                None, None, None)


def _shift(tree: Any, delta: int, axis_name: str, cyclic: bool = False):
    """Every leaf of ``tree`` shifted by ``delta`` ranks of
    ``axis_name`` (differentiable)."""
    return tree_map(lambda x: _Shift.apply(x, delta, axis_name, cyclic),
                    tree)


def send_forward_recv_forward(x, axis_name: str = _PP, cyclic: bool = False):
    """Every rank sends ``x`` to the next stage; returns what this rank
    receives from the previous (zeros at stage 0 unless ``cyclic``)."""
    return _shift(x, +1, axis_name, cyclic)


def send_backward_recv_backward(g, axis_name: str = _PP, cyclic: bool = False):
    """Every rank sends ``g`` to the previous stage; returns what this rank
    receives from the next (zeros at the last stage unless ``cyclic``)."""
    return _shift(g, -1, axis_name, cyclic)


# Reference-shaped aliases (see module docstring on the collective collapse).
send_forward = send_forward_recv_forward
recv_forward = send_forward_recv_forward
send_backward = send_backward_recv_backward
recv_backward = send_backward_recv_backward


def send_forward_recv_backward(output, grad, axis_name: str = _PP):
    """1F1B steady-state edge: push activations down, pull grads up.
    Returns ``(recv_activation, recv_grad)``, two shifts in that
    order (≙ the batched isend/irecv pair)."""
    return (
        send_forward_recv_forward(output, axis_name),
        send_backward_recv_backward(grad, axis_name),
    )


def send_backward_recv_forward(grad, output, axis_name: str = _PP):
    """Mirror of :func:`send_forward_recv_backward`."""
    return (
        send_backward_recv_backward(grad, axis_name),
        send_forward_recv_forward(output, axis_name),
    )

"""The collective autograd primitives tensor parallelism is built on.

Counterpart of ``apex_tpu/transformer/tensor_parallel/mappings.py``
(≙ apex's ``mappings.py``): each wrapper is a
``torch.autograd.Function`` whose backward is the other collective of
its pair, as the reference's ``custom_vjp``\\ s (``_make_vjp``):

===================================================  =========  =========
wrapper                                              forward    backward
===================================================  =========  =========
``copy_to_tensor_model_parallel_region``             identity   all-reduce
``reduce_from_tensor_model_parallel_region``         all-reduce identity
``scatter_to_tensor_model_parallel_region``          split(-1)  gather(-1)
``gather_from_tensor_model_parallel_region``         gather(-1) split(-1)
``scatter_to_sequence_parallel_region``              split(0)   gather(0)
``gather_from_sequence_parallel_region``             gather(0)  reduce-scatter(0)
                                                                or split(0)
``reduce_scatter_to_sequence_parallel_region``       rs(0)      gather(0)
===================================================  =========  =========

They run on the process group of ``axis_name`` (``tp`` by default;
sequence parallelism uses the tp group, as in the reference).  On an
axis of size 1 — and before ``initialize_model_parallel`` — every
wrapper is the identity and issues no collective.  An all-reduce works
on a copy: reducing a tensor that autograd saved would corrupt the
backward.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.parallel import comm

__all__ = [
    "_reduce",
    "_split_along_last_dim",
    "_gather_along_last_dim",
    "_split_along_first_dim",
    "_gather_along_first_dim",
    "_reduce_scatter_along_first_dim",
    "copy_to_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "scatter_to_sequence_parallel_region",
    "gather_from_sequence_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "allreduce_sequence_parallel_gradients",
]

_TP = ps.TENSOR_PARALLEL_AXIS


# ---------------------------------------------------------------------------
# raw ops (the reference's underscore helpers)
# ---------------------------------------------------------------------------


def _reduce(x, axis_name=_TP):
    group = ps.get_group(axis_name)
    if group is None:
        return x
    return comm.all_reduce(x.clone(memory_format=torch.contiguous_format),
                           group)


def _split_along_last_dim(x, axis_name=_TP):
    world = ps.axis_size(axis_name)
    if world == 1:
        return x
    chunk = ps.divide(x.shape[-1], world)
    return x.narrow(-1, ps.axis_rank(axis_name) * chunk, chunk).contiguous()


def _gather_along_last_dim(x, axis_name=_TP):
    world = ps.axis_size(axis_name)
    if world == 1:
        return x
    out = x.new_empty((world,) + tuple(x.shape))
    comm.all_gather_into(out.view(-1), x.reshape(-1), ps.get_group(axis_name))
    return torch.cat(out.unbind(0), dim=-1)


def _split_along_first_dim(x, axis_name=_TP):
    world = ps.axis_size(axis_name)
    if world == 1:
        return x
    chunk = ps.divide(x.shape[0], world)
    return x.narrow(0, ps.axis_rank(axis_name) * chunk, chunk).contiguous()


def _gather_along_first_dim(x, axis_name=_TP):
    world = ps.axis_size(axis_name)
    if world == 1:
        return x
    out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
    return comm.all_gather_into(out, x, ps.get_group(axis_name))


def _reduce_scatter_along_first_dim(x, axis_name=_TP):
    world = ps.axis_size(axis_name)
    if world == 1:
        return x
    out = x.new_empty((ps.divide(x.shape[0], world),) + tuple(x.shape[1:]))
    return comm.reduce_scatter_into(out, x, ps.get_group(axis_name))


# ---------------------------------------------------------------------------
# autograd wrappers
# ---------------------------------------------------------------------------


def _make_fn(fwd_op, bwd_op, name):
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return fwd_op(x, axis_name)

    def backward(ctx, g):
        return bwd_op(g, ctx.axis_name), None

    fn = type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward),
        "backward": staticmethod(backward),
    })

    def apply(x, axis_name=_TP):
        return fn.apply(x, axis_name)

    apply.__name__ = apply.__qualname__ = name
    return apply


def _identity(x, axis_name):
    return x


copy_to_tensor_model_parallel_region = _make_fn(
    _identity, _reduce, "copy_to_tensor_model_parallel_region")
reduce_from_tensor_model_parallel_region = _make_fn(
    _reduce, _identity, "reduce_from_tensor_model_parallel_region")
scatter_to_tensor_model_parallel_region = _make_fn(
    _split_along_last_dim, _gather_along_last_dim,
    "scatter_to_tensor_model_parallel_region")
gather_from_tensor_model_parallel_region = _make_fn(
    _gather_along_last_dim, _split_along_last_dim,
    "gather_from_tensor_model_parallel_region")
scatter_to_sequence_parallel_region = _make_fn(
    _split_along_first_dim, _gather_along_first_dim,
    "scatter_to_sequence_parallel_region")
_gather_from_sequence_parallel_region_rs_grad = _make_fn(
    _gather_along_first_dim, _reduce_scatter_along_first_dim,
    "gather_from_sequence_parallel_region")
_gather_from_sequence_parallel_region_split_grad = _make_fn(
    _gather_along_first_dim, _split_along_first_dim,
    "gather_from_sequence_parallel_region_split_grad")
reduce_scatter_to_sequence_parallel_region = _make_fn(
    _reduce_scatter_along_first_dim, _gather_along_first_dim,
    "reduce_scatter_to_sequence_parallel_region")


def gather_from_sequence_parallel_region(
    x, axis_name=_TP, tensor_parallel_output_grad: bool = True
):
    """All-gather along the sequence dim.  The backward follows how the
    gathered output is consumed:

    - ``tensor_parallel_output_grad=True`` (default): by tensor-parallel
      computation whose cotangents are partial per tp rank (a
      vocab-sharded logits product) — reduce-scatter, summing the
      partials into this rank's rows;
    - False: by replicated computation (every rank computes the same
      full-sequence values, as a replicated pooler) — the cotangent is
      already whole on every rank, so take this rank's rows; a
      reduce-scatter would count it tp times."""
    if tensor_parallel_output_grad:
        return _gather_from_sequence_parallel_region_rs_grad(x, axis_name)
    return _gather_from_sequence_parallel_region_split_grad(x, axis_name)


@torch.no_grad()
def allreduce_sequence_parallel_gradients(params, axis_name: str = _TP,
                                          strict: bool = True):
    """Sum over tp, in place, the ``.grad`` of the parameters registered
    as sequence-parallel (``parallel_state.
    register_sequence_parallel_param``) among ``params`` (a module or
    an iterable of parameters); every other gradient is left alone.
    Call after ``backward()`` and beside the dp sync whenever the model
    ran with ``sequence_parallel=True`` at tp > 1.  Returns the count of
    gradients summed.

    ``strict=True`` raises when a registered parameter is not among
    ``params`` (a stale registry, or the wrong parameters passed), where
    it would otherwise under-sync in silence."""
    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    marked = ps.sequence_parallel_params()
    if not marked:
        return 0
    ids = {id(p) for p in params}
    missing = [p for p in marked if id(p) not in ids]
    if strict and missing:
        raise ValueError(
            f"sequence-parallel gradient sync: {len(missing)} registered "
            "parameter(s) are not among the parameters passed. The "
            "registry is stale or the wrong parameters were passed — call "
            "parallel_state.destroy_model_parallel() and rebuild, or pass "
            "strict=False if this is intentionally a part of the model"
        )
    group = ps.get_group(axis_name)
    n = 0
    for p in marked:
        if id(p) in ids and p.grad is not None:
            comm.all_reduce(p.grad, group)
            n += 1
    return n

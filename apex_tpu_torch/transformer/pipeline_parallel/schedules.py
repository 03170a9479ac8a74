"""Pipeline schedules and the activation-checkpoint policies the models
share.

Counterpart of ``apex_tpu/transformer/pipeline_parallel/schedules.py``
(≙ apex/transformer/pipeline_parallel/schedules/).

**The remat policies** (``SUMS_SAVE_NAMES``, ``resolve_remat_policy``).
A checkpointed block saves nothing in the forward and recomputes in the
backward what its policy does not save:

- ``"full"`` (or None): save nothing, recompute everything;
- ``"dots"``: save the outputs of matrix products without batch
  dimensions (``aten.mm`` and ``aten.addmm``: every ``nn.Linear``-style
  product; not ``aten.bmm``), as ``dots_with_no_batch_dims_saveable``;
- ``"sums"``: save only the tensors tagged with one of
  :data:`SUMS_SAVE_NAMES` (the QKV and first MLP products and the two
  residual sums of each block), as ``save_only_these_names``.

The policies run on PyTorch's selective checkpoint
(``torch.utils.checkpoint.create_selective_checkpoint_contexts``): its
dispatch mode asks the policy about every aten op of the block's forward
and caches the outputs of the ops to save, which the recompute then
reads instead of running them.  PyTorch has no ``checkpoint_name``, so
:func:`checkpoint_name` tags by scope: a tag is the one op a ``with
checkpoint_name(name):`` block runs (the bias add that ends a product,
or a residual sum), and the policy saves the ops run in a scope whose
name it holds.  This keeps the block one checkpoint, as in the
reference, instead of splitting it into segments at the tags; the
values never change, only what is recomputed.  Two differences from
XLA's rematerialisation remain: the recompute replays the block's whole
forward in order, so under ``"sums"`` the products that feed only a
saved sum are computed again; and a kernel launched through ``ctypes``
(K1, K3) is invisible to the dispatch mode, which sees only the
allocation of its outputs: such an op is always recomputed.

**The schedules** keep the reference's signatures and return
``(losses, grads)``: ``losses`` the per-microbatch loss vector (f32,
summed over pp so every stage holds it) and ``grads`` a tree like
``params`` (None under ``forward_only``), the gradient of the mean
loss ``sum(losses) / nm``.  ``stage_fn(params, x) -> y`` runs this
rank's stage on activation-shaped ``x`` (``params`` a tree of tensors,
for example :func:`apex_tpu_torch.train.trainer.module_loss` over a
stage module); ``loss_fn(y, target)`` (or ``loss_fn(params, y,
target)`` with ``loss_takes_params=True``, Megatron's post-process rank
computing the loss through its output layer) runs on the last stage.
``batch = (inputs, targets)``, leaves stacked ``(num_microbatches,
...)``.

The design is not the reference's.  JAX runs every rank in lockstep
through one traced scan and gets the backward from ``jax.grad``; here
each rank is a process, so the schedules are the Apex/Megatron ones:
explicit ticks with host-integer rank gating, per-microbatch forwards
whose outputs (their autograd graphs) are kept until their cotangent
arrives, and ``torch.autograd.backward(output, grad)`` on it.  The
ticks follow the reference's hand-scheduled timetable (rank ``r``
forwards chunk ``c`` of microbatch ``m = g·pp + j`` at tick ``g·pp·vpp
+ c·pp + j + r`` and backwards it ``V − 1 − v`` ticks after the last
virtual stage forwarded it, ``V = pp·vpp``, ``v = c·pp + r``) in three
phases: warmup (``V − 1`` forward-only ticks), steady 1F1B (a forward
and a backward each tick) and cooldown (``V − 1`` backward-only
ticks).  Every tick ends with the same shifts on every rank —
activations one stage down, then cotangents one stage up
(:func:`comm.shift`, cyclic under interleaving) — so the ranks' calls
always pair up; a rank with nothing to send that tick sends zeros.

What each schedule keeps (its memory strategy; the values are the
same):

- :func:`forward_backward_pipelining_1f1b` and
  :func:`forward_backward_pipelining_interleaved_1f1b`: ``stash=
  "residuals"`` keeps each in-flight microbatch's autograd graph,
  ``stash="input"`` only its stage input, and the backward re-runs the
  stage forward first (the ~4/3 recompute premium);
- :func:`forward_backward_pipelining_without_interleaving` and
  :func:`forward_backward_pipelining_with_interleaving` keep the
  graphs of stages wrapped in the per-tick checkpoint (``remat=True``
  by default: only the stage inputs and what ``remat_policy`` saves).
  ``carry_chunk`` chooses how JAX's scan saves its carries; there is no
  scan here, so it is validated and has no effect;
- :func:`forward_backward_no_pipelining`: microbatches in order, each
  backwarded at once.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.analysis.sharding import tree_leaves, tree_map
from apex_tpu_torch.parallel import comm

__all__ = [
    "SUMS_SAVE_NAMES",
    "checkpoint_name",
    "resolve_remat_policy",
    "remat",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_pipelining_1f1b",
    "forward_backward_pipelining_with_interleaving",
    "forward_backward_pipelining_interleaved_1f1b",
    "get_forward_backward_func",
]

_PP = ps.PIPELINE_PARALLEL_AXIS

#: the tags the "sums" policy saves (the models tag these in their
#: blocks)
SUMS_SAVE_NAMES = (
    "bert_qkv", "bert_fc1", "bert_sum_attn", "bert_sum_mlp",
    "gpt_qkv", "gpt_fc1", "gpt_sum_attn", "gpt_sum_mlp",
)

#: aten ops of matrix products without batch dimensions
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

_TAG: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "apex_tpu_torch_checkpoint_name", default=None)


@contextlib.contextmanager
def checkpoint_name(name: Optional[str]):
    """Tag the outputs of the ops run inside the block with ``name``
    (None: no tag).  Inert unless a checkpoint policy selects the name:
    keep one op in the block, the one whose output carries the tag."""
    token = _TAG.set(name)
    try:
        yield
    finally:
        _TAG.reset(token)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_names(names, ctx, op, *args, **kwargs):
    if _TAG.get() in names:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(name) -> Optional[Callable]:
    """The one ``"full"``/``"dots"``/``"sums"`` resolution the models
    share: None (recompute everything) for ``None`` or ``"full"``, else
    the selective-checkpoint policy function ``(ctx, op, *args,
    **kwargs) -> CheckpointPolicy``."""
    if name in (None, "full"):
        return None
    if name == "dots":
        return _save_dots
    if name == "sums":
        return functools.partial(_save_names, frozenset(SUMS_SAVE_NAMES))
    raise ValueError(f"unknown remat_policy {name!r}")


def remat(fn, *args, policy: Optional[Callable] = None,
          preserve_rng_state: bool = True):
    """``fn(*args)`` under a non-reentrant checkpoint that saves what
    ``policy`` (:func:`resolve_remat_policy`) selects, or nothing.  The
    recompute runs under the amp cast policy active now
    (:func:`apex_tpu_torch.amp.lists.carry_policy`)."""
    from apex_tpu_torch.amp.lists import carry_policy

    fn = carry_policy(fn)
    kwargs = {}
    if policy is not None:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **kwargs)


# ---------------------------------------------------------------------------
# the pipeline schedules
# ---------------------------------------------------------------------------

#: the schedules' "dots": every product's output (``checkpoint_dots``),
#: batched ones too — a stage sees one microbatch
_ALL_DOTS = _DOTS + (torch.ops.aten.bmm.default,
                     torch.ops.aten.baddbmm.default)


def _save_all_dots(ctx, op, *args, **kwargs):
    if op in _ALL_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _wrap_remat(fn, remat_on: bool, remat_policy=None):
    """The per-tick stage checkpoint: ``fn`` itself, or ``fn`` under
    :func:`remat` with ``remat_policy`` ("dots" is the schedules'
    broader ``checkpoint_dots``, as in the reference)."""
    if not remat_on:
        return fn
    policy = (_save_all_dots if remat_policy == "dots"
              else resolve_remat_policy(remat_policy))
    return lambda p, x: remat(fn, p, x, policy=policy)


def _three_arg_loss(loss_fn, loss_takes_params):
    return loss_fn if loss_takes_params else (lambda p, y, t: loss_fn(y, t))


def _check_carry_chunk(carry_chunk) -> None:
    """``carry_chunk`` sizes the reference's two-level checkpointed scan
    (a memory strategy); nothing here has that scan, so only its type
    is checked."""
    if carry_chunk is not None and (isinstance(carry_chunk, bool)
                                    or not isinstance(carry_chunk, int)):
        raise TypeError(f"carry_chunk must be an int or None, got "
                        f"{carry_chunk!r}")


def _leaf_params(params, want_grad: bool):
    """Detached leaves over the caller's tensors that collect this
    schedule's gradients (floating leaves only)."""
    return tree_map(
        lambda t: t.detach().requires_grad_(want_grad
                                            and t.is_floating_point()),
        params)


def _grads_of(leaves):
    return tree_map(lambda t: t.grad if t.grad is not None
                    else torch.zeros_like(t), leaves)


def _microbatch(tree, m: int):
    return tree_map(lambda x: x[m], tree)


def forward_backward_no_pipelining(
    stage_fn: Callable,
    loss_fn: Callable,
    params,
    batch: Tuple[Any, Any],
    *,
    num_microbatches: int,
    axis_name: str = _PP,
    forward_only: bool = False,
    remat: bool = False,
    remat_policy=None,
    loss_takes_params: bool = False,
):
    """≙ fwd_bwd_no_pipelining.py: the microbatches in order, each one's
    loss backwarded at once with weight ``1 / nm`` (the gradients
    accumulate), on one stage.  ``axis_name`` is unused (kept for the
    shared signature)."""
    inputs, targets = batch
    nm = num_microbatches
    run = _wrap_remat(stage_fn, remat, remat_policy)
    lfn = _three_arg_loss(loss_fn, loss_takes_params)
    p = _leaf_params(params, not forward_only)
    losses = []
    with torch.set_grad_enabled(not forward_only):
        for m in range(nm):
            loss = lfn(p, run(p, _microbatch(inputs, m)),
                       _microbatch(targets, m))
            if not forward_only:
                (loss / nm).backward()
            losses.append(loss.detach().float())
    losses = torch.stack(losses)
    return losses, (None if forward_only else _grads_of(p))


class _Ticks:
    """One rank's explicit pipeline over ``vpp`` model chunks: the
    timetable, the stash of in-flight microbatches and the shifts (see
    the module docstring).  ``p`` holds this rank's leaves (stacked on
    a leading chunk axis when ``vpp > 1``)."""

    def __init__(self, run, lfn, p, inputs, targets, nm, vpp, axis_name,
                 forward_only, stash):
        self.run, self.lfn, self.p = run, lfn, p
        self.inputs, self.targets = inputs, targets
        self.nm, self.vpp = nm, vpp
        self.forward_only, self.stash = forward_only, stash
        self.pp = ps.axis_size(axis_name)
        self.rank = ps.axis_rank(axis_name)
        self.group = ps.get_group(axis_name)
        self.V = self.pp * vpp
        self.cyclic = vpp > 1
        self.h0 = tree_map(lambda x: torch.zeros_like(x[0]), inputs)
        self.losses = torch.zeros(nm, dtype=torch.float32,
                                  device=tree_leaves(self.h0)[0].device)
        self.inflight = {}

    def chunk(self, c: int):
        return self.p if self.vpp == 1 else tree_map(lambda t: t[c], self.p)

    def finishing(self, c: int) -> bool:
        """Whether chunk ``c`` on this rank is the last virtual stage."""
        return self.rank == self.pp - 1 and c == self.vpp - 1

    def _shift(self, tree, delta):
        return tree_map(
            lambda a: comm.shift(a.contiguous(), delta, self.group,
                                 self.cyclic), tree)

    def _stage(self, c, m, x):
        """``(y, loss)`` of chunk ``c`` on ``x`` (loss None off the last
        virtual stage); the loss enters ``losses[m]``."""
        p = self.chunk(c)
        y = self.run(p, x)
        loss = None
        if self.finishing(c):
            loss = self.lfn(p, y, _microbatch(self.targets, m))
        return y, loss

    def forward(self, c: int, m: int, x):
        injected = self.rank == 0 and c == 0
        if injected:
            x = _microbatch(self.inputs, m)
        grad = not self.forward_only and self.stash == "residuals"
        xin = tree_map(lambda a: a.detach().requires_grad_(
            grad and not injected and a.is_floating_point()), x)
        with torch.set_grad_enabled(grad):
            y, loss = self._stage(c, m, xin)
        if loss is not None:
            self.losses[m] += loss.detach().float()
        if not self.forward_only:
            self.inflight[(m, c)] = (xin, y, loss, injected)
        got = [(a.shape, a.dtype) for a in tree_leaves(y)]
        if got != [(a.shape, a.dtype) for a in tree_leaves(self.h0)]:
            raise ValueError(
                f"stage_fn must return activations shaped like its inputs "
                f"(the uniform-stage contract): got {got}")
        return tree_map(lambda a: a.detach(), y)

    def backward(self, c: int, m: int, g):
        xin, y, loss, injected = self.inflight.pop((m, c))
        if self.stash == "input":
            xin = tree_map(lambda a: a.detach().requires_grad_(
                not injected and a.is_floating_point()), xin)
            with torch.enable_grad():
                y, loss = self._stage(c, m, xin)
        if loss is not None:
            (loss / self.nm).backward()
        else:
            pairs = [(a, b) for a, b in zip(tree_leaves(y), tree_leaves(g))
                     if a.requires_grad]
            if pairs:
                torch.autograd.backward([a for a, _ in pairs],
                                        [b.to(a.dtype) for a, b in pairs])
        return tree_map(lambda a: a.grad if a.grad is not None
                        else torch.zeros_like(a), xin)

    def run_all(self):
        nm, vpp, pp, V, r = self.nm, self.vpp, self.pp, self.V, self.rank
        end_fwd = nm * vpp + pp - 1
        total = end_fwd if self.forward_only else nm * vpp + V + pp - 2
        h_recv = g_recv = self.h0
        for t in range(total):
            do_fwd = t < end_fwd
            do_bwd = not self.forward_only and t >= V - 1
            y_send = dx_send = self.h0
            if do_fwd:
                u = t - r
                if 0 <= u < nm * vpp:
                    c, m = (u % V) // pp, (u // V) * pp + u % pp
                    y_send = self.forward(c, m, h_recv)
            if do_bwd:
                w = t + r - (V + pp - 2)
                if 0 <= w < nm * vpp:
                    c = vpp - 1 - (w % V) // pp
                    m = (w // V) * pp + w % pp
                    dx_send = self.backward(c, m, g_recv)
            if do_fwd:
                h_recv = self._shift(y_send, +1)
            if do_bwd:
                g_recv = self._shift(dx_send, -1)
        if self.inflight:
            raise RuntimeError(f"microbatches never backwarded: "
                               f"{sorted(self.inflight)}")
        return comm.all_reduce(self.losses, self.group)


def _pipeline(stage_fn, loss_fn, params, batch, *, nm, vpp, axis_name,
              forward_only, remat_on, remat_policy, loss_takes_params,
              stash):
    inputs, targets = batch
    p = _leaf_params(params, not forward_only)
    ticks = _Ticks(_wrap_remat(stage_fn, remat_on, remat_policy),
                   _three_arg_loss(loss_fn, loss_takes_params), p, inputs,
                   targets, nm, vpp, axis_name, forward_only, stash)
    losses = ticks.run_all()
    return losses, (None if forward_only else _grads_of(p))


def _check_stash(stash: str) -> None:
    if stash not in ("residuals", "input"):
        raise ValueError(f"unknown stash mode {stash!r}")


def _resolve_chunks(num_model_chunks) -> int:
    if num_model_chunks is None:
        num_model_chunks = ps.get_virtual_pipeline_model_parallel_world_size()
    if num_model_chunks is None or num_model_chunks < 1:
        raise ValueError("num_model_chunks (virtual pipeline size) required")
    return num_model_chunks


def _check_interleaving(nm: int, axis_name: str) -> None:
    pp = ps.axis_size(axis_name)
    if nm % pp != 0:
        raise ValueError(
            f"interleaved schedule requires num_microbatches ({nm}) to "
            f"be a multiple of pipeline_parallel_size ({pp})"
        )


def forward_backward_pipelining_without_interleaving(
    stage_fn: Callable,
    loss_fn: Callable,
    params,
    batch: Tuple[Any, Any],
    *,
    num_microbatches: int,
    axis_name: str = _PP,
    forward_only: bool = False,
    remat: bool = True,
    remat_policy=None,
    carry_chunk: Optional[int] = None,
    loss_takes_params: bool = False,
):
    """≙ fwd_bwd_pipelining_without_interleaving.py (1F1B): ``params``
    are this rank's stage; ``nm + 2(pp − 1)`` ticks, each stage wrapped
    in the per-tick checkpoint under ``remat`` (its graph then holds
    the stage input and what ``remat_policy`` saves).  ``carry_chunk``
    has no effect on values (module docstring)."""
    _check_carry_chunk(carry_chunk)
    return _pipeline(stage_fn, loss_fn, params, batch, nm=num_microbatches,
                     vpp=1, axis_name=axis_name, forward_only=forward_only,
                     remat_on=remat, remat_policy=remat_policy,
                     loss_takes_params=loss_takes_params, stash="residuals")


def forward_backward_pipelining_1f1b(
    stage_fn: Callable,
    loss_fn: Callable,
    params,
    batch: Tuple[Any, Any],
    *,
    num_microbatches: int,
    axis_name: str = _PP,
    forward_only: bool = False,
    stash: str = "residuals",
    remat: bool = False,
    remat_policy=None,
    loss_takes_params: bool = False,
):
    """The hand-scheduled 1F1B: stage ``s`` forwards microbatch ``m`` at
    tick ``m + s`` and backwards it at tick ``2(pp − 1) − s + m``, at
    most ``2(pp − 1 − s) + 1`` microbatches in flight.  ``stash``
    selects what an in-flight microbatch keeps: ``"residuals"`` its
    autograd graph (the backward replays nothing), ``"input"`` only its
    stage input (the backward re-runs the stage forward first)."""
    _check_stash(stash)
    return _pipeline(stage_fn, loss_fn, params, batch, nm=num_microbatches,
                     vpp=1, axis_name=axis_name, forward_only=forward_only,
                     remat_on=remat, remat_policy=remat_policy,
                     loss_takes_params=loss_takes_params, stash=stash)


def forward_backward_pipelining_interleaved_1f1b(
    stage_fn: Callable,
    loss_fn: Callable,
    params,
    batch: Tuple[Any, Any],
    *,
    num_microbatches: int,
    num_model_chunks: Optional[int] = None,
    axis_name: str = _PP,
    forward_only: bool = False,
    stash: str = "residuals",
    remat: bool = False,
    remat_policy=None,
    loss_takes_params: bool = False,
):
    """The hand-scheduled interleaved 1F1B over ``num_model_chunks``
    virtual stages: ``params`` hold this rank's chunks stacked on a
    leading axis (rank ``r`` owns virtual stages ``r, r + pp, ...``).
    Warmup ``V − 1`` forward-only ticks, steady ``nm·vpp + pp − V``
    ticks of one chunk forward and one chunk backward, cooldown ``V −
    1`` backward-only ticks (the Megatron bubble ``(pp − 1)/vpp``); the
    shifts are cyclic, so a chunk's output on rank ``pp − 1`` reaches
    rank 0's next chunk and the cotangents wrap back.  Requires
    ``num_microbatches % pp == 0``; ``stash`` as in
    :func:`forward_backward_pipelining_1f1b`."""
    _check_stash(stash)
    vpp = _resolve_chunks(num_model_chunks)
    _check_interleaving(num_microbatches, axis_name)
    return _pipeline(stage_fn, loss_fn, params, batch, nm=num_microbatches,
                     vpp=vpp, axis_name=axis_name, forward_only=forward_only,
                     remat_on=remat, remat_policy=remat_policy,
                     loss_takes_params=loss_takes_params, stash=stash)


def forward_backward_pipelining_with_interleaving(
    stage_fn: Callable,
    loss_fn: Callable,
    params,
    batch: Tuple[Any, Any],
    *,
    num_microbatches: int,
    num_model_chunks: Optional[int] = None,
    axis_name: str = _PP,
    forward_only: bool = False,
    remat: bool = True,
    remat_policy=None,
    carry_chunk: Optional[int] = None,
    loss_takes_params: bool = False,
):
    """≙ fwd_bwd_pipelining_with_interleaving.py (virtual stages): the
    interleaved timetable of
    :func:`forward_backward_pipelining_interleaved_1f1b` with each chunk
    wrapped in the per-tick checkpoint under ``remat``.  Requires
    ``num_microbatches % pp == 0``; ``carry_chunk`` has no effect on
    values."""
    _check_carry_chunk(carry_chunk)
    vpp = _resolve_chunks(num_model_chunks)
    _check_interleaving(num_microbatches, axis_name)
    return _pipeline(stage_fn, loss_fn, params, batch, nm=num_microbatches,
                     vpp=vpp, axis_name=axis_name, forward_only=forward_only,
                     remat_on=remat, remat_policy=remat_policy,
                     loss_takes_params=loss_takes_params, stash="residuals")


def get_forward_backward_func(
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    pipeline_model_parallel_size: Optional[int] = None,
    hand_scheduled: bool = False,
):
    """≙ schedules/__init__.py :: get_forward_backward_func.
    ``hand_scheduled=True`` picks the explicit-stash schedules:
    :func:`forward_backward_pipelining_1f1b` without virtual stages,
    :func:`forward_backward_pipelining_interleaved_1f1b` with them."""
    if pipeline_model_parallel_size is None and ps.model_parallel_is_initialized():
        pipeline_model_parallel_size = ps.get_pipeline_model_parallel_world_size()
    if virtual_pipeline_model_parallel_size is None and ps.model_parallel_is_initialized():
        virtual_pipeline_model_parallel_size = (
            ps.get_virtual_pipeline_model_parallel_world_size()
        )
    if (pipeline_model_parallel_size or 1) <= 1:
        return forward_backward_no_pipelining
    if virtual_pipeline_model_parallel_size is not None:
        return functools.partial(
            forward_backward_pipelining_interleaved_1f1b
            if hand_scheduled
            else forward_backward_pipelining_with_interleaving,
            num_model_chunks=virtual_pipeline_model_parallel_size,
        )
    if hand_scheduled:
        return forward_backward_pipelining_1f1b
    return forward_backward_pipelining_without_interleaving

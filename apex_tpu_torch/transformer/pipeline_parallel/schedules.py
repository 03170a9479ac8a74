"""The activation-checkpoint policies the models share.

Counterpart of the policy part of
``apex_tpu/transformer/pipeline_parallel/schedules.py``
(``SUMS_SAVE_NAMES``, ``resolve_remat_policy``); the pipeline schedules
themselves are not ported yet.  A checkpointed block saves nothing in
the forward and recomputes in the backward what its policy does not
save:

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
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

__all__ = [
    "SUMS_SAVE_NAMES",
    "checkpoint_name",
    "resolve_remat_policy",
    "remat",
]

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
    ``policy`` (:func:`resolve_remat_policy`) selects, or nothing."""
    kwargs = {}
    if policy is not None:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **kwargs)

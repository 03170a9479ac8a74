"""ASP, automatic structured (2:4) sparsity — ≙ ``apex/contrib/sparsity``
(``ASP``, ``create_mask``, the permutation search); counterpart of
``apex_tpu/contrib/sparsity``.

The mask math is the reference's: in every aligned group of 4 weights
along the matmul's reduction (input) axis, keep the 2 of largest
magnitude.  Ties keep the later indices, as the reference's stable
``jnp.argsort`` does (``torch.argsort(stable=True)`` here), so a tied
group such as all ones keeps its last two.  In PyTorch's layout the
input axis is 1, for a ``Linear``'s ``(out, in)`` and a convolution's
``(O, I, KH, KW)`` alike (an embedding's ``(V, H)`` prunes along H); a
weight is pruned by default when both its out and in widths are at
least 16 and the input width divides by 4.

This differs from the reference on one tree (ROADMAP C15): its ASP
picks the axis from the leaf's name (``kernel`` as flax's ``(in,
out)``, anything else as ``(out, in)``), so on its own GPT, whose
``(in, out)`` products are named ``weight``, it keeps 2 of 4 along the
output axis, against its own docstring.  The port prunes the input axis
everywhere; on ResNet-50, where the reference's axis is right, both
give the same masks.

The functions take a ``Mapping[str, Tensor]`` such as
``dict(model.named_parameters())``.  An unpruned entry's mask is a 0-d
``True`` tensor, which :meth:`ASP.apply_masks` passes through.  The
masks prune the forward's weights; the matmuls stay dense (the kernels'
2:4 sparse tensor-core paths are not used).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from apex_tpu_torch.contrib.sparsity.permutation import (  # noqa: F401
    apply_permutation,
    invert_permutation,
    permutation_retained_magnitude,
    search_channel_permutation,
)

__all__ = [
    "create_mask",
    "ASP",
    "search_channel_permutation",
    "permutation_retained_magnitude",
    "apply_permutation",
    "invert_permutation",
]

#: the matmul's reduction axis in PyTorch's weight layouts
INPUT_AXIS = 1


def create_mask(weight: torch.Tensor, pattern: str = "m4n2_1d",
                axis: int = -1) -> torch.Tensor:
    """≙ ``sparse_masklib.create_mask``: a bool mask keeping the 2
    largest ``|w|`` of every aligned group of 4 along ``axis`` (whose
    length must divide by 4)."""
    if pattern not in ("m4n2_1d", "m4n2"):
        raise ValueError(f"unsupported sparsity pattern {pattern!r}")
    axis = axis % weight.ndim
    w = weight.movedim(axis, -1)
    k = w.shape[-1]
    if k % 4:
        raise ValueError(f"pruned axis length ({k}) must be divisible by 4")
    mag = w.float().abs().reshape(*w.shape[:-1], k // 4, 4)
    # each entry's rank within its group; keep the two largest
    order = torch.argsort(mag, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return (ranks >= 2).reshape(w.shape).movedim(-1, axis)


def _default_allowed(name: str, weight: torch.Tensor) -> bool:
    """Linear, convolution and embedding weights whose out and in widths
    are both at least 16 (the reference's whitelist, read in PyTorch's
    layout), with an input width divisible by 4."""
    if weight.ndim < 2 or "weight" not in name:
        return False
    if weight.shape[0] < 16 or weight.shape[INPUT_AXIS] < 16:
        return False
    return weight.shape[INPUT_AXIS] % 4 == 0


Allowed = Callable[[str, torch.Tensor], bool]


class ASP:
    """≙ ``apex.contrib.sparsity.ASP`` over named tensors.  Workflow (as
    upstream's ``prune_trained_model(model, optimizer)`` hooks it)::

        params = dict(model.named_parameters())
        masks = ASP.compute_sparse_masks(params)   # one-time search
        ASP.apply_masks_(params, masks)            # zero the pruned half
        ...  # each step:
        loss.backward()
        ASP.apply_masks_({n: p.grad for n, p in params.items()}, masks)
        optimizer.step()
        ASP.apply_masks_(params, masks)            # keep the update sparse
    """

    @staticmethod
    def compute_sparse_masks(params: Mapping[str, torch.Tensor],
                             allowed: Optional[Allowed] = None,
                             pattern: str = "m4n2_1d"
                             ) -> Dict[str, torch.Tensor]:
        allowed = allowed or _default_allowed
        return {name: (create_mask(w.detach(), pattern, axis=INPUT_AXIS)
                       if allowed(name, w)
                       else torch.ones((), dtype=torch.bool, device=w.device))
                for name, w in params.items()}

    @staticmethod
    def apply_masks(tree: Mapping[str, torch.Tensor],
                    masks: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """New tensors: each entry times its mask (unpruned ones as
        they are)."""
        return {name: x if masks[name].ndim == 0
                else x * masks[name].to(x.dtype)
                for name, x in tree.items()}

    @staticmethod
    @torch.no_grad()
    def apply_masks_(tree: Mapping[str, Optional[torch.Tensor]],
                     masks: Mapping[str, torch.Tensor]) -> None:
        """In place (parameters or their gradients; None entries are
        skipped)."""
        for name, x in tree.items():
            if x is not None and masks[name].ndim:
                x.mul_(masks[name])

    @staticmethod
    @torch.no_grad()
    def prune_trained_model(params: Mapping[str, torch.Tensor],
                            pattern: str = "m4n2_1d"):
        """One shot: ``(pruned, masks)``; the pruned entries are new
        tensors with no autograd history, the others the inputs."""
        masks = ASP.compute_sparse_masks(params, pattern=pattern)
        return ASP.apply_masks(params, masks), masks

    @staticmethod
    def compute_permutations(params: Mapping[str, torch.Tensor],
                             allowed: Optional[Allowed] = None,
                             max_swaps: int = 10_000) -> Dict[str, dict]:
        """≙ permutation_lib's search: for each prunable entry ``{"perm",
        "axis", "before", "after"}`` (the input-axis permutation under
        which the 2:4 mask keeps more magnitude, ``after >= before``),
        None for the others.  Apply with ``apply_permutation(w, perm,
        axis)``, and permute the producing layer's output channels the
        same way to keep the network's function."""
        allowed = allowed or _default_allowed
        out = {}
        for name, w in params.items():
            if not allowed(name, w):
                out[name] = None
                continue
            perm, before, after = search_channel_permutation(
                w.detach(), axis=INPUT_AXIS, max_swaps=max_swaps)
            out[name] = {"perm": perm, "axis": INPUT_AXIS, "before": before,
                         "after": after}
        return out

"""Channel-permutation search for 2:4 sparsity — ≙ ``apex/contrib/
sparsity/permutation_lib.py``; counterpart of
``apex_tpu/contrib/sparsity/permutation.py``.

The search looks for a permutation of a weight's input channels under
which the 2:4 mask keeps more magnitude: the channels that share a
group of 4 compete for its 2 kept slots in every row.  Like the
reference it is the greedy best-swap search (upstream's CPU strategy),
here in PyTorch on the weight's device with f64 sums:

1. ``quality(g)``: the sum over rows of the two largest ``|w|`` among
   group g's four channels.
2. The gain of swapping two channels of different groups depends only
   on those two groups; every candidate's gain is read from a (G, 4, C)
   table of "group g with slot s replaced by channel x".  With the other
   three channels' largest ``a`` and second ``b`` in a row, the two
   largest of {a, b, c, x} sum to ``a + max(b, x)``, and ``max(b, x) =
   (b + x + |b - x|) / 2``: the table is a column sum plus an L1
   distance between columns (``torch.cdist(p=1)``), with no sort.
3. The best positive swap is taken, the two groups' entries are
   updated, until no swap gains more than ``min_gain`` or ``max_swaps``
   swaps were made.

The permutation keeps the network's function only if the layer that
produces that input permutes its output channels the same way; the
caller pairs them (:func:`apply_permutation` on both).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "search_channel_permutation",
    "permutation_retained_magnitude",
    "apply_permutation",
    "invert_permutation",
]

#: the slots that stay when slot s of a group is replaced
_OTHERS = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))


def _to_2d(weight, axis: int) -> torch.Tensor:
    w = torch.as_tensor(weight).movedim(axis, -1)
    return w.reshape(-1, w.shape[-1]).abs().to(torch.float64)


def permutation_retained_magnitude(weight, perm, axis: int = -1) -> float:
    """The sum of ``|w|`` that the 2:4 mask keeps after the channels of
    ``axis`` are permuted by ``perm``."""
    mag = _to_2d(weight, axis)
    mag = mag[:, torch.as_tensor(perm, device=mag.device)]
    r, c = mag.shape
    top2 = mag.reshape(r, c // 4, 4).sort(dim=-1).values[..., 2:]
    return float(top2.sum())


def _group_quality(mag: torch.Tensor, channels: torch.Tensor) -> torch.Tensor:
    """(G,) kept magnitude of each group; ``channels`` (G, 4)."""
    return mag[:, channels].sort(dim=-1).values[..., 2:].sum(dim=(0, 2))


def _replacement_quality(mag: torch.Tensor,
                         channels: torch.Tensor) -> torch.Tensor:
    """(G, 4, C): the quality of group g with slot s replaced by channel
    x (see the module docstring)."""
    r, c = mag.shape
    g = channels.shape[0]
    others = torch.tensor(_OTHERS, device=mag.device)
    a, b = mag[:, channels[:, others]].topk(2, dim=-1).values.unbind(-1)
    a = a.sum(dim=0).reshape(g * 4, 1)
    b = b.reshape(r, g * 4).T  # (G4, R)
    l1 = torch.cdist(b[None], mag.T[None], p=1)[0]  # (G4, C)
    out = a + 0.5 * (b.sum(dim=1, keepdim=True) + mag.sum(dim=0) + l1)
    return out.reshape(g, 4, c)


def search_channel_permutation(weight, axis: int = -1,
                               max_swaps: int = 10_000,
                               min_gain: float = 1e-6
                               ) -> Tuple[torch.Tensor, float, float]:
    """The greedy best-swap search over the channels of ``axis``:
    ``(perm, before, after)``, ``perm`` a long tensor on the weight's
    device, ``before``/``after`` the kept magnitudes of the identity and
    of ``perm`` (``after >= before``)."""
    mag = _to_2d(weight, axis)
    r, c = mag.shape
    if c % 4:
        raise ValueError(f"channel count ({c}) must be divisible by 4")
    g_count = c // 4
    channels = torch.arange(c, device=mag.device).reshape(g_count, 4)
    quality = _group_quality(mag, channels)
    before = float(quality.sum())
    if g_count < 2:
        return channels.reshape(-1), before, before
    repl = _replacement_quality(mag, channels)
    gid = torch.arange(g_count, device=mag.device).repeat_interleave(4)
    same_group = gid[:, None] == gid[None, :]

    swaps = 0
    while swaps < max_swaps:
        # gain of swapping (g1, s1) <-> (g2, s2):
        # repl[g1, s1, ch(g2, s2)] + repl[g2, s2, ch(g1, s1)]
        # - quality[g1] - quality[g2]
        q_flat = quality.repeat_interleave(4)
        gain_to = repl.reshape(g_count * 4, c)[:, channels.reshape(-1)]
        gains = gain_to + gain_to.T - q_flat[:, None] - q_flat[None, :]
        gains.masked_fill_(same_group, float("-inf"))
        idx = int(gains.argmax())
        a, b = divmod(idx, g_count * 4)
        if float(gains[a, b]) <= min_gain:
            break
        (g1, s1), (g2, s2) = divmod(a, 4), divmod(b, 4)
        c1, c2 = int(channels[g1, s1]), int(channels[g2, s2])
        channels[g1, s1], channels[g2, s2] = c2, c1
        for g in (g1, g2):
            quality[g] = _group_quality(mag, channels[g:g + 1])[0]
            repl[g] = _replacement_quality(mag, channels[g:g + 1])[0]
        swaps += 1
    return channels.reshape(-1), before, float(quality.sum())


def apply_permutation(weight: torch.Tensor, perm, axis: int = -1
                      ) -> torch.Tensor:
    """``weight`` with the entries of ``axis`` taken in ``perm``'s order
    (``index_select``)."""
    return weight.index_select(
        axis % weight.ndim, torch.as_tensor(perm, device=weight.device))


def invert_permutation(perm) -> torch.Tensor:
    """The permutation that undoes ``perm``."""
    perm = torch.as_tensor(perm)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    return inv

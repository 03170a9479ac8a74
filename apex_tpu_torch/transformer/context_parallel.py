"""Context parallelism — long-context attention over the ``cp`` ranks.

Counterpart of ``apex_tpu/transformer/context_parallel.py`` (no Apex
analog):

- :func:`ring_attention` — blockwise ring attention: q stays put, the
  (k, v) blocks (and a key-padding bias) rotate one rank a hop
  (:func:`comm.shift <apex_tpu_torch.parallel.comm.shift>`, cyclic),
  and each hop's ``(o, lse)`` from
  :func:`~apex_tpu_torch.ops.attention.flash_attention_with_lse` (K3,
  and K4 in the backward, on the card) folds into the running
  online-softmax state (:func:`_merge_block`).  The merge differentiates
  through every hop's lse, so K4 receives a non-zero lse cotangent
  (``dlse``, folded into its ``delta``).
- :func:`ulysses_attention` — all-to-all sequence parallelism: scatter
  heads / gather the sequence, flash attention over the full sequence
  with H/cp heads, all-to-all back.

q, k, v are this rank's ``(B, H, S_local, D)`` shards.  With
``layout="contiguous"`` rank r holds rows ``[r·S_local, (r+1)·S_local)``;
with ``layout="zigzag"`` (causal load balancing) it holds global chunks
``r`` and ``2cp−1−r`` (:func:`zigzag_split` / :func:`zigzag_merge`).
Causal masking honours global positions in both layouts.

How the reference's traced pieces became host code:

- the ``lax.switch`` on (src, rank) is a Python branch (both are host
  integers); a block in this rank's causal future launches nothing
  (:func:`_skipped_block` is its zero-mass ``(o, lse)``);
- each hop runs under ``torch.utils.checkpoint`` (the reference's
  ``jax.checkpoint``), so the backward recomputes the hop's attention
  and the residual memory stays O(S_local) a hop;
- the reference casts q to f32 and leaves k and v in their dtype (the
  products promote to f32); the kernels take one dtype, so a hop widens
  k and v to f32 too and runs the f32 instances of K3/K4;
- dropout: the reference folds its rng with ``rank·cp + src`` (and
  ``·4 + pair`` under zigzag); here the block's int32 seed is the
  caller's seed hashed with the same index (:func:`fold_seed`, the
  dropout hash's mixing), so the block masks are the kernels' masks
  under derived seeds — equal in law to the reference's, not in bits.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.amp.lists import carry_policy
from apex_tpu_torch.ops.attention import (
    _COL_MUL,
    _ROW_MUL,
    _U32,
    _fmix,
    draw_dropout_seed,
    flash_attention,
    flash_attention_with_lse,
)
from apex_tpu_torch.parallel import comm
from apex_tpu_torch.transformer.pipeline_parallel.p2p_communication import (
    _Shift,
)

__all__ = [
    "fold_seed",
    "ring_attention",
    "ulysses_attention",
    "zigzag_shard",
    "zigzag_split",
    "zigzag_merge",
]

_CP = ps.CONTEXT_PARALLEL_AXIS


def fold_seed(seed: torch.Tensor, index: int) -> torch.Tensor:
    """The int32 (1,) seed of block ``index`` derived from the int32
    (1,) ``seed``: two rounds of the dropout hash's mixing keyed by the
    seed, computed where the seed lies (``jax.random.fold_in``'s role;
    different bits)."""
    key = seed.reshape(1).long() & _U32
    h = _fmix((key ^ (int(index) & _U32)) & _U32, _ROW_MUL, key)
    h = _fmix(h, _COL_MUL, key)
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


def _block_attend(q, k, v, scale, *, causal=False, dropout_p=0.0,
                  dropout_seed=None, bias=None):
    """One (q-block × kv-block) flash block: ``(o (f32), lse)``, the pair
    the online-softmax merge needs; ``o`` is block-normalized and
    ``lse`` the undropped row logsumexp.  ``causal`` covers the ring's
    diagonal block."""
    o, lse = flash_attention_with_lse(
        q, k, v, bias, causal=causal, scale=scale, dropout_p=dropout_p,
        dropout_seed=dropout_seed,
    )
    return o.float(), lse


def _merge_block(carry, block):
    """Fold one ``(o, lse)`` block into the running online-softmax state
    ``(acc, m, l)``.  A skipped block's ``lse = -inf`` folds to exactly
    zero weight against any finite running max.  The one merge of every
    ring layout."""
    acc, m, l = carry
    o_b, lse_b = block
    m_new = torch.maximum(m, lse_b)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(lse_b - m_new)
    l_new = l * alpha + beta
    acc_new = (
        acc * (l * alpha)[..., None] + o_b * beta[..., None]
    ) / l_new[..., None]
    return acc_new, m_new, l_new


def _skipped_block(b, h, rows, d, device):
    """``(o, lse)`` of a fully masked (causal-future) block: zero mass,
    nothing launched."""
    return (
        torch.zeros((b, h, rows, d), dtype=torch.float32, device=device),
        torch.full((b, h, rows), float("-inf"), dtype=torch.float32,
                   device=device),
    )


def _attend_hop(q, k, v, bias, scale, causal, dropout_p, seed):
    """A computed block under the per-hop checkpoint: k and v widened
    to q's f32 (the kernels take one dtype)."""
    def fn(q_, k_, v_):
        return _block_attend(q_, k_.float(), v_.float(), scale,
                             causal=causal, dropout_p=dropout_p,
                             dropout_seed=seed, bias=bias)

    return checkpoint(carry_policy(fn), q, k, v, use_reentrant=False,
                      preserve_rng_state=False)


def _rotate(tensors, axis_name):
    """Every tensor of the hop's kv state one rank along the ring
    (differentiable: the backward rotates the cotangents back)."""
    return tuple(None if t is None else _Shift.apply(t, 1, axis_name, True)
                 for t in tensors)


class _Anchor(torch.autograd.Function):
    """Identity on ``x`` that also takes the last rotated kv state and
    hands it zero cotangents.  The rotations' backwards are collectives
    every rank must join; without this, a rank whose last hops were
    causally skipped would leave its rotated kv unused, autograd would
    prune those backwards, and its peers would wait for it.  With it the
    chain of rotation backwards runs on every rank, last hop first."""

    @staticmethod
    def forward(ctx, x, *kv):
        ctx.meta = [(t.shape, t.dtype, t.device, t.requires_grad)
                    for t in kv]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev) if rg else None
                     for s, d, dev, rg in ctx.meta))


def _anchored(x, kv):
    return _Anchor.apply(x, *(t for t in kv if t is not None))


def _dropout_seed(dropout_p, generator, dropout_seed, device):
    if dropout_p > 0.0 and dropout_seed is None and generator is None:
        raise ValueError(
            "dropout_p > 0 requires a generator or a dropout_seed")
    if dropout_p == 0.0:
        return None
    if dropout_seed is not None:
        return dropout_seed.reshape(1).to(torch.int32)
    return draw_dropout_seed(generator, device)


def _check_key_padding(bias, name):
    if bias.dim() < 4:
        bias = bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape))
    if bias.shape[1] != 1 or bias.shape[2] != 1:
        if name == "ring_attention":
            raise ValueError(
                "ring_attention only rotates a key-padding bias of "
                f"shape (B, 1, 1, S_local); got {tuple(bias.shape)} — "
                "query-dependent bias cannot rotate with kv"
            )
        raise ValueError(
            "ulysses_attention only redistributes a key-padding bias "
            f"of shape (B, 1, 1, S_local); got {tuple(bias.shape)}"
        )
    return bias


def ring_attention(
    q,
    k,
    v,
    bias=None,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    dropout_p: float = 0.0,
    generator: Optional[torch.Generator] = None,
    dropout_seed: Optional[torch.Tensor] = None,
    layout: str = "contiguous",
    axis_name: str = _CP,
):
    """Blockwise ring attention over ``axis_name``: q, k, v this rank's
    ``(B, H, S_local, D)``; returns ``(B, H, S_local, D)`` in q's dtype,
    equal (within numerics) to attention over the gathered sequence.

    ``causal`` skips the blocks in this rank's causal future (the
    rotation still runs every hop, so the ring stays in step).
    ``layout="zigzag"`` (causal only) balances that work: rank r holds
    global chunks ``r`` and ``2cp−1−r``.  ``bias``: a key-padding mask
    ``(B, 1, 1, S_local)`` over this rank's own keys (in its layout),
    rotating with (k, v); a query-dependent bias is refused.  Dropout
    (``dropout_p`` with ``dropout_seed`` or ``generator``, the same on
    every rank) draws each (q-rank, kv-source) block's mask from
    :func:`fold_seed` of ``rank·cp + src``; the merge weighs blocks by
    their undropped mass, so the result is full attention under the
    block-assembled mask."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    seed = _dropout_seed(dropout_p, generator, dropout_seed, q.device)
    if bias is not None:
        bias = _check_key_padding(bias, "ring_attention")
        if bias.shape[-1] not in (1, k.shape[-2]):
            raise ValueError(
                f"ring_attention bias covers {bias.shape[-1]} keys but "
                f"this rank's kv chunk has {k.shape[-2]} — pass the "
                "RANK-LOCAL slice of the global mask (it rotates with "
                "kv), not the global mask itself"
            )
        bias = bias.detach()
    if layout == "zigzag":
        if not causal:
            raise ValueError(
                "layout='zigzag' exists to balance CAUSAL ring work; "
                "non-causal rings are already balanced — use the "
                "contiguous layout"
            )
        return _ring_attention_zigzag(q, k, v, bias, scale, dropout_p, seed,
                                      axis_name)
    if layout != "contiguous":
        raise ValueError(f"unknown ring layout {layout!r}")
    world = ps.axis_size(axis_name)
    rank = ps.axis_rank(axis_name)
    b, h, s_local, d = q.shape
    qf = q.float()

    def hop(kv, src):
        kb, vb, bias_b = kv
        seed_b = (None if seed is None
                  else fold_seed(seed, rank * world + src))
        if not causal or src < rank:
            return _attend_hop(qf, kb, vb, bias_b, scale, False, dropout_p,
                               seed_b)
        if src == rank:
            return _attend_hop(qf, kb, vb, bias_b, scale, True, dropout_p,
                               seed_b)
        return _skipped_block(b, h, s_local, d, q.device)

    # hop 0 is the self block: it seeds the running max with a finite
    # lse, so the -inf of a skipped hop merges to exactly zero weight
    kv = (k, v, bias)
    o0, lse0 = hop(kv, rank)
    carry = (o0, lse0, torch.ones_like(lse0))
    for step in range(1, world):
        # rotate first: world - 1 rotations, none after the last hop
        kv = _rotate(kv, axis_name)
        carry = _merge_block(carry, hop(kv, (rank - step) % world))
    return _anchored(carry[0], kv).to(q.dtype)


def zigzag_shard(x, rank: int, cp: int, axis: int = 0):
    """ONE rank's zigzag shard of a GLOBAL tensor: global chunks
    ``rank`` and ``2cp−1−rank`` along ``axis``, concatenated.  Raises
    unless the axis divides into ``2·cp`` chunks (a remainder would
    silently drop trailing tokens)."""
    size = x.shape[axis]
    if size % (2 * cp):
        raise ValueError(
            f"zigzag layout needs the sequence ({size}) divisible by "
            f"2*cp ({2 * cp}); a remainder would silently drop tokens"
        )
    sc = size // (2 * cp)
    lo = x.narrow(axis, rank * sc, sc)
    hi = x.narrow(axis, (2 * cp - 1 - rank) * sc, sc)
    return torch.cat([lo, hi], dim=axis)


def zigzag_split(x, cp: int, axis: int = 2):
    """Global → zigzag layout: the per-rank locals stacked ``(cp, ...,
    S/cp, ...)``, rank ``r`` holding chunks ``r`` and ``2cp−1−r`` of the
    ``2·cp`` chunks of ``axis``."""
    chunks = torch.chunk(x, 2 * cp, dim=axis)
    return torch.stack([
        torch.cat([chunks[r], chunks[2 * cp - 1 - r]], dim=axis)
        for r in range(cp)
    ])


def zigzag_merge(locals_, cp: int, axis: int = 2):
    """Inverse of :func:`zigzag_split`: ``(cp, ..., S/cp, ...)`` stacked
    zigzag locals → the global-order tensor."""
    out = [None] * (2 * cp)
    for r in range(cp):
        lo, hi = torch.chunk(locals_[r], 2, dim=axis)
        out[r] = lo
        out[2 * cp - 1 - r] = hi
    return torch.cat(out, dim=axis)


def _ring_attention_zigzag(q, k, v, bias, scale, dropout_p, seed,
                           axis_name):
    """Causal ring attention over the zigzag layout: this rank's rows
    are [global chunk ``r``; global chunk ``2cp−1−r``].  The lo half
    attends the lo kv halves (skipped for future sources); the hi half
    attends every lo half and the non-future hi halves: ~2 half-blocks
    a hop on every rank."""
    world = ps.axis_size(axis_name)
    rank = ps.axis_rank(axis_name)
    b, h, s_local, d = q.shape
    if s_local % 2:
        raise ValueError("zigzag layout needs an even local sequence")
    half = s_local // 2
    qf = q.float()
    q_lo, q_hi = qf[:, :, :half], qf[:, :, half:]

    def seed_of(src, pair):
        if seed is None:
            return None
        return fold_seed(seed, (rank * world + src) * 4 + pair)

    def hop(kv, src):
        k_lo, v_lo, k_hi, v_hi, b_lo, b_hi = kv
        # lo (global chunk rank) against lo' (global chunk src)
        if src <= rank:
            lo = _attend_hop(q_lo, k_lo, v_lo, b_lo, scale, src == rank,
                             dropout_p, seed_of(src, 0))
        else:
            lo = _skipped_block(b, h, half, d, q.device)
        # hi (chunk 2cp−1−rank) against lo' (chunk src < cp): always past
        hi_lo = _attend_hop(q_hi, k_lo, v_lo, b_lo, scale, False, dropout_p,
                            seed_of(src, 1))
        # hi against hi' (chunk 2cp−1−src): past iff src > rank
        if src >= rank:
            hi_hi = _attend_hop(q_hi, k_hi, v_hi, b_hi, scale, src == rank,
                                dropout_p, seed_of(src, 2))
        else:
            hi_hi = _skipped_block(b, h, half, d, q.device)
        return lo, hi_lo, hi_hi

    b_lo = b_hi = None
    if bias is not None:
        # the key-padding mask splits into the two chunk halves and
        # rotates with them; a broadcast (..., 1) mask serves both
        if bias.shape[-1] == 1:
            b_lo = b_hi = bias
        else:
            b_lo = bias[..., :half].contiguous()
            b_hi = bias[..., half:].contiguous()
    kv = (k[:, :, :half], v[:, :, :half], k[:, :, half:], v[:, :, half:],
          b_lo, b_hi)
    lo0, hi_lo0, hi_hi0 = hop(kv, rank)
    ones = torch.ones_like(lo0[1])
    c_lo = (lo0[0], lo0[1], ones)
    c_hi = _merge_block((hi_lo0[0], hi_lo0[1], ones), hi_hi0)
    for step in range(1, world):
        kv = _rotate(kv, axis_name)
        lo, hi_lo, hi_hi = hop(kv, (rank - step) % world)
        c_lo = _merge_block(c_lo, lo)
        c_hi = _merge_block(_merge_block(c_hi, hi_lo), hi_hi)
    out = torch.cat([c_lo[0], c_hi[0]], dim=2)
    return _anchored(out, kv).to(q.dtype)


def ulysses_attention(
    q,
    k,
    v,
    bias=None,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    dropout_p: float = 0.0,
    generator: Optional[torch.Generator] = None,
    dropout_seed: Optional[torch.Tensor] = None,
    axis_name: str = _CP,
):
    """All-to-all (Ulysses) sequence parallelism: q, k, v ``(B, H,
    S_local, D)`` with the full head count (``H % cp == 0``) go through
    an all-to-all to ``(B, H/cp, S, D)``, flash attention (K3/K4 on the
    card) over the full sequence, and back.  ``bias``: only a
    head-independent key-padding mask ``(B, 1, 1, S_local)``, gathered
    along the sequence.  The dropout seed is folded with the cp rank
    (:func:`fold_seed`), so each rank's head group draws its own mask."""
    world = ps.axis_size(axis_name)
    h = q.shape[1]
    if h % world:
        raise ValueError(
            f"ulysses_attention needs num_heads ({h}) divisible by the "
            f"axis size ({world})"
        )
    seed = _dropout_seed(dropout_p, generator, dropout_seed, q.device)
    if bias is not None:
        bias = _check_key_padding(bias, "ulysses_attention").detach()
        rows = bias.movedim(-1, 0).contiguous()
        full = rows.new_empty((world * rows.shape[0],) + rows.shape[1:])
        bias = comm.all_gather_into(full, rows, ps.get_group(axis_name))
        bias = bias.movedim(0, -1)
    if seed is not None:
        seed = fold_seed(seed, ps.axis_rank(axis_name))

    def scatter_heads(x):
        # (B, H, S_local, D) -> (B, H/cp, S, D)
        return comm.all_to_all(x, axis_name, 1, 2)

    o = flash_attention(
        scatter_heads(q), scatter_heads(k), scatter_heads(v), bias,
        causal=causal, scale=scale, dropout_p=dropout_p,
        dropout_seed=seed,
    )
    return comm.all_to_all(o, axis_name, 2, 1)

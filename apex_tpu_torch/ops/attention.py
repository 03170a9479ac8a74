"""Flash attention — forward and backward, public API and dispatch.

Counterpart of ``apex_tpu/ops/attention.py``.  Layout ``(B, H, S, D)``.

One ``autograd.Function`` (:class:`_Flash`) carries both directions:

- **kernel path** (CUDA tensors): the forward is kernel K3
  (``csrc/flash_fwd.cu``, replacing the Pallas ``flash_fwd``) —
  online-softmax attention in one pass, bottom-right causal alignment,
  f32 row logsumexp; the backward is kernel K4 (``csrc/flash_bwd.cu``,
  replacing ``flash_bwd``) — dq, dk, dv recomputed in two passes.  Both
  take any ``S_q``/``S_k`` (the kernels mask their own ragged edge, so no
  sequence is padded) and any head dim: the kernels have instances at
  32 (the evoformer's triangle attention), 64, 128 and 256 (whose
  products over D loop over 64-column blocks and whose D-indexed outputs
  are split over CTAs), and a wide one for any multiple of 128 above
  256, whose number of 64-column blocks is a run-time argument and
  whose products over D stream their operands through the ring a block
  at a time, so its shared memory does not grow with D.  The wrappers
  zero-pad q, k, v and dO on the last dim up to the instance's
  (:func:`kernel_head_dim`, the counterpart of the reference's
  ``padded_head_dim``: above 128 both pad to a multiple of 128) and slice
  the outputs back, which changes neither the scores (the scale is the
  caller's) nor the dropout mask (indexed by (bh, i, j)).  bf16 q/k/v
  run K3/K4/K5 on the tensor cores; f32 q/k/v run their f32 instances
  (``csrc/flash_f32.cu``: every product as 3xTF32 on the tensor cores),
  as the reference runs f32 inputs at ``Precision.HIGHEST``.  The kernel
  entry points take q, k and v of one dtype; :func:`flash_attention`
  widens mixed dtypes and f16 exactly to f32 first.
  Every call on the card launches
  the kernels: the TPU's short-sequence routing to the unfused
  composition was a v5e measurement and is not carried over.
- **plain path** (CPU tensors): the twins :func:`flash_fwd_reference`,
  :func:`flash_bwd_reference` and :func:`flash_dbias_reference`, the
  same arithmetic unfused in f32.

Both directions take the TPU kernels' two optional operands:

- an additive f32 **bias** in the kernels' ``(G, RS, Sk)`` layout:
  ``G`` in {1, B, BH} (batch-head ``bh`` reads group ``bh // (BH/G)``)
  and ``RS`` in {1, Sq} (one key-padding row, or one row per query).
  :func:`flash_attention` turns a bias broadcastable to (B, H, Sq, Sk)
  into it and clamps it at ``MASK_VALUE``; the kernels floor it at
  ``PAD_VALUE``, add it after the scale and before the causal mask.
  By default it is the additive-mask form and gets no gradient.
  ``bias_grad=True`` makes it trainable: the backward also returns
  dbias, the Pallas ``flash_dbias``'s function, on the card and its
  twin :func:`flash_dbias_reference` on the CPU, in the (G, RS, Sk)
  layout (each group's members summed, and every query row when RS =
  1).  On the card a bf16 bias at G = BH and RS = Sq (one owner per
  dbias element: every trainable bias of the ported models) leaves
  K4's dQ pass as its epilogue (:func:`flash_bwd_dbias`), so nothing
  is recomputed for it; any other layout, the wide head dims and f32
  launch kernel K5 (``csrc/flash_dbias.cu``) after K4;
  autograd of the clamp and the broadcast in :func:`_format_bias`
  carries it back to the caller's shape, as ``jnp.maximum`` and
  ``broadcast_to`` do in JAX.  A head-dependent bias is materialised at
  G = BH, as the JAX package does, so the sum over the batch of an
  evoformer's (1, H, N, N) pair bias is that broadcast's backward, not
  the kernel's.
- **dropout** on the attention probabilities with the keep mask of the
  TPU kernels' ``_dropout_keep_block``, reproduced bit for bit
  (:func:`dropout_keep_mask`): a keyed two-round murmur3-fmix hash of
  (int32 seed, flattened batch-head ``bh``, row, column), kept where the
  hash is at least ``min(int(p * 2**32), 2**32 - 1)``.  The seed is an
  int32 tensor of one element on the operands' device, which the kernels
  read (the TPU's SMEM scalar): it is drawn from ``generator`` or passed
  in as ``dropout_seed`` — what a recomputing caller (``remat``) does, so
  that the recompute sees the same mask.  The row sum and the lse take
  the undropped probabilities; only the PV product takes ``keep ?
  p/(1-p_drop) : 0``.

The forward also keeps each row's f32 max ``m`` and sum ``l`` of
``exp(s - m)``, and the backward (K4 and K5) recomputes ``p = exp(s -
m) / l``.  The TPU's recompute ``p = exp(s - lse)`` (``_recompute_p``)
is wrong for a row whose every key is masked: its lse, ``MASK_VALUE +
log(Sk)``, rounds back to ``MASK_VALUE`` in f32, so p comes out 1
instead of ``1/Sk``; the Pallas backward patches only the causal case,
and a bias-masked row (a BERT sequence with no real token) gets
gradients, and a trainable bias its dbias, off by orders of
magnitude.  With ``m`` and ``l`` both cases are exact and
need no closed form; such a row averages V uniformly (finite
``MASK_VALUE``), and under a bias its score gradient is not zero, as
autodiff of :func:`mha_reference` gives.

``delta = rowsum(dO * O) - dlse`` (with the dropped O) is computed in
PyTorch before K4 and K5, as the JAX package does in jnp outside
Pallas; it folds the gradient of :func:`flash_attention_with_lse`'s
``lse`` output.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _dispatch

__all__ = [
    "KERNEL_HEAD_DIMS",
    "MASK_VALUE",
    "PAD_VALUE",
    "draw_dropout_seed",
    "dropout_keep_mask",
    "flash_attention",
    "flash_attention_with_lse",
    "flash_bwd",
    "flash_bwd_dbias",
    "flash_bwd_dbias_reference",
    "flash_bwd_reference",
    "flash_dbias",
    "flash_dbias_reference",
    "flash_fwd",
    "flash_fwd_reference",
    "fmha_qkvpacked",
    "kernel_head_dim",
    "mha_reference",
    "mha_reference_with_lse",
]

#: large negative finite (not -inf), as apex_tpu's flash kernels use
MASK_VALUE = -1e9
#: the kernels' floor for a bias, strictly below MASK_VALUE
#: (``flash_attention.py:56``)
PAD_VALUE = -1.5e9

KERNEL = "flash_fwd"
KERNEL_BWD = "flash_bwd"
KERNEL_DBIAS = "flash_dbias"
#: K4 with K5's dbias as its dQ pass's epilogue (``csrc/flash_bwd.cu``)
KERNEL_BWD_DBIAS = "flash_bwd_dbias"
#: the f32 instances of K3, K4 and K5 (``csrc/flash_f32.cu``)
KERNEL_F32 = "flash_fwd_f32"
KERNEL_BWD_F32 = "flash_bwd_f32"
KERNEL_DBIAS_F32 = "flash_dbias_f32"
#: the head dims the kernels are instantiated at; a wider head dim runs
#: the wide instance at the next multiple of 128
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def kernel_head_dim(d: int) -> int:
    """The kernels' head dim for a model's ``d``: up to 256 the smallest
    of 32, 64, 128 and 256 that is at least ``d``; above 256 the next
    multiple of 128 (the wide instance).  Above 128 this is the
    reference's ``padded_head_dim`` (a multiple of 128); at D <= 128 the
    reference rounds to a multiple of 8, a Mosaic tiling rule, and here
    the instances decide.  Raises only for d < 1."""
    d = int(d)
    if d < 1:
        raise ValueError(f"head dim must be positive, got {d}")
    for dk in KERNEL_HEAD_DIMS:
        if d <= dk:
            return dk
    return -(-d // 128) * 128


def _pad_head(x, dk):
    """``x`` zero-padded on its last dim up to ``dk`` (unchanged when it
    is already ``dk`` wide)."""
    d = x.shape[-1]
    return x if d == dk else torch.nn.functional.pad(x, (0, dk - d))

# ---------------------------------------------------------------------------
# the dropout keep mask (``_dropout_keep_block``)
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_ROW_MUL, _COL_MUL, _MIX_MUL = 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F


def _mul32(a, c: int):
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32): the product is
    split at 16 bits so that no partial product leaves int64."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _fmix(h, mul: int, key):
    h = h ^ (h >> 16)
    h = _mul32(h, mul)
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX_MUL)
    h = h ^ (h >> 16)
    return (h + key) & _U32


def _check_dropout_p(dropout_p: float) -> None:
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")


def _keep_threshold(dropout_p: float) -> int:
    """The uint32 threshold, in Python integers (never f32)."""
    return min(int(dropout_p * 2 ** 32), 2 ** 32 - 1)


def dropout_keep_mask(seed: torch.Tensor, shape, dropout_p: float
                      ) -> torch.Tensor:
    """The kernels' keep mask over scores of ``shape`` (..., Sq, Sk):
    element (bh, i, j) with ``bh`` the flattened leading index (b*H + h),
    from the int32 ``seed`` (a one-element tensor).  Bit for bit the
    TPU's ``_dropout_keep_block``, computed in int64 masked to 32 bits
    after each multiply and shift."""
    *lead, sq, sk = shape
    dev = seed.device
    n = math.prod(lead)
    bh = torch.arange(n, device=dev, dtype=torch.int64).reshape(n, 1, 1)
    rows = torch.arange(sq, device=dev, dtype=torch.int64).reshape(1, sq, 1)
    cols = torch.arange(sk, device=dev, dtype=torch.int64).reshape(1, 1, sk)
    key = ((seed.reshape(1).long() & _U32) + _mul32(bh, _GOLDEN)) & _U32
    h = _fmix(rows ^ key, _ROW_MUL, key)
    h = _fmix(h ^ cols, _COL_MUL, key)
    return (h >= _keep_threshold(dropout_p)).reshape(*lead, sq, sk)


def draw_dropout_seed(generator: torch.Generator, device) -> torch.Tensor:
    """An int32 seed tensor (1,) on ``device`` drawn from ``generator``
    over the int32 range (``_derive_dropout_seed``).  A CPU generator
    draws on the host and the value is written on ``device`` by a fill,
    so the draw waits for nothing queued there."""
    seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)
    device = torch.device(device)
    if seed.device == device or generator.device.type != "cpu":
        return seed
    return torch.full((1,), int(seed), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _causal_mask(sq, sk, device):
    """Bottom-right aligned: query row r sees keys <= r + (sk - sq)."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(
        diagonal=sk - sq
    )


def _scores(q, k, bias, causal, scale):
    """Scaled (+bias, causal-masked) f32 score matrix; ``bias`` is
    broadcast against the scores as given."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        mask = _causal_mask(s.shape[-2], s.shape[-1], s.device)
        s = s.masked_fill(~mask, MASK_VALUE)
    return s


def _dropped(p, seed, dropout_p):
    """``keep ? p/(1-p_drop) : 0`` with the kernels' mask."""
    if dropout_p == 0.0:
        return p
    keep = dropout_keep_mask(seed, p.shape, dropout_p)
    return torch.where(keep, p * (1.0 / (1.0 - dropout_p)),
                       torch.zeros_like(p))


def mha_reference(q, k, v, bias=None, *, causal: bool = False,
                  scale: Optional[float] = None, dropout_p: float = 0.0,
                  dropout_seed: Optional[torch.Tensor] = None):
    """Unfused attention with f32 scores — the plain version of
    :func:`flash_attention`, differentiable in every input.  q (B,H,Sq,D),
    k/v (B,H,Sk,D), bias broadcastable to (B,H,Sq,Sk).  Dropout takes the
    kernels' keep mask (the JAX composition draws its own from
    ``jax.random``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = torch.softmax(_scores(q, k, bias, causal, scale), dim=-1)
    p = _dropped(p, dropout_seed, dropout_p)
    return torch.einsum("...qk,...kd->...qd", p.to(q.dtype), v)


def _softmax_attend(s, v, seed, dropout_p):
    """o = dropout(softmax(s)) V in v's dtype, with the undropped f32 row
    logsumexp, max and sum (..., Sq)."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pn = _dropped(p / l, seed, dropout_p)
    o = torch.einsum("...qk,...kd->...qd", pn.to(v.dtype), v)
    return o, (m + torch.log(l))[..., 0], m[..., 0], l[..., 0]


def mha_reference_with_lse(q, k, v, bias=None, *, causal: bool = False,
                           scale: Optional[float] = None,
                           dropout_p: float = 0.0,
                           dropout_seed: Optional[torch.Tensor] = None):
    """:func:`mha_reference` plus the undropped f32 row logsumexp
    (..., Sq).  Takes (B, H, S, D) or (BH, S, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, bias, causal, scale)
    return _softmax_attend(s, v, dropout_seed, dropout_p)[:2]


def _bias_rows(bias, bh):
    """A (G, RS, Sk) bias as (BH, RS, Sk) rows, floored at PAD_VALUE as
    the kernels read it."""
    g = bias.shape[0]
    rows = bias.float().repeat_interleave(bh // g, dim=0)
    return torch.clamp(rows, min=PAD_VALUE)


def _flat_scores(q, k, bias, causal, scale):
    bias_rows = None if bias is None else _bias_rows(bias, q.shape[0])
    return _scores(q, k, bias_rows, causal, scale)


def flash_fwd_reference(q, k, v, bias=None, *, scale: float, causal: bool,
                        dropout_p: float = 0.0,
                        seed: Optional[torch.Tensor] = None):
    """The plain version of K3 in its layout: q (BH, Sq, D), k/v (BH, Sk,
    D), bias (G, RS, Sk) f32, seed int32 (1,).  Returns o in v's dtype and
    the f32 lse, row max m and row sum l (BH, Sq)."""
    return _softmax_attend(_flat_scores(q, k, bias, causal, scale), v, seed,
                           dropout_p)


def _recompute_ds(q, k, v, do, m, l, delta, bias, scale, causal, dropout_p,
                  seed):
    """K4's and K5's shared recompute in f32: ``(pv, ds)`` with ``p =
    exp(s - m) / l``, ``pv = D*p`` and ``ds = p * (D*dp - delta)``, D =
    keep/(1-p_drop) (1 without dropout).  A causally masked pair has ds
    = 0 (the mask is a ``where`` on the score); its p is 0 unless its
    whole row is masked, where it is 1/Sk and still feeds dv."""
    sq, sk = q.shape[-2], k.shape[-2]
    s = _flat_scores(q, k, bias, causal, scale)
    p = torch.exp(s - m.float()[..., None]) / l.float()[..., None]
    dp = torch.einsum("...qd,...kd->...qk", do.float(), v.float())
    pv = p
    if dropout_p > 0.0:
        keep = dropout_keep_mask(seed, p.shape, dropout_p)
        d = torch.where(keep, 1.0 / (1.0 - dropout_p), 0.0)
        pv, dp = p * d, dp * d
    ds = p * (dp - delta.float()[..., None])
    if causal:
        ds = ds.masked_fill(~_causal_mask(sq, sk, s.device), 0.0)
    return pv, ds


def flash_bwd_reference(q, k, v, do, m, l, delta, bias=None, *, scale: float,
                        causal: bool, dropout_p: float = 0.0,
                        seed: Optional[torch.Tensor] = None):
    """The plain version of K4: ``(dq, dk, dv)`` in q's dtype, from the
    forward's f32 row max ``m`` and row sum ``l`` (..., Sq) and ``delta =
    rowsum(dO * O) - dlse`` (..., Sq), in K3's layout (bias (G, RS, Sk)).
    dv = (D*p)^T dO, dq = ds K * scale, dk = ds^T Q * scale
    (:func:`_recompute_ds`)."""
    pv, ds = _recompute_ds(q, k, v, do, m, l, delta, bias, scale, causal,
                           dropout_p, seed)
    dv = torch.einsum("...qk,...qd->...kd", pv, do.float())
    dq = torch.einsum("...qk,...kd->...qd", ds, k.float()) * scale
    dk = torch.einsum("...qk,...qd->...kd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_dbias_reference(q, k, v, do, m, l, delta, bias, *, scale: float,
                          causal: bool, dropout_p: float = 0.0,
                          seed: Optional[torch.Tensor] = None):
    """The plain version of K5: the f32 gradient of the (G, RS, Sk) bias,
    in its layout, with K4's operands.  ``ds`` (:func:`_recompute_ds`) is
    summed over each group's BH/G members and, when RS = 1, over every
    query row: ``dbias[g, r, c] = sum over bh in g (and rows) of ds[bh,
    r, c]``."""
    _, ds = _recompute_ds(q, k, v, do, m, l, delta, bias, scale, causal,
                          dropout_p, seed)
    bh, sq, sk = ds.shape
    g, rs, _ = bias.shape
    dbias = ds.reshape(g, bh // g, sq, sk).sum(dim=1)
    if rs == 1:
        dbias = dbias.sum(dim=1, keepdim=True)
    return dbias


def flash_bwd_dbias_reference(q, k, v, do, m, l, delta, bias, *,
                              scale: float, causal: bool,
                              dropout_p: float = 0.0,
                              seed: Optional[torch.Tensor] = None):
    """The plain version of :func:`flash_bwd_dbias`: ``(dq, dk, dv,
    dbias)`` from :func:`flash_bwd_reference` and then
    :func:`flash_dbias_reference`, each looked up in this module when it
    is called."""
    kw = dict(scale=scale, causal=causal, dropout_p=dropout_p, seed=seed)
    dq, dk, dv = flash_bwd_reference(q, k, v, do, m, l, delta, bias, **kw)
    return dq, dk, dv, flash_dbias_reference(q, k, v, do, m, l, delta, bias,
                                             **kw)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
# q, k, v, bias, seed, o, lse, m, l; bh, sq, sk, d, bias groups, bias
# rows; scale, causal, keep threshold, dropout scale; stream
_FWD_ARGS = [_P] * 9 + [_I] * 6 + [_F, _I, _U, _F, _P]
# q, k, v, dO, m, l, delta, bias, seed, dq, dk, dv; then as K3
_BWD_ARGS = [_P] * 12 + [_I] * 6 + [_F, _I, _U, _F, _P]
# q, k, v, dO, m, l, delta, bias, seed, dbias; then as K3
_DBIAS_ARGS = [_P] * 10 + [_I] * 6 + [_F, _I, _U, _F, _P]
# q, k, v, dO, m, l, delta, bias, seed, dq, dk, dv, dbias; then as K3
_BWD_DBIAS_ARGS = [_P] * 13 + [_I] * 6 + [_F, _I, _U, _F, _P]


def _check_qkv(name, q, k, v, *more):
    if not _dispatch.on_card(q, k, v, *more):
        raise ValueError(f"{name} launches the CUDA kernel: pass CUDA tensors")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or (
        q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]
    ):
        raise ValueError(
            f"expected q (BH, Sq, D) and k, v (BH, Sk, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or (
            v.dtype != q.dtype):
        raise TypeError(
            f"the flash kernels take q, k and v of one dtype, bf16 or f32, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    bh, sq, d = q.shape
    if bh == 0 or sq == 0 or k.shape[1] == 0:
        raise ValueError(f"{name} needs non-empty q and k")


def _check_vectors(name, *tensors):
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(
            f"{name} takes contiguous, 16-byte aligned tensors (the kernel "
            f"loads 16-byte vectors)"
        )


def _operand_args(name, q, k, bias, dropout_p, seed):
    """The bias and dropout arguments of the C entry points: (bias ptr,
    seed ptr, groups, rows, threshold, dropout scale)."""
    bh, sq, _ = q.shape
    sk = k.shape[1]
    bias_ptr, groups, rows = None, 1, 1
    if bias is not None:
        groups, rows = bias.shape[0], bias.shape[1]
        if (bias.dtype != torch.float32 or bias.dim() != 3
                or bias.shape[2] != sk or bh % groups or rows not in (1, sq)
                or not bias.is_contiguous()):
            raise ValueError(
                f"{name}: bias must be contiguous f32 (G, RS, {sk}) with G "
                f"dividing BH={bh} and RS in (1, {sq}), got "
                f"{bias.dtype} {tuple(bias.shape)}"
            )
        bias_ptr = bias.data_ptr()
    seed_ptr, threshold, drop_scale = None, 0, 1.0
    _check_dropout_p(dropout_p)
    if dropout_p > 0.0:
        if seed is None or seed.dtype != torch.int32 or seed.numel() != 1:
            raise ValueError(f"{name}: dropout takes an int32 seed tensor (1,)")
        seed_ptr = seed.data_ptr()
        threshold = _keep_threshold(dropout_p)
        drop_scale = 1.0 / (1.0 - dropout_p)
    return bias_ptr, seed_ptr, groups, rows, threshold, drop_scale


def _variant(mode: str, q, sq: int, d: int, causal: bool) -> dict:
    """``{"defines": ...}`` of the K3 (``mode`` "fwd") or K4 ("bwd")
    variant the tuning cache names for this bf16 call (:mod:`.tune_cache`)
    for :func:`~._dispatch.launch`, ``{}`` for the default build; the f32
    instances have no variants."""
    if q.dtype != torch.bfloat16:
        return {}
    from apex_tpu_torch.ops import tune_cache

    defines = tune_cache.flash_defines(mode, sq, d, causal, q.dtype)
    return {"defines": defines} if defines else {}


def _padded(name, d, *tensors):
    """``tensors`` zero-padded on the head dim to ``kernel_head_dim(d)``
    and checked for the kernels' loads, with that head dim."""
    dk = kernel_head_dim(d)
    tensors = [_pad_head(t, dk) for t in tensors]
    _check_vectors(name, *tensors)
    return dk, tensors


def _unpad(x, d):
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def flash_fwd(q, k, v, bias=None, *, scale: float, causal: bool,
              dropout_p: float = 0.0, seed: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, ...]:
    """Kernel K3 on CUDA tensors.  q (BH, Sq, D), k/v (BH, Sk, D), all
    bf16 (K3) or all f32 (its f32 instance), any D; optional bias
    (G, RS, Sk) f32 and, with ``dropout_p``, an int32 seed (1,).  Returns
    o (BH, Sq, D) in q's dtype and the f32 lse, row max m and row sum l,
    (BH, Sq) each.  The causal mask is aligned bottom-right (offset ``Sk
    - Sq``)."""
    more = [t for t in (bias, seed) if t is not None]
    _check_qkv("flash_fwd", q, k, v, *more)
    bias_ptr, seed_ptr, groups, rows, threshold, drop_scale = _operand_args(
        "flash_fwd", q, k, bias, dropout_p, seed)
    bh, sq, d = q.shape
    sk = k.shape[1]
    dk, (q, k, v) = _padded("flash_fwd", d, q, k, v)
    o = torch.empty_like(q)
    lse, m, l = (torch.empty(bh, sq, dtype=torch.float32, device=q.device)
                 for _ in range(3))
    _dispatch.launch(
        KERNEL if q.dtype == torch.bfloat16 else KERNEL_F32, _FWD_ARGS,
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
        seed_ptr, o.data_ptr(), lse.data_ptr(), m.data_ptr(), l.data_ptr(),
        bh, sq, sk, dk, groups, rows, float(scale), int(causal), threshold,
        drop_scale, **_variant("fwd", q, sq, dk, causal),
    )
    return _unpad(o, d), lse, m, l


def _check_bwd_operands(name, q, do, m, l, delta):
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(
            f"do must be {q.dtype} of shape {tuple(q.shape)}, got "
            f"{do.dtype} {tuple(do.shape)}")
    if any(t.shape != q.shape[:2] or t.dtype != torch.float32
           for t in (m, l, delta)):
        raise ValueError(
            f"m, l and delta must be f32 of shape {tuple(q.shape[:2])}")


def flash_bwd(q, k, v, do, m, l, delta, bias=None, *, scale: float,
              causal: bool, dropout_p: float = 0.0,
              seed: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K4 on CUDA tensors.  q, do (BH, Sq, D) and k, v (BH, Sk,
    D), all bf16 or all f32, any D; m, l and delta (BH, Sq) f32;
    bias and seed as K3's.  Returns dq, dk, dv in q's dtype (the dK/dV
    pass, then the dQ pass)."""
    more = [t for t in (bias, seed) if t is not None]
    _check_qkv("flash_bwd", q, k, v, do, m, l, delta, *more)
    _check_bwd_operands("flash_bwd", q, do, m, l, delta)
    _check_vectors("flash_bwd", m, l, delta)
    bias_ptr, seed_ptr, groups, rows, threshold, drop_scale = _operand_args(
        "flash_bwd", q, k, bias, dropout_p, seed)
    bh, sq, d = q.shape
    sk = k.shape[1]
    dh, (q, k, v, do) = _padded("flash_bwd", d, q, k, v, do)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _dispatch.launch(
        KERNEL_BWD if q.dtype == torch.bfloat16 else KERNEL_BWD_F32,
        _BWD_ARGS, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
        bias_ptr, seed_ptr, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        sq, sk, dh, groups, rows, float(scale), int(causal), threshold,
        drop_scale, **_variant("bwd", q, sq, dh, causal),
    )
    return _unpad(dq, d), _unpad(dk, d), _unpad(dv, d)


def flash_dbias(q, k, v, do, m, l, delta, bias, *, scale: float,
                causal: bool, dropout_p: float = 0.0,
                seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K5 on CUDA tensors: the f32 gradient of the (G, RS, Sk)
    ``bias``, in its layout, from K4's operands (q, do (BH, Sq, D) and k,
    v (BH, Sk, D), all bf16 or all f32, any D; m, l, delta (BH,
    Sq) f32; the int32 seed with ``dropout_p``).  Each group's members,
    and every query row when RS = 1, are summed inside the kernel in a
    fixed order: the gradient is the same from run to run."""
    if bias is None:
        raise ValueError("flash_dbias needs the bias it differentiates")
    more = [bias] + ([] if seed is None else [seed])
    _check_qkv("flash_dbias", q, k, v, do, m, l, delta, *more)
    _check_bwd_operands("flash_dbias", q, do, m, l, delta)
    _check_vectors("flash_dbias", m, l, delta)
    bias_ptr, seed_ptr, groups, rows, threshold, drop_scale = _operand_args(
        "flash_dbias", q, k, bias, dropout_p, seed)
    bh, sq, d = q.shape
    sk = k.shape[1]
    dh, (q, k, v, do) = _padded("flash_dbias", d, q, k, v, do)
    dbias = torch.empty_like(bias)
    _dispatch.launch(
        KERNEL_DBIAS if q.dtype == torch.bfloat16 else KERNEL_DBIAS_F32,
        _DBIAS_ARGS, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
        bias_ptr, seed_ptr, dbias.data_ptr(), bh, sq, sk, dh, groups, rows,
        float(scale), int(causal), threshold, drop_scale,
    )
    return dbias


def _fused_dbias(bias, bh, sq, dtype, d) -> bool:
    """Whether the bias gradient of a call on the card leaves K4's dQ pass
    (:func:`flash_bwd_dbias`) instead of a K5 launch of its own: bf16 q/k/v,
    a (G, RS, Sk) bias at G = BH and RS = Sq (each dbias element then
    belongs to one (bh, row, key), the layout of every trainable bias the
    ported models train) and a kernel head dim of at most 256 (the wide
    instance and the f32 instances keep K5)."""
    return (bias is not None and dtype == torch.bfloat16
            and tuple(bias.shape[:2]) == (bh, sq)
            and kernel_head_dim(d) <= KERNEL_HEAD_DIMS[-1])


def flash_bwd_dbias(q, k, v, do, m, l, delta, bias, *, scale: float,
                    causal: bool, dropout_p: float = 0.0,
                    seed: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """K4 with K5's output as its dQ pass's epilogue, on CUDA tensors:
    ``(dq, dk, dv, dbias)`` from :func:`flash_bwd`'s operands, where
    :func:`_fused_dbias` holds (bf16, a bias (BH, Sq, Sk) f32, any D up
    to 256).  Each tile's f32 ds is written as dbias before the dQ
    product rounds it, so the bias, q, k, v and dO are read once for
    both gradients; every dbias element is written once, the same bits
    from run to run.  Raises for any other call (no fallback)."""
    if bias is None:
        raise ValueError("flash_bwd_dbias needs the bias it differentiates")
    more = [bias] + ([] if seed is None else [seed])
    _check_qkv("flash_bwd_dbias", q, k, v, do, m, l, delta, *more)
    _check_bwd_operands("flash_bwd_dbias", q, do, m, l, delta)
    _check_vectors("flash_bwd_dbias", m, l, delta)
    bias_ptr, seed_ptr, groups, rows, threshold, drop_scale = _operand_args(
        "flash_bwd_dbias", q, k, bias, dropout_p, seed)
    bh, sq, d = q.shape
    sk = k.shape[1]
    if not _fused_dbias(bias, bh, sq, q.dtype, d):
        raise ValueError(
            f"flash_bwd_dbias takes bf16 q/k/v, a bias ({bh}, {sq}, {sk}) "
            f"and a head dim up to 256, got {q.dtype}, bias "
            f"{tuple(bias.shape)}, D={d}: use flash_bwd and flash_dbias")
    dh, (q, k, v, do) = _padded("flash_bwd_dbias", d, q, k, v, do)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dbias = torch.empty_like(bias)
    _dispatch.launch(
        KERNEL_BWD_DBIAS, _BWD_DBIAS_ARGS, q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(),
        l.data_ptr(), delta.data_ptr(), bias_ptr, seed_ptr, dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(), bh, sq, sk, dh,
        groups, rows, float(scale), int(causal), threshold, drop_scale,
        **_variant("bwd", q, sq, dh, causal),
    )
    return _unpad(dq, d), _unpad(dk, d), _unpad(dv, d), dbias


# ---------------------------------------------------------------------------
# autograd and the public API
# ---------------------------------------------------------------------------


def _flat(x):
    b, h, s, d = x.shape
    return x.reshape(b * h, s, d).contiguous()


class _Flash(torch.autograd.Function):
    """Attention over (B, H, S, D) returning ``(o, lse)``: K3, K4 and K5
    on the card, the plain twins on the CPU.  ``bias`` is (G, RS, Sk);
    it gets a gradient only when it requires one (from K4's dQ pass
    where :func:`_fused_dbias` holds, else from K5), so a mask-only bias
    launches neither.  ``seed`` is the int32 dropout seed or None."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, causal, dropout_p):
        b, h, sq, d = q.shape
        fwd = flash_fwd if _dispatch.on_card(q, k, v) else flash_fwd_reference
        o, lse, m, l = fwd(_flat(q), _flat(k), _flat(v), bias, scale=scale,
                           causal=causal, dropout_p=dropout_p, seed=seed)
        ctx.save_for_backward(q, k, v, o, m, l, bias, seed)
        ctx.scale, ctx.causal, ctx.dropout_p = scale, causal, dropout_p
        ctx.set_materialize_grads(False)
        return o.reshape(b, h, sq, d), lse.reshape(b, h, sq)

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, m, l, bias, seed = ctx.saved_tensors
        b, h, sq, d = q.shape
        sk = k.shape[-2]
        do = (torch.zeros_like(o) if do is None
              else do.reshape(b * h, sq, d).to(q.dtype).contiguous())
        # delta_i = rowsum(dO * O) - dlse_i, O the dropped output: with
        # p = exp(s - lse), ds = p * (dp - delta) + p * dlse, so the lse
        # cotangent folds into delta and the kernels need nothing else
        delta = (do.float() * o.float()).sum(dim=-1)
        if dlse is not None:
            delta = delta - dlse.reshape(b * h, sq).float()
        on_card = _dispatch.on_card(q, k, v, do)
        args = (_flat(q), _flat(k), _flat(v), do, m, l, delta, bias)
        kw = dict(scale=ctx.scale, causal=ctx.causal,
                  dropout_p=ctx.dropout_p, seed=seed)
        dbias = None
        if (on_card and ctx.needs_input_grad[3]
                and _fused_dbias(bias, b * h, sq, q.dtype, d)):
            dq, dk, dv, dbias = flash_bwd_dbias(*args, **kw)
        else:
            bwd = flash_bwd if on_card else flash_bwd_reference
            dq, dk, dv = bwd(*args, **kw)
            if ctx.needs_input_grad[3]:
                dbias_fn = flash_dbias if on_card else flash_dbias_reference
                dbias = dbias_fn(*args, **kw)
        return (dq.reshape(b, h, sq, d), dk.reshape(b, h, sk, d),
                dv.reshape(b, h, sk, d), dbias, None, None, None, None)


def _format_bias(bias, b, h, sq, sk):
    """(B?, H?, Sq?, Sk?) bias -> the kernels' (G, RS, Sk) layout, f32,
    clamped at MASK_VALUE (``_format_bias`` without the TPU's padding): a
    head-independent bias keeps G in {1, B} and a query-independent one
    RS = 1, so a (B, 1, 1, Sk) padding mask never becomes a matrix; a
    head-dependent one is expanded to G = BH.  Differentiable: the
    backward of the clamp, expand and reshape takes a (G, RS, Sk) dbias
    back to the caller's shape."""
    if bias.dim() > 4:
        raise ValueError(f"bias of rank {bias.dim()} > 4")
    bias = bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape))
    bb, bhh, bsq, bsk = bias.shape
    if bb not in (1, b) or bhh not in (1, h) or bsq not in (1, sq) or (
            bsk not in (1, sk)):
        raise ValueError(
            f"bias {tuple(bias.shape)} does not broadcast to "
            f"{(b, h, sq, sk)}"
        )
    bias = torch.clamp(bias.float(), min=MASK_VALUE).expand(bb, bhh, bsq, sk)
    if bhh == 1:
        return bias.reshape(bb, bsq, sk).contiguous()
    return bias.expand(b, h, bsq, sk).reshape(b * h, bsq, sk).contiguous()


def _dropout_seed(dropout_p, generator, dropout_seed, device):
    _check_dropout_p(dropout_p)
    if dropout_p == 0.0:
        return None
    if dropout_seed is not None:
        return dropout_seed.reshape(1).to(torch.int32)
    if generator is None:
        raise ValueError(
            "dropout_p > 0 requires a generator or a dropout_seed")
    return draw_dropout_seed(generator, device)


def _attend(op, q, k, v, bias, *, causal, scale, dropout_p, generator,
            dropout_seed, bias_grad=False):
    """The public functions' common part: the default scale, the seed,
    the bias's layout (detached unless ``bias_grad``), then
    :class:`_Flash`.  q, k and v of one dtype, bf16 or f32, go as they
    are; mixed dtypes or another float dtype (f16) are widened to f32,
    exactly, as the reference's kernels widen each operand before their
    dots, and o comes back in q's dtype (each gradient in its input's)."""
    b, h, sq, d = q.shape
    scale = d ** -0.5 if scale is None else float(scale)
    seed = _dropout_seed(dropout_p, generator, dropout_seed, q.device)
    on_card = _dispatch.on_card(q, k, v, *([] if bias is None else [bias]))
    _dispatch.record_path(op, "cuda" if on_card else "torch")
    if bias is not None:
        bias = _format_bias(bias if bias_grad else bias.detach(), b, h, sq,
                            k.shape[-2])
    out_dtype = q.dtype
    if k.dtype != q.dtype or v.dtype != q.dtype or (
            q.dtype not in _KERNEL_DTYPES):
        q, k, v = (t.float() for t in (q, k, v))
    o, lse = _Flash.apply(q, k, v, bias, seed, scale, bool(causal),
                          float(dropout_p))
    return o.to(out_dtype), lse


def flash_attention(q, k, v, bias=None, *, causal: bool = False,
                    scale: Optional[float] = None, dropout_p: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    dropout_seed: Optional[torch.Tensor] = None,
                    bias_grad: bool = False):
    """Fused scaled-dot-product attention: q (B,H,Sq,D), k/v (B,H,Sk,D)
    -> (B,H,Sq,D) in the input dtype, differentiable in q, k and v.

    ``bias`` (rank <= 4, broadcastable to (B,H,Sq,Sk)) is clamped at
    MASK_VALUE and gets no gradient, unless ``bias_grad=True``: then its
    gradient comes from K5 (``flash_dbias``) on the card and from
    :func:`flash_dbias_reference` on the CPU.  ``dropout_p`` > 0 drops attention
    probabilities with the kernels' keep mask, seeded by ``dropout_seed``
    (an int32 tensor) or else by a seed drawn from ``generator``.  Under
    an active O1 policy (:mod:`apex_tpu_torch.amp.lists`) q, k and v are
    cast to its half dtype first, so the kernels take the cast tensors
    and the gradients come back in the caller's dtypes."""
    from apex_tpu_torch.amp.lists import amp_cast

    q, k, v = amp_cast("attention", q, k, v)
    return _attend("flash_attention", q, k, v, bias, causal=causal,
                   scale=scale, dropout_p=dropout_p, generator=generator,
                   dropout_seed=dropout_seed, bias_grad=bias_grad)[0]


def flash_attention_with_lse(q, k, v, bias=None, *, causal: bool = False,
                             scale: Optional[float] = None,
                             dropout_p: float = 0.0,
                             generator: Optional[torch.Generator] = None,
                             dropout_seed: Optional[torch.Tensor] = None):
    """Fused attention returning ``(o, lse)``: o (B,H,Sq,D) in the input
    dtype and the undropped f32 row logsumexp (B,H,Sq), both
    differentiable (the lse gradient folds into delta, as in
    ``_flash_lse_bwd``).  ``bias``, dropout and the O1 cast as in
    :func:`flash_attention` (the bias gets no gradient)."""
    from apex_tpu_torch.amp.lists import amp_cast

    q, k, v = amp_cast("attention", q, k, v)
    return _attend("flash_attention_with_lse", q, k, v, bias, causal=causal,
                   scale=scale, dropout_p=dropout_p, generator=generator,
                   dropout_seed=dropout_seed)


def fmha_qkvpacked(qkv, bias=None, *, causal: bool = False,
                   scale: Optional[float] = None, dropout_p: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   dropout_seed: Optional[torch.Tensor] = None):
    """Packed-QKV attention (the reference's ``fmha_qkvpacked``, as
    ``apex/contrib/fmha``'s ``FMHAFun``): ``qkv`` (B, S, 3, H, D), the
    output of a fused QKV projection, to (B, S, H, D) through
    :func:`flash_attention` (K3 forward and K4 backward on the card).
    ``bias`` and dropout as in :func:`flash_attention`."""
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o = flash_attention(q, k, v, bias, causal=causal, scale=scale,
                        dropout_p=dropout_p, generator=generator,
                        dropout_seed=dropout_seed)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# launch plans for the static analysis (apex_tpu_torch.analysis.kernels):
# the instance, grid, threads and shared memory each launcher of
# csrc/flash_fwd.cu, flash_bwd.cu, flash_dbias.cu and flash_f32.cu picks
# ---------------------------------------------------------------------------

#: the C entry points whose launches :func:`specs_from_args` describes
SPEC_ENTRIES = (KERNEL, KERNEL_BWD, KERNEL_DBIAS, KERNEL_BWD_DBIAS,
                KERNEL_F32, KERNEL_BWD_F32, KERNEL_DBIAS_F32)

#: flash_operands.cuh's BiasMode
_NO_BIAS, _BIAS_GLOBAL, _BIAS_TILE = 0, 1, 2
#: K3's q rows a CTA (two 64-row consumer warpgroups); K4's resident rows
_BLOCK_Q = 128
#: the causal walk's granularity: 64 rows (a warpgroup, K4's ring stage)
#: by 64 keys
_WALK = 64
#: the Hopper kernels' threads: two consumer warpgroups and the producer's
_HOPPER_THREADS = 384
#: the f32 instances' and K5's threads (four warps)
_WARPS4_THREADS = 128


def _cdiv(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def _flag(b) -> str:
    return "true" if b else "false"


def _define(defines, name):
    for d in defines:
        key, _, value = str(d).partition("=")
        if key == name:
            return int(value)
    return None


def _bias_mode(bias_cls: int, rows: int, sq: int, sk: int) -> int:
    """``flash_operands::bias_mode`` on a pointer class."""
    if not bias_cls:
        return _NO_BIAS
    tma = rows == sq and sq > 1 and sk % 4 == 0 and bias_cls == 16
    return _BIAS_TILE if tma else _BIAS_GLOBAL


def causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs a head computes: row i sees ``min(max(i + sk -
    sq + 1, 0), sk)`` keys under the bottom-right causal mask."""
    if not causal:
        return int(sq) * int(sk)
    import numpy as np

    rows = np.arange(int(sq), dtype=np.int64) + (int(sk) - int(sq)) + 1
    return int(np.clip(rows, 0, int(sk)).sum())


def _attn_work(kind: str, bh, sq, sk, d, elem, bias_bytes, seed, causal,
               f32) -> dict:
    """Each input read once and each output written once — q, k, v (and
    dO) in, o (dq, dk, dv) out, the f32 row statistics, the bias (and
    dbias) and the seed — and the products' operations over the live
    pairs: 2 products of 2·D a pair forward (K3, K5's recompute), 5
    backward (K4); an f32 product is three TF32 products."""
    q_el, k_el = bh * sq * d, bh * sk * d
    live = bh * causal_pairs(sq, sk, causal)
    extra = 3 * 4 * bh * sq + bias_bytes + (4 if seed else 0)
    mult, peak = (3, "tf32_tensor") if f32 else (1, "bf16_tensor")
    if kind == "fwd":
        return {"bytes": elem * 2 * (q_el + k_el) + extra,
                "ops": mult * 4 * d * live, "peak": peak}
    if kind == "dbias":
        return {"bytes": elem * 2 * (q_el + k_el) + extra + bias_bytes,
                "ops": mult * 4 * d * live, "peak": peak}
    nbytes = elem * (3 * q_el + 4 * k_el) + extra
    if kind == "bwd_dbias":
        nbytes += bias_bytes
    return {"bytes": nbytes, "ops": mult * 10 * d * live, "peak": peak}


def _causal_geometry(bh, sq, sk, causal, bq=_WALK, bk=_WALK):
    return {"causal": bool(causal), "bq": bq, "bk": bk, "nq": _cdiv(sq, bq),
            "nk": _cdiv(sk, bk), "offset": sk - sq,
            "include_fully_masked": True, "heads": bh}


def _k3_bf16(bh, sq, sk, d, mode, dropout, defines, sms):
    from apex_tpu_torch.ops.introspect import KernelSpec

    boxes = []
    if d > 256:  # the wide instance: 64-column stages, 128-column items
        bias_tile = _BLOCK_Q * 64 * 4 if mode == _BIAS_TILE else 0
        smem = (1024 + 4 * (_BLOCK_Q * 128 + 64 * 128)
                + 2 * (64 * 2 * 128 + bias_tile) + 8 * 2 * (4 + 2))
        items = bh * (d // 128) * _cdiv(sq, _BLOCK_Q)
        name, inst, block_k, stages = (
            "flash_fwd_wide_kernel", f"<{mode}, {_flag(dropout)}>", 64, 4)
    else:
        dv = d if d < 128 else 128
        qbufs = 1 if d > 128 else 2
        bk_def = _define(defines, "APEX_FLASH_FWD_BLOCK_K")
        st_def = _define(defines, "APEX_FLASH_FWD_STAGES")
        if bk_def is not None:
            block_k = bk_def if d < 128 else 64
        else:
            block_k = 128 if mode == _NO_BIAS and d < 128 else 64  # lint: allow(kernel-hardcoded-block): the kernel's default
        if st_def is not None:
            stages = st_def if d < 128 else (3 if mode == _NO_BIAS else 2)
        else:
            stages = 3 if mode == _NO_BIAS else 2
        bias_tile = _BLOCK_Q * block_k * 4 if mode == _BIAS_TILE else 0
        smem = (1024 + 2 * d * qbufs * _BLOCK_Q
                + 2 * (d + dv) * stages * block_k + bias_tile * stages
                + 8 * (2 * stages + 2 * qbufs))
        items = bh * (d // dv) * _cdiv(sq, _BLOCK_Q)
        name, inst = ("flash_fwd_kernel",
                      f"<{d}, {mode}, {_flag(dropout)}>")
    boxes = [(_BLOCK_Q, 128), (block_k, 128)]
    if mode == _BIAS_TILE:
        boxes.append((_BLOCK_Q, 128))
    return KernelSpec(
        name=name, entry=KERNEL, instance=inst, grid=min(items, sms),
        threads=_HOPPER_THREADS, smem_bytes=smem, min_blocks=1,
        tile={"block_q": _BLOCK_Q, "block_k": block_k, "d": d},
        stages=stages,
        mma={"op": "wgmma", "m": 64, "n": block_k, "k": 16,
             "dtype": "bfloat16"},
        tma=tuple(boxes),
        items={"n_items": items, "per_cta": "persistent"},
        writes=("o", "lse", "m", "l"),
        causal=None, flops_per_cell=4.0 * _WALK * _WALK * d,
        meta={"defines": tuple(defines)})


def _k4_bf16(bh, sq, sk, d, mode, dropout, defines, dbias):
    from apex_tpu_torch.ops.introspect import KernelSpec

    stage_bias = 64 * _BLOCK_Q * 4 if mode == _BIAS_TILE else 0
    nk, nq = _cdiv(sk, _BLOCK_Q), _cdiv(sq, _BLOCK_Q)
    inst = f"<{mode}, {_flag(dropout)}>"
    if d > 256:
        a_bytes = 2 * (64 * 128 + _BLOCK_Q * 128)

        def wide(stats):
            stages_b = 2 if stats or mode != _BIAS_TILE else 1
            b = -(-((3 * 64 * 4 if stats else 64 * 2 * 128) + stage_bias)
                  // 1024) * 1024
            return 1024 + 3 * a_bytes + stages_b * b + 8 * 2 * (3 + 2)

        plans = [("flash_bwd_dkdv_wide_kernel", inst, wide(True),
                  bh * nk * (d // 64), ("dk", "dv"), 8.0, 3),
                 ("flash_bwd_dq_wide_kernel", inst, wide(False),
                  bh * nq * (d // 128), ("dq",), 6.0, 3)]
    else:
        st_def = _define(defines, "APEX_FLASH_BWD_STAGES")
        if st_def is not None and d < 128:
            stages = st_def
        else:
            stages = 1 if d > 128 else (3 if mode == _NO_BIAS else 2)
        base = (1024 + 2 * d * 2 * (_BLOCK_Q + stages * 64)
                + stage_bias * stages + 8 * (2 * stages + 1))
        inst = f"<{d}, {mode}, {_flag(dropout)}>"
        dq_name = "flash_bwd_dq_dbias_kernel" if dbias else \
            "flash_bwd_dq_kernel"
        plans = [("flash_bwd_dkdv_kernel", inst, base + 4 * 3 * 64 * stages,
                  bh * nk * (d // 64 if d >= 128 else 1), ("dk", "dv"), 8.0,
                  stages),
                 (dq_name, inst, base, bh * nq * (d // 128 if d > 128 else 1),
                  ("dq", "dbias") if dbias else ("dq",), 6.0, stages)]
    boxes = [(64, 128), (_BLOCK_Q, 128)]
    if mode == _BIAS_TILE:
        boxes += [(64, 128), (_BLOCK_Q, 128)]
    entry = KERNEL_BWD_DBIAS if dbias else KERNEL_BWD
    return [KernelSpec(
        name=name, entry=entry, instance=inst_, grid=grid,
        threads=_HOPPER_THREADS, smem_bytes=smem, min_blocks=1,
        tile={"block_q": 64, "block_k": 64, "resident": _BLOCK_Q, "d": d},
        stages=stages, mma={"op": "wgmma", "m": 64, "n": 64, "k": 16,
                            "dtype": "bfloat16"},
        tma=tuple(boxes), items={"n_items": grid, "per_cta": "one"},
        writes=writes, flops_per_cell=per * _WALK * _WALK * d,
        meta={"defines": tuple(defines)})
        for name, inst_, smem, grid, writes, per, stages in plans]


def _k5_bf16(bh, sq, sk, d, groups, rows, dropout):
    from apex_tpu_torch.ops.introspect import KernelSpec

    kd = d if d in KERNEL_HEAD_DIMS else 0
    ld = (kd + 8) if kd else 72
    row_bias = rows != 1
    grid = groups * (_cdiv(sq, 64) if row_bias else 1) * _cdiv(sk, 64)
    return KernelSpec(
        name="flash_dbias_kernel", entry=KERNEL_DBIAS,
        instance=f"<{kd}, {_flag(row_bias)}, {_flag(dropout)}>", grid=grid,
        threads=_WARPS4_THREADS, smem_bytes=2 * 4 * 64 * ld + 4 * 2 * 4 * 16 * 68,
        tile={"block_q": 64, "block_k": 64, "d": d},
        mma={"op": "wmma", "m": 16, "n": 16, "k": 16, "dtype": "bfloat16"},
        items={"n_items": grid, "per_cta": "one"}, writes=("dbias",),
        flops_per_cell=4.0 * 64 * 64 * d)


def _f32_specs(entry, bh, sq, sk, d, has_bias, groups, rows, dropout):
    from apex_tpu_torch.ops.introspect import KernelSpec

    b, dr = _flag(has_bias), _flag(dropout)
    mma = {"op": "mma.sync", "m": 16, "n": 8, "k": 8, "dtype": "tf32"}
    nq, nk = _cdiv(sq, 64), _cdiv(sk, 64)

    def spec(name, inst, smem, grid, writes, per, stages):
        return KernelSpec(
            name=name, entry=entry, instance=inst, grid=grid,
            threads=_WARPS4_THREADS, smem_bytes=smem, dtype="float32",
            tile={"block_q": 64, "block_k": 32, "d": d}, stages=stages,
            mma=mma, items={"n_items": grid, "per_cta": "one"},
            writes=writes, flops_per_cell=per * 64 * 32 * d)

    bias_q = 64 * 40 if has_bias else 0     # a (64 x 32) bias tile
    bias_k = 32 * 68 if has_bias else 0     # a (32 x 64) bias tile
    if entry == KERNEL_F32:
        if d > 256:
            smem = 4 * 3 * (64 * 68 + 32 * 68 + 32 * 132 + bias_q)
            return [spec("flash_fwd_f32_wide_kernel", f"<{b}, {dr}>", smem,
                         bh * nq * (d // 128), ("o", "lse", "m", "l"), 4.0,
                         3)]
        dv = d if d < 128 else 128
        stages = 3 if d <= 64 else 2
        ld, ldv = d + 4, dv + 4
        smem = 4 * (64 * ld + stages * (32 * ld + 32 * ldv + bias_q))
        return [spec("flash_fwd_f32_kernel", f"<{d}, {b}, {dr}>", smem,
                     bh * nq * (d // dv), ("o", "lse", "m", "l"), 4.0,
                     stages)]
    if entry == KERNEL_BWD_F32:
        if d > 256:
            dkdv = 4 * 2 * (2 * 64 * 68 + 2 * 32 * 68 + 3 * 32 + bias_k)
            dq = 4 * 2 * (2 * 64 * 68 + 2 * 32 * 68 + 32 * 132 + bias_q)
            return [spec("flash_bwd_dkdv_f32_wide_kernel", f"<{b}, {dr}>",
                         dkdv, bh * nk * (d // 64), ("dk", "dv"), 8.0, 2),
                    spec("flash_bwd_dq_f32_wide_kernel", f"<{b}, {dr}>", dq,
                         bh * nq * (d // 128), ("dq",), 6.0, 2)]
        ld = d + 4
        dv = d if d < 128 else 128
        kv = d if d < 64 else 64
        st_kv = 3 if d == 32 else 2 if d <= 128 else 1
        st_q = 2 if d <= 128 else 1
        dkdv = 4 * (2 * 64 * ld + st_kv * (2 * 32 * ld + 3 * 32 + bias_k))
        dq = 4 * (2 * 64 * ld + st_q * (2 * 32 * ld + bias_q))
        return [spec("flash_bwd_dkdv_f32_kernel", f"<{d}, {b}, {dr}>", dkdv,
                     bh * nk * (d // kv), ("dk", "dv"), 8.0, st_kv),
                spec("flash_bwd_dq_f32_kernel", f"<{d}, {b}, {dr}>", dq,
                     bh * nq * (d // dv), ("dq",), 6.0, st_q)]
    # flash_dbias_f32
    row_bias = rows != 1
    resident = row_bias and groups == bh
    if d == 32:
        kc, blocked = 32, False
    elif d == 64:
        kc, blocked = 64, False
    elif d == 128 and resident:
        kc, blocked = 128, False
    else:
        kc, blocked = 64, True
    ld = kc + 4
    stages = 3 if kc == 32 else 2
    res = (not blocked) and row_bias and bh // groups == 1
    stage = (0 if res else 2 * 64 * ld) + 2 * 32 * ld + 64 * 36
    smem = 4 * ((2 * 64 * ld if res else 0) + stages * stage)
    grid = groups * (nq if row_bias else _cdiv(sk, 32))
    return [spec("flash_dbias_f32_kernel",
                 f"<{kc}, {_flag(blocked)}, {_flag(row_bias)}, {dr}>", smem,
                 grid, ("dbias",), 4.0, stages)]


def specs_from_args(entry: str, args: tuple, defines=(), *,
                    sms: int = 132, work_d: Optional[int] = None) -> list:
    """The specs of one recorded launch of K3, K4 or K5 (any instance; C
    argument order, pointers as
    :func:`~apex_tpu_torch.ops.introspect.pointer_class`); ``work_d`` is
    the caller's head dim before padding, for the work (default the
    kernel's)."""
    n_ptr = {KERNEL: 9, KERNEL_F32: 9, KERNEL_BWD: 12, KERNEL_BWD_F32: 12,
             KERNEL_DBIAS: 10, KERNEL_DBIAS_F32: 10,
             KERNEL_BWD_DBIAS: 13}[entry]
    ptrs = args[:n_ptr]
    bh, sq, sk, d, groups, rows, _scale, causal = args[n_ptr:n_ptr + 8]
    bias_cls = ptrs[3] if entry in (KERNEL, KERNEL_F32) else ptrs[7]
    seed = bool(ptrs[4] if entry in (KERNEL, KERNEL_F32) else ptrs[8])
    causal = bool(causal)
    f32 = entry in (KERNEL_F32, KERNEL_BWD_F32, KERNEL_DBIAS_F32)
    elem = 4 if f32 else 2
    bias_bytes = groups * rows * sk * 4 if bias_cls else 0
    wd = work_d or d
    if entry == KERNEL:
        specs = [_k3_bf16(bh, sq, sk, d, _bias_mode(bias_cls, rows, sq, sk),
                          seed, defines, sms)]
        kind = "fwd"
    elif entry in (KERNEL_BWD, KERNEL_BWD_DBIAS):
        specs = _k4_bf16(bh, sq, sk, d, _bias_mode(bias_cls, rows, sq, sk),
                         seed, defines, entry == KERNEL_BWD_DBIAS)
        kind = "bwd_dbias" if entry == KERNEL_BWD_DBIAS else "bwd"
    elif entry == KERNEL_DBIAS:
        specs = [_k5_bf16(bh, sq, sk, d, groups, rows, seed)]
        kind = "dbias"
    else:
        specs = _f32_specs(entry, bh, sq, sk, d, bool(bias_cls), groups,
                           rows, seed)
        kind = {KERNEL_F32: "fwd", KERNEL_BWD_F32: "bwd",
                KERNEL_DBIAS_F32: "dbias"}[entry]
    work = _attn_work(kind, bh, sq, sk, wd, elem, bias_bytes, seed, causal,
                      f32)
    for s in specs:
        s.causal = _causal_geometry(bh, sq, sk, causal)
        s.dtype = "float32" if f32 else "bfloat16"
        s.work = dict(work, call=entry)
    return specs


def kernel_specs(bh: int, sq: int, sk: int, d: int, *, dtype=torch.bfloat16,
                 causal: bool = True, bias_shape=None,
                 bias_aligned: bool = True, dropout: bool = False,
                 modes=("fwd", "bwd"), dbias: bool = False,
                 defines=None, sms: int = 132) -> list:
    """The :class:`~apex_tpu_torch.ops.introspect.KernelSpec` records of
    the launches :func:`flash_fwd` (mode "fwd"), :func:`flash_bwd`
    ("bwd"; with ``dbias`` at G = BH, RS = Sq and bf16,
    :func:`flash_bwd_dbias`) and :func:`flash_dbias` ("dbias") make for
    q (bh, sq, d) and k, v (bh, sk, d) of ``dtype``, a (G, RS, Sk)
    ``bias_shape`` and dropout, without running anything.  ``defines``
    names a tuned build (default: what the tuning cache names for the
    call, :mod:`.tune_cache`); the work (the roofline's bound) is counted
    at the caller's ``d``, the launch at the kernel head dim."""
    dk = kernel_head_dim(d)
    groups, rows = (bias_shape[0], bias_shape[1]) if bias_shape else (1, 1)
    bias_cls = 0 if bias_shape is None else (16 if bias_aligned else 4)
    bf16 = dtype == torch.bfloat16
    out = []
    for mode in modes:
        if mode == "fwd":
            entry = KERNEL if bf16 else KERNEL_F32
            args = (16, 16, 16, bias_cls, 16 if dropout else 0, 16, 16, 16,
                    16)
        elif mode == "bwd":
            fused = dbias and bf16 and bias_shape is not None and \
                (groups, rows) == (bh, sq) and dk <= KERNEL_HEAD_DIMS[-1]
            entry = KERNEL_BWD_DBIAS if fused else (
                KERNEL_BWD if bf16 else KERNEL_BWD_F32)
            args = (16,) * 7 + (bias_cls, 16 if dropout else 0) + \
                (16,) * (4 if fused else 3)
        else:
            entry = KERNEL_DBIAS if bf16 else KERNEL_DBIAS_F32
            args = (16,) * 7 + (bias_cls, 16 if dropout else 0, 16)
        if defines is None and bf16 and entry != KERNEL_DBIAS:
            from apex_tpu_torch.ops import tune_cache

            var = tune_cache.flash_defines("fwd" if mode == "fwd" else "bwd",
                                           sq, dk, causal, dtype)
        else:
            var = tuple(defines or ())
        out += specs_from_args(
            entry, args + (bh, sq, sk, dk, groups, rows, d ** -0.5,
                           int(causal), 0, 1.0), var, sms=sms, work_d=d)
    return out

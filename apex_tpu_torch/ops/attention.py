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
        drop_scale,
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
        drop_scale,
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

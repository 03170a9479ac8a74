"""Flash attention — forward and backward, public API and dispatch.

Counterpart of ``apex_tpu/ops/attention.py``.  Layout ``(B, H, S, D)``.

One ``autograd.Function`` (:class:`_Flash`) carries both directions and
saves ``q, k, v, o, lse``:

- **kernel path** (CUDA tensors): the forward is kernel K3
  (``csrc/flash_fwd.cu``, replacing the Pallas ``flash_fwd``) —
  online-softmax attention in one pass, bottom-right causal alignment,
  f32 row logsumexp; the backward is kernel K4 (``csrc/flash_bwd.cu``,
  replacing ``flash_bwd``) — dq, dk, dv recomputed from lse in two
  passes.  Both take bf16 q/k/v and any ``S_q``/``S_k`` (the kernels mask
  their own ragged edge, so nothing is padded), and head dim 64, the one
  the port's models use.  Every call on the card launches the kernels:
  the TPU's short-sequence routing to the unfused composition was a v5e
  measurement and is not carried over.
- **plain path** (CPU tensors): the twins :func:`mha_reference_with_lse`
  (the unfused f32-score composition of the JAX package) and
  :func:`flash_bwd_reference` (the recompute backward, with the closed
  form of fully-masked rows).

``delta = rowsum(dO * O) - dlse`` is computed in PyTorch before either
backward, as the JAX package does it in jnp outside Pallas, which folds
the gradient of :func:`flash_attention_with_lse`'s ``lse`` output.

Masked scores take the finite ``MASK_VALUE`` on both paths, so a row
that sees no key yields the uniform average of V.  An additive ``bias``
runs on the plain path only, differentiated by autograd through
:func:`mha_reference`; in the kernels it is still to be ported (K3's
bias and dropout operands, K5), so a bias on the card and dropout raise
``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _dispatch

__all__ = [
    "MASK_VALUE",
    "flash_attention",
    "flash_attention_with_lse",
    "flash_bwd",
    "flash_bwd_reference",
    "flash_fwd",
    "mha_reference",
    "mha_reference_with_lse",
]

#: large negative finite (not -inf), as apex_tpu's flash kernels use
MASK_VALUE = -1e9

KERNEL = "flash_fwd"
KERNEL_BWD = "flash_bwd"
_HEAD_DIMS = (64,)


def _causal_mask(sq, sk, device):
    """Bottom-right aligned: query row r sees keys <= r + (sk - sq)."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(
        diagonal=sk - sq
    )


def _scores(q, k, bias, causal, scale):
    """Scaled (+bias, causal-masked) f32 score matrix."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        mask = _causal_mask(s.shape[-2], s.shape[-1], s.device)
        s = s.masked_fill(~mask, MASK_VALUE)
    return s


def mha_reference(q, k, v, bias=None, *, causal: bool = False,
                  scale: Optional[float] = None):
    """Unfused attention with f32 scores — the plain version of
    :func:`flash_attention`.  q (B,H,Sq,D), k/v (B,H,Sk,D), bias
    broadcastable to (B,H,Sq,Sk)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = torch.softmax(_scores(q, k, bias, causal, scale), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def mha_reference_with_lse(q, k, v, bias=None, *, causal: bool = False,
                           scale: Optional[float] = None):
    """:func:`mha_reference` plus the f32 row logsumexp (..., Sq) — the
    plain version of K3.  Takes (B, H, S, D) or (BH, S, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, bias, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("...qk,...kd->...qd", (p / l).to(q.dtype), v)
    return o, (m + torch.log(l))[..., 0]


def flash_bwd_reference(q, k, v, do, lse, delta, *, scale: float,
                        causal: bool):
    """The plain version of K4: ``(dq, dk, dv)`` in q's dtype by
    recomputing ``p = exp(s*scale - lse)`` in f32 from the saved f32
    ``lse`` (..., Sq), with ``delta = rowsum(dO * O) - dlse`` (..., Sq).
    q, do (..., Sq, D); k, v (..., Sk, D).

    Under causal masking a masked pair has ``p = exp(MASK_VALUE - lse)``
    (0) and no score gradient; a fully-masked row (``Sq > Sk``, row +
    Sk - Sq < 0) has the closed form ``p = 1/Sk`` (``_recompute_p``):
    its saved lse, ``MASK_VALUE + log(Sk)``, rounds back to MASK_VALUE in
    f32, so the recompute would give 1."""
    sq, sk = q.shape[-2], k.shape[-2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("...qd,...kd->...qk", qf, kf) * scale
    mask = None
    if causal:
        mask = _causal_mask(sq, sk, s.device)
        s = s.masked_fill(~mask, MASK_VALUE)
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        rows = torch.arange(sq, device=s.device)
        fully_masked = (rows + (sk - sq) < 0)[:, None]
        p = torch.where(fully_masked, torch.full_like(p, 1.0 / sk), p)
    dv = torch.einsum("...qk,...qd->...kd", p, dof)
    dp = torch.einsum("...qd,...kd->...qk", dof, vf)
    ds = p * (dp - delta.float()[..., None])
    if mask is not None:
        ds = ds.masked_fill(~mask, 0.0)
    dq = torch.einsum("...qk,...kd->...qd", ds, kf) * scale
    dk = torch.einsum("...qk,...qd->...kd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]
_BWD_ARGS = [_P] * 9 + [_I, _I, _I, _I, _F, _I, _P]


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
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("the flash kernels take bf16 q, k and v")
    bh, sq, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (one of {_HEAD_DIMS})")
    if bh == 0 or sq == 0 or k.shape[1] == 0:
        raise ValueError(f"{name} needs non-empty q and k")


def _check_vectors(name, *tensors):
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(
            f"{name} takes contiguous, 16-byte aligned tensors (the kernel "
            f"loads 16-byte vectors)"
        )


def flash_fwd(q, k, v, *, scale: float, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3 on CUDA tensors.  q (BH, Sq, D), k/v (BH, Sk, D) bf16.
    Returns o (BH, Sq, D) bf16 and lse f32 (BH, Sq).  The causal mask is
    aligned bottom-right (offset ``Sk - Sq``)."""
    _check_qkv("flash_fwd", q, k, v)
    _check_vectors("flash_fwd", q, k, v)
    bh, sq, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    _dispatch.launch(
        KERNEL, _FWD_ARGS, q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, sq, sk, d,
        float(scale), int(causal),
    )
    return o, lse


def flash_bwd(q, k, v, do, lse, delta, *, scale: float, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K4 on CUDA tensors.  q, do (BH, Sq, D) and k, v (BH, Sk,
    D) bf16; lse and delta (BH, Sq) f32.  Returns dq, dk, dv in bf16
    (the dK/dV pass, then the dQ pass)."""
    _check_qkv("flash_bwd", q, k, v, do, lse, delta)
    if do.shape != q.shape or do.dtype != torch.bfloat16:
        raise ValueError(f"do must be bf16 of shape {tuple(q.shape)}")
    if any(t.shape != q.shape[:2] or t.dtype != torch.float32
           for t in (lse, delta)):
        raise ValueError(f"lse and delta must be f32 of shape {tuple(q.shape[:2])}")
    _check_vectors("flash_bwd", q, k, v, do, lse, delta)
    bh, sq, d = q.shape
    sk = k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _dispatch.launch(
        KERNEL_BWD, _BWD_ARGS, q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d,
        float(scale), int(causal),
    )
    return dq, dk, dv


def _flat(x):
    b, h, s, d = x.shape
    return x.reshape(b * h, s, d).contiguous()


class _Flash(torch.autograd.Function):
    """Attention over (B, H, S, D) returning ``(o, lse)``: K3 and K4 on
    the card, the plain twins on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        if _dispatch.on_card(q, k, v):
            b, h, sq, d = q.shape
            o, lse = flash_fwd(_flat(q), _flat(k), _flat(v), scale=scale,
                               causal=causal)
            o, lse = o.reshape(b, h, sq, d), lse.reshape(b, h, sq)
        else:
            o, lse = mha_reference_with_lse(q, k, v, causal=causal,
                                            scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        # delta_i = rowsum(dO * O) - dlse_i: with p = exp(s - lse),
        # ds = p * (dp - delta) + p * dlse, so the lse cotangent folds
        # into delta and the kernels need nothing else
        delta = (do.float() * o.float()).sum(dim=-1)
        if dlse is not None:
            delta = delta - dlse.float()
        if _dispatch.on_card(q, k, v, do):
            b, h, sq, d = q.shape
            sk = k.shape[-2]
            dq, dk, dv = flash_bwd(
                _flat(q), _flat(k), _flat(v), _flat(do.to(q.dtype)),
                lse.reshape(b * h, sq).contiguous(),
                delta.reshape(b * h, sq).contiguous(),
                scale=ctx.scale, causal=ctx.causal,
            )
            dq = dq.reshape(b, h, sq, d)
            dk, dv = dk.reshape(b, h, sk, d), dv.reshape(b, h, sk, d)
        else:
            dq, dk, dv = flash_bwd_reference(
                q, k, v, do, lse, delta, scale=ctx.scale, causal=ctx.causal
            )
        return dq, dk, dv, None, None


def flash_attention(q, k, v, bias=None, *, causal: bool = False,
                    scale: Optional[float] = None, dropout_p: float = 0.0):
    """Fused scaled-dot-product attention: q (B,H,Sq,D), k/v (B,H,Sk,D)
    -> (B,H,Sq,D) in the input dtype, differentiable in q, k and v.
    ``bias`` (broadcastable to (B,H,Sq,Sk), clamped at MASK_VALUE) runs
    on the plain path only; dropout is not ported yet on either path."""
    if dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet (ROADMAP: K3/K4 bias and "
            "dropout operands)"
        )
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _dispatch.on_card(q, k, v):
        if bias is not None:
            raise NotImplementedError(
                "an additive bias in the flash kernels is not ported yet "
                "(ROADMAP: K3/K4 bias and dropout operands, K5)"
            )
        _dispatch.record_path("flash_attention", "cuda")
        return _Flash.apply(q, k, v, scale, causal)[0]
    _dispatch.record_path("flash_attention", "torch")
    if bias is not None:
        bias = torch.clamp(bias, min=MASK_VALUE)
        return mha_reference(q, k, v, bias, causal=causal, scale=scale)
    return _Flash.apply(q, k, v, scale, causal)[0]


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             scale: Optional[float] = None):
    """Fused attention returning ``(o, lse)``: o (B,H,Sq,D) in the input
    dtype and the f32 row logsumexp (B,H,Sq), both differentiable (the
    lse gradient folds into delta, as in ``_flash_lse_bwd``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    path = "cuda" if _dispatch.on_card(q, k, v) else "torch"
    _dispatch.record_path("flash_attention_with_lse", path)
    return _Flash.apply(q, k, v, scale, causal)

"""Flash attention — forward, public API and dispatch.

Counterpart of ``apex_tpu/ops/attention.py``.  Layout ``(B, H, S, D)``.

- **plain path** (CPU tensors): :func:`mha_reference` /
  :func:`mha_reference_with_lse`, the unfused f32-score composition of
  the JAX package (with an additive bias).
- **kernel path** (CUDA tensors): kernel K3 (``csrc/flash_fwd.cu``,
  replacing the Pallas ``flash_fwd``) — online-softmax attention in one
  pass, bottom-right causal alignment, f32 row logsumexp.  It takes bf16
  q/k/v and any ``S_q``/``S_k`` (the kernel masks its own ragged edge, so
  nothing is padded), and head dim 64, the one the port's models use.
  Every call on
  the card launches the kernel: the TPU's short-sequence routing to the
  unfused composition was a v5e measurement and is not carried over.

Masked scores take the finite ``MASK_VALUE`` on both paths, so a row
that sees no key yields the uniform average of V.

Forward only: an additive bias in the kernel, dropout and the backward
(TPU kernels K4/K5 and K3's bias/dropout operands) are still to be
ported, so they raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build, _dispatch

__all__ = [
    "MASK_VALUE",
    "flash_attention",
    "flash_attention_with_lse",
    "flash_fwd",
    "mha_reference",
    "mha_reference_with_lse",
]

#: large negative finite (not -inf), as apex_tpu's flash kernels use
MASK_VALUE = -1e9

KERNEL = "flash_fwd"
_HEAD_DIMS = (64,)


def _scores(q, k, bias, causal, scale):
    """Scaled (+bias, causal-masked) f32 score matrix."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(
            diagonal=sk - sq
        )
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
    """:func:`mha_reference` plus the f32 row logsumexp (B, H, Sq)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, bias, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", (p / l).to(q.dtype), v)
    return o, (m + torch.log(l))[..., 0]


def _lib():
    fn = _build.load(KERNEL).flash_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_fwd(q, k, v, *, scale: float, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3 on CUDA tensors.  q (BH, Sq, D), k/v (BH, Sk, D) bf16.
    Returns o (BH, Sq, D) bf16 and lse f32 (BH, Sq).  The causal mask is
    aligned bottom-right (offset ``Sk - Sq``)."""
    if not _dispatch.on_card(q, k, v):
        raise ValueError("flash_fwd launches the CUDA kernel: pass CUDA tensors")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or (
        q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]
    ):
        raise ValueError(
            f"expected q (BH, Sq, D) and k, v (BH, Sk, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("the flash kernel takes bf16 q, k and v")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError(
            "flash_fwd takes contiguous, 16-byte aligned tensors (the "
            "kernel loads 16-byte vectors)"
        )
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (one of {_HEAD_DIMS})")
    if bh == 0 or sq == 0 or sk == 0:
        raise ValueError("flash_fwd needs non-empty q and k")
    o = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), bh, sq, sk, d, float(scale), int(causal),
                stream)
    _build.check(KERNEL, rc)
    _dispatch.count_launch(KERNEL)
    return o, lse


def _kernel_call(op, q, k, v, bias, causal, scale):
    if bias is not None:
        raise NotImplementedError(
            "an additive bias in the flash kernel is not ported yet "
            "(ROADMAP: K3 bias/dropout operands)"
        )
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash backward kernel (K4) is not ported yet: call the "
            "CUDA forward under torch.no_grad()"
        )
    _dispatch.record_path(op, "cuda")
    b, h, sq, d = q.shape
    sk = k.shape[-2]
    o, lse = flash_fwd(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, sk, d).contiguous(),
        v.reshape(b * h, sk, d).contiguous(),
        scale=scale, causal=causal,
    )
    return o.reshape(b, h, sq, d), lse.reshape(b, h, sq)


def flash_attention(q, k, v, bias=None, *, causal: bool = False,
                    scale: Optional[float] = None, dropout_p: float = 0.0):
    """Fused scaled-dot-product attention: q (B,H,Sq,D), k/v (B,H,Sk,D)
    -> (B,H,Sq,D) in the input dtype.  ``bias`` (broadcastable to
    (B,H,Sq,Sk), clamped at MASK_VALUE) runs on the plain path only;
    dropout is not ported yet on either path."""
    if dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet (ROADMAP: K3 bias/dropout "
            "operands)"
        )
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _dispatch.on_card(q, k, v):
        return _kernel_call("flash_attention", q, k, v, bias, causal, scale)[0]
    _dispatch.record_path("flash_attention", "torch")
    if bias is not None:
        bias = torch.clamp(bias, min=MASK_VALUE)
    return mha_reference(q, k, v, bias, causal=causal, scale=scale)


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             scale: Optional[float] = None):
    """Fused attention returning ``(o, lse)``: o (B,H,Sq,D) in the input
    dtype and the f32 row logsumexp (B,H,Sq)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _dispatch.on_card(q, k, v):
        return _kernel_call(
            "flash_attention_with_lse", q, k, v, None, causal, scale
        )
    _dispatch.record_path("flash_attention_with_lse", "torch")
    return mha_reference_with_lse(q, k, v, causal=causal, scale=scale)

"""Fused LayerNorm / RMSNorm — forward.

Counterpart of ``apex_tpu/ops/layer_norm.py``: ``fused_layer_norm_affine``,
``fused_layer_norm``, ``fused_rms_norm_affine`` and ``fused_rms_norm``.

Semantics (both paths): statistics and normalization in **f32**
whatever the input dtype; the output has the input's dtype; mean and
rstd are kept in f32.  For a CUDA tensor the row-wise work is kernel K1
(``csrc/layer_norm_fwd.cu``, replacing the Pallas ``layer_norm_fwd``);
for a CPU tensor it is :func:`layer_norm_reference`, the arithmetic of
the JAX package's ``_jnp_fwd``.  The kernel takes any hidden size: the
TPU's lane rule (``hidden % 128``) does not apply.

Forward only: the backward (TPU kernel K2) is still to be ported, so the
CUDA path refuses inputs that require a gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops import _build, _dispatch

__all__ = [
    "fused_layer_norm",
    "fused_layer_norm_affine",
    "fused_rms_norm",
    "fused_rms_norm_affine",
    "layer_norm_fwd",
    "layer_norm_reference",
]

Shape = Union[int, Sequence[int]]

KERNEL = "layer_norm_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_reference(
    x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float,
    rms: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: ``(y, mu, rstd)`` with ``mu``/``rstd`` f32
    ``(rows,)`` — ``_jnp_fwd``'s arithmetic."""
    xf = x2d.float()
    wf = w.float()
    bf = b.float()
    if rms:
        mu = torch.zeros(xf.shape[0], dtype=torch.float32, device=xf.device)
        var = (xf * xf).mean(dim=-1)
    else:
        mu = xf.mean(dim=-1)
        xc = xf - mu[:, None]
        var = (xc * xc).mean(dim=-1)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mu[:, None]) * rstd[:, None] * wf + bf
    return y.to(x2d.dtype), mu, rstd


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.layer_norm_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def layer_norm_fwd(
    x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, eps: float,
    rms: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K1 on CUDA tensors: ``(y, mu, rstd)`` for ``x2d`` (rows,
    hidden) in f32 or bf16 and f32 ``w``/``b`` (hidden,)."""
    if not _dispatch.on_card(x2d, w, b):
        raise ValueError("layer_norm_fwd launches the CUDA kernel: pass CUDA tensors")
    if x2d.dim() != 2 or w.shape != (x2d.shape[1],) or b.shape != w.shape:
        raise ValueError(
            f"expected x (rows, hidden) and w, b (hidden,), got "
            f"{tuple(x2d.shape)}, {tuple(w.shape)}, {tuple(b.shape)}"
        )
    if x2d.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm_fwd takes f32 or bf16 x, got {x2d.dtype}")
    if w.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("layer_norm_fwd takes f32 weight and bias")
    if not (x2d.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("layer_norm_fwd takes contiguous tensors")
    rows, hidden = x2d.shape
    y = torch.empty_like(x2d)
    mu = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    if rows == 0:
        return y, mu, rstd
    fn = _lib()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x2d.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                mu.data_ptr(), rstd.data_ptr(), rows, hidden, float(eps),
                int(rms), _DTYPE_CODES[x2d.dtype], stream)
    _build.check(KERNEL, rc)
    _dispatch.count_launch(KERNEL)
    return y, mu, rstd


def _run(x, normalized_shape, w, b, eps, rms):
    shape_t = (
        (normalized_shape,)
        if isinstance(normalized_shape, int)
        else tuple(normalized_shape)
    )
    hidden = math.prod(shape_t)
    if tuple(x.shape[-len(shape_t):]) != shape_t:
        raise ValueError(
            f"normalized_shape {normalized_shape} does not match the trailing "
            f"dimensions of input shape {tuple(x.shape)}"
        )
    x2d = x.reshape(-1, hidden)
    w = (torch.ones(hidden, dtype=torch.float32, device=x.device)
         if w is None else w.reshape(hidden))
    b = (torch.zeros(hidden, dtype=torch.float32, device=x.device)
         if b is None else b.reshape(hidden))
    op = "rms_norm" if rms else "layer_norm"
    if _dispatch.on_card(x2d, w, b):
        if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x2d, w, b)
        ):
            raise NotImplementedError(
                "the LayerNorm backward kernel (K2) is not ported yet: call "
                "the CUDA forward under torch.no_grad()"
            )
        _dispatch.record_path(op, "cuda")
        y, _, _ = layer_norm_fwd(
            x2d.contiguous(), w.float().contiguous(), b.float().contiguous(),
            eps=float(eps), rms=rms,
        )
    else:
        _dispatch.record_path(op, "torch")
        y, _, _ = layer_norm_reference(x2d, w, b, float(eps), rms)
    return y.reshape(x.shape)


def fused_layer_norm_affine(x, weight, bias, normalized_shape: Shape,
                            eps: float = 1e-6):
    """≙ apex_tpu.ops.layer_norm.fused_layer_norm_affine (forward)."""
    return _run(x, normalized_shape, weight, bias, eps, False)


def fused_layer_norm(x, normalized_shape: Shape, eps: float = 1e-6):
    """Non-affine LayerNorm (≙ fused_layer_norm)."""
    return _run(x, normalized_shape, None, None, eps, False)


def fused_rms_norm_affine(x, weight, normalized_shape: Shape,
                          eps: float = 1e-6):
    """≙ apex_tpu.ops.layer_norm.fused_rms_norm_affine (forward)."""
    return _run(x, normalized_shape, weight, None, eps, True)


def fused_rms_norm(x, normalized_shape: Shape, eps: float = 1e-6):
    """Non-affine RMSNorm (≙ fused_rms_norm)."""
    return _run(x, normalized_shape, None, None, eps, True)

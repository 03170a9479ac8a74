"""Rotary position embedding (RoPE), rotate_half convention.

Counterpart of ``apex_tpu/ops/rope.py``: plain PyTorch, as the
JAX package's version is plain jnp — there is no kernel to port.  The
rotation runs in f32 and casts back to the input dtype:

    y = t * cos + rotate_half(t) * sin

Only the first ``rot_dim = cos.shape[-1]`` channels rotate; the tail
passes through.  The gradient is autograd's through the f32 rotation,
which is the JAX package's ``_transpose_apply``: ``dt = g * cos +
rotate_half^T(g * sin)`` in f32, cast to ``t``'s dtype, with the tail's
gradient passed through and none for the tables.
"""

from __future__ import annotations

import torch

__all__ = [
    "rotate_half",
    "fused_apply_rotary_pos_emb",
    "fused_apply_rotary_pos_emb_cached",
]


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def fused_apply_rotary_pos_emb_cached(
    t: torch.Tensor, cos_: torch.Tensor, sin_: torch.Tensor
) -> torch.Tensor:
    """≙ fused_apply_rotary_pos_emb_cached: precomputed cos/sin tables
    broadcast against ``t``'s trailing ``(..., S, rot_dim)`` dims."""
    rot_dim = cos_.shape[-1]
    if rot_dim > t.shape[-1]:
        raise ValueError(f"rotary dim {rot_dim} exceeds head dim {t.shape[-1]}")
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    tf = t_rot.float()
    out = (tf * cos_.float() + rotate_half(tf) * sin_.float()).to(t.dtype)
    if t_pass.shape[-1] == 0:
        return out
    return torch.cat((out, t_pass), dim=-1)


def fused_apply_rotary_pos_emb(t: torch.Tensor,
                               freqs: torch.Tensor) -> torch.Tensor:
    """≙ fused_apply_rotary_pos_emb (non-cached): ``freqs`` in radians,
    e.g. ``(S, 1, 1, rot_dim)`` against ``t`` ``(S, B, H, D)``; the
    tables are ``cos(freqs)`` and ``sin(freqs)`` in f32.  The gradient
    flows to ``t`` only, as in the reference."""
    freqs = freqs.detach()
    return fused_apply_rotary_pos_emb_cached(t, torch.cos(freqs).float(),
                                             torch.sin(freqs).float())

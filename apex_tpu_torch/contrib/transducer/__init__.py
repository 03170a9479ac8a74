"""RNN-Transducer joint and loss — ≙ ``apex/contrib/transducer``
(``TransducerJoint``, ``TransducerLoss``); counterpart of
``apex_tpu/contrib/transducer``.

- :func:`transducer_joint` / :class:`TransducerJoint`: the broadcast add
  ``f (B, T, H) + g (B, U, H) -> (B, T, U, H)`` with an optional ReLU
  and dropout.  The dropout's bits come from a ``torch.Generator``, so
  they cannot equal the reference's threefry bits: the keep rate is
  ``1 - p`` and the kept values are scaled by ``1 / (1 - p)``.
- :func:`transducer_loss` / :class:`TransducerLoss`: the RNN-T negative
  log-likelihood.  Its method: a ``torch.autograd.Function`` that runs
  the log-domain alpha recursion forward and the beta recursion
  backward over the T + U anti-diagonals of the (T, U + 1) lattice (each
  diagonal one vectorized step across the batch, with no autograd
  graph), and forms the gradient of every blank and emit score from
  them, ``-exp(alpha + score + beta_next - log_likelihood)`` (≙ the
  alpha-beta backward of upstream's ``transducer_loss_kernel.cu``).
  A finite ``_NEG = -1e30`` stands in for -inf, so no ``logaddexp(-inf,
  -inf)`` appears; its exponentials underflow to exactly 0.

Layouts follow the reference: log-probs (B, T, U + 1, V) with
``blank_idx`` the blank class, labels (B, U), valid lengths f_len (B,)
and y_len (B,); the terminal is read at ``(f_len - 1, y_len)``.  The
math runs in f32, or f64 for f64 input.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "transducer_joint",
    "transducer_loss",
    "TransducerJoint",
    "TransducerLoss",
]

# finite stand-in for -inf (see the module docstring)
_NEG = -1e30


def transducer_joint(f: torch.Tensor, g: torch.Tensor, *, relu: bool = False,
                     dropout_p: float = 0.0,
                     dropout_rng: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """``f`` (B, T, H), ``g`` (B, U, H) -> (B, T, U, H), ``f + g``
    broadcast, then ReLU and dropout (drawn from ``dropout_rng``, a
    generator on the tensors' device)."""
    out = f[:, :, None, :] + g[:, None, :, :]
    if relu:
        out = F.relu(out)
    if dropout_p > 0.0:
        if dropout_rng is None:
            raise ValueError("dropout_p > 0 requires dropout_rng")
        keep = torch.rand(out.shape, generator=dropout_rng,
                          device=out.device) < 1.0 - dropout_p
        out = torch.where(keep, out / (1.0 - dropout_p),
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device))
    return out


def _skew_index(t_max: int, u_max: int, device):
    """(D, T) diagonal and column indices of the lattice: cell (t, u)
    lies on diagonal d = t + u at position t."""
    d = torch.arange(t_max + u_max, device=device)[:, None]
    t = torch.arange(t_max, device=device)[None, :]
    u = d - t
    return t.expand_as(u), u


def _skew(x: torch.Tensor, t, u, valid) -> torch.Tensor:
    """(B, T, W) -> (B, D, T) along the diagonals, _NEG off ``valid``."""
    w = x.shape[-1]
    return torch.where(valid, x[:, t, u.clamp(0, w - 1)], _NEG)


class _TransducerNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lp, labels, f_len, y_len, blank_idx):
        b, t_max, u1, v = lp.shape
        u_max = u1 - 1
        dev = lp.device
        blank = lp[..., blank_idx]  # (B, T, U + 1)
        lab = labels.long().clamp(0, v - 1)
        emit = lp[:, :, :u_max, :].gather(
            -1, lab[:, None, :, None].expand(b, t_max, u_max, 1))[..., 0]
        t, u = _skew_index(t_max, u1, dev)
        blank_s = _skew(blank, t, u, (u >= 0) & (u <= u_max))
        emit_s = _skew(emit, t, u, (u >= 0) & (u < u_max))
        n_diag = t.shape[0]

        # alpha, one diagonal at a time: (t-1, u) by a blank, (t, u-1)
        # by an emit, both on the previous diagonal
        valid = (u >= 0) & (u <= u_max)
        alpha = [torch.where(t[0] == 0, 0.0, _NEG).to(lp.dtype).expand(
            b, t_max)]
        for d in range(1, n_diag):
            prev = alpha[-1]
            by_blank = F.pad((prev + blank_s[:, d - 1])[:, :-1], (1, 0),
                             value=_NEG)
            by_emit = prev + emit_s[:, d - 1]
            alpha.append(torch.where(valid[d],
                                     torch.logaddexp(by_blank, by_emit),
                                     _NEG))
        alpha = torch.stack(alpha, dim=1)  # (B, D, T)

        tl = (f_len.long().to(dev) - 1).clamp(0, t_max - 1)
        ul = y_len.long().to(dev).clamp(0, u_max)
        rows = torch.arange(b, device=dev)
        ll = alpha[rows, tl + ul, tl] + blank_s[rows, tl + ul, tl]

        # beta backward from each element's terminal (tl, ul); cells past
        # it in t or u are _NEG
        term = ((t[None] == tl[:, None, None])
                & (u[None] == ul[:, None, None]))
        region = (valid[None] & (t[None] <= tl[:, None, None])
                  & (u[None] <= ul[:, None, None]))
        nxt = torch.full((b, t_max), _NEG, dtype=lp.dtype, device=dev)
        beta = [None] * n_diag
        for d in range(n_diag - 1, -1, -1):
            by_blank = F.pad(nxt[:, 1:], (0, 1), value=_NEG) + blank_s[:, d]
            by_emit = nxt + emit_s[:, d]
            cur = torch.where(term[:, d], blank_s[:, d],
                              torch.logaddexp(by_blank, by_emit))
            nxt = beta[d] = torch.where(region[:, d], cur, _NEG)
        beta = torch.stack(beta, dim=1)

        ctx.save_for_backward(lp, lab, alpha, beta, blank_s, emit_s, term,
                              ll)
        ctx.blank_idx = blank_idx
        return -ll

    @staticmethod
    def backward(ctx, grad):
        lp, lab, alpha, beta, blank_s, emit_s, term, ll = ctx.saved_tensors
        b, t_max, u1, v = lp.shape
        u_max = u1 - 1
        # beta of the successor on the next diagonal: (t, u + 1) at
        # position t, (t + 1, u) at position t + 1; the terminal blank
        # ends the path (beta 0 after it)
        after_emit = F.pad(beta[:, 1:], (0, 0, 0, 1), value=_NEG)
        after_blank = torch.where(
            term, 0.0, F.pad(after_emit[:, :, 1:], (0, 1), value=_NEG))
        scale = -grad.to(lp.dtype)[:, None, None]
        shift = ll[:, None, None]
        g_blank = scale * torch.exp(alpha + blank_s + after_blank - shift)
        g_emit = scale * torch.exp(alpha + emit_s + after_emit - shift)
        # back from the diagonals: cell (t, u) is (t + u, t)
        t = torch.arange(t_max, device=lp.device)[:, None]
        u = torch.arange(u1, device=lp.device)[None, :]
        g_blank = g_blank[:, t + u, t.expand(-1, u1)]  # (B, T, U + 1)
        g_emit = g_emit[:, t + u[:, :u_max], t.expand(-1, u_max)]
        grad_lp = torch.zeros_like(lp)
        grad_lp[..., ctx.blank_idx] += g_blank
        grad_lp[:, :, :u_max].scatter_add_(
            -1, lab[:, None, :, None].expand(b, t_max, u_max, 1),
            g_emit[..., None])
        return grad_lp, None, None, None, None


def _f32_or_wider(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def transducer_loss(log_probs: torch.Tensor, labels: torch.Tensor,
                    f_len: torch.Tensor, y_len: torch.Tensor,
                    blank_idx: int = 0) -> torch.Tensor:
    """RNN-T NLL per batch element (B,).  ``log_probs`` (B, T, U + 1, V)
    log-softmax scores, ``labels`` (B, U), ``f_len`` (B,) valid T,
    ``y_len`` (B,) valid U::

        alpha[0, 0] = 0
        alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                                alpha[t, u-1] + emit[t, u-1])
        loss = -(alpha[f_len-1, y_len] + blank[f_len-1, y_len])

    The gradient comes from the beta recursion (module docstring)."""
    return _TransducerNLL.apply(_f32_or_wider(log_probs), labels, f_len,
                                y_len, blank_idx)


class TransducerJoint(nn.Module):
    """≙ ``TransducerJoint(pack_output=False, relu=False, dropout=False,
    dropout_prob=0.0)``; ``forward(f, g, f_len=None, g_len=None,
    dropout_rng=None)``."""

    def __init__(self, pack_output: bool = False, relu: bool = False,
                 dropout: bool = False, dropout_prob: float = 0.0):
        super().__init__()
        if pack_output:
            raise NotImplementedError(
                "pack_output=True is not supported: the joint's output is "
                "padded (B, T, U, H), and the loss masks the padding by "
                "f_len and y_len")
        self.relu = relu
        self.dropout_prob = dropout_prob if dropout else 0.0

    def forward(self, f, g, f_len=None, g_len=None, dropout_rng=None):
        return transducer_joint(f, g, relu=self.relu,
                                dropout_p=self.dropout_prob,
                                dropout_rng=dropout_rng)


class TransducerLoss(nn.Module):
    """≙ ``TransducerLoss(fuse_softmax_backward=True, packed_input=False)``:
    takes raw logits and applies ``log_softmax`` (f32) first; autograd
    carries the gradient through it."""

    def __init__(self, fuse_softmax_backward: bool = True,
                 packed_input: bool = False):
        super().__init__()
        if packed_input:
            raise NotImplementedError(
                "packed_input=True is not supported: pass the padded "
                "(B, T, U + 1, V) logits with f_len and y_len")
        self.fuse_softmax_backward = fuse_softmax_backward

    def forward(self, x, label, f_len, y_len, blank_idx: int = 0):
        log_probs = F.log_softmax(_f32_or_wider(x), dim=-1)
        return transducer_loss(log_probs, label, f_len, y_len, blank_idx)

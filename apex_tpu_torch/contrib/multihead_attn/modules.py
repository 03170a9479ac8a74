"""Self and encoder-decoder fused multihead attention.

Counterpart of ``apex_tpu/contrib/multihead_attn/modules.py`` (≙
``apex/contrib/multihead_attn/self_multihead_attn.py`` ::
``SelfMultiheadAttn`` and ``encdec_multihead_attn.py`` ::
``EncdecMultiheadAttn``), in the reference's sequence-first ``(S, B,
E)`` layout.

The masks: ``key_padding_mask`` (B, Sk) is boolean, True = masked
(PyTorch's convention), mapped to ``MASK_VALUE``; with
``mask_additive=True`` it is already an additive float mask and passes
through.  An (Sq, Sk) ``attn_mask`` (boolean or additive) is added to
the (B, 1, 1, Sk) padding bias, giving (B, 1, Sq, Sk): one bias row
block a batch element, never expanded to B·H (``_format_bias`` keeps G =
B, RS = Sq).  Dropout draws its mask from the kernels' hash of an int32
seed: pass ``dropout_seed`` (or a ``generator`` to draw one) when the
module is in training mode with ``dropout`` > 0.

The projections are ``nn.Linear`` layers with f32 weights; ``dtype``
(the reference's flax ``Dense(dtype=...)``) is the dtype of their
products, by default the promotion of the input's and the weights'.
:func:`from_jax_params` / :func:`to_jax_params` carry a JAX module's
parameter tree across (a Flax ``Dense`` ``kernel`` (in, out) is the
``Linear`` ``weight`` (out, in)).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.attention import MASK_VALUE, flash_attention
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn", "from_jax_params",
           "to_jax_params"]


def _padding_bias(key_padding_mask, mask_additive: bool):
    """(B, Sk) mask -> (B, 1, 1, Sk) f32 additive bias: boolean with
    True = masked, or (``mask_additive``) already additive."""
    if key_padding_mask is None:
        return None
    if mask_additive:
        bias = key_padding_mask.to(torch.float32)
    else:
        bias = torch.where(key_padding_mask, MASK_VALUE, 0.0).to(
            torch.float32)
    return bias[:, None, None, :]


def _merge_attn_mask(bias, attn_mask):
    """Fold an (Sq, Sk) attention mask (boolean = masked, or additive
    float) into the running additive bias."""
    if attn_mask is None:
        return bias
    if attn_mask.dtype == torch.bool:
        am = torch.where(attn_mask, MASK_VALUE, 0.0).to(torch.float32)
    else:
        am = attn_mask.to(torch.float32)
    am = am.reshape((1, 1) + tuple(am.shape[-2:]))
    return am if bias is None else bias + am


class _Linear(nn.Linear):
    """``nn.Linear`` whose product runs in ``dtype`` (None: the
    promotion of the input's and the weight's dtypes)."""

    def __init__(self, fan_in, fan_out, bias, dtype, device, generator):
        super().__init__(fan_in, fan_out, bias=bias, device=device)
        self.compute_dtype = dtype
        with torch.no_grad():
            # lecun normal, as flax's Dense: N(0, 1/fan_in) cut at 2 std
            std = fan_in ** -0.5
            w = torch.empty(fan_out, fan_in)
            nn.init.trunc_normal_(w, std=std / 0.87962566103423978,
                                  a=-2 * std / 0.87962566103423978,
                                  b=2 * std / 0.87962566103423978,
                                  generator=generator)
            self.weight.copy_(w)
            if bias:
                self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class _Attn(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout, bias,
                 include_norm_add, mask_additive, impl, dtype, device,
                 generator):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        if impl not in ("fast", "default"):
            raise ValueError(f"impl must be 'fast' or 'default', got {impl!r}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.include_norm_add = include_norm_add
        self.mask_additive = mask_additive
        # both impls run the same path, as in the JAX package
        self.impl = impl
        self._dev = resolve_device(device)
        self._lin = dict(bias=bias, dtype=dtype, device=self._dev,
                         generator=generator)
        if include_norm_add:
            self.lyr_nrm_gamma_weights = nn.Parameter(
                torch.ones(embed_dim, device=self._dev))
            self.lyr_nrm_beta_weights = nn.Parameter(
                torch.zeros(embed_dim, device=self._dev))

    def _norm(self, query):
        if not self.include_norm_add:
            return query
        return fused_layer_norm_affine(query, self.lyr_nrm_gamma_weights,
                                       self.lyr_nrm_beta_weights,
                                       (self.embed_dim,))

    def _attend(self, q, k, v, key_padding_mask, attn_mask, causal,
                deterministic, generator, dropout_seed):
        """q (Sq, B, E), k and v (Sk, B, E) -> the output projection's
        input (Sq, B, E)."""
        sq, b, e = q.shape
        h = self.num_heads
        d = e // h

        def heads(t):
            return t.reshape(t.shape[0], b, h, d).permute(1, 2, 0, 3)

        bias = _merge_attn_mask(
            _padding_bias(key_padding_mask, self.mask_additive), attn_mask)
        if deterministic is None:
            deterministic = not self.training
        p = 0.0 if deterministic else self.dropout
        out = flash_attention(heads(q), heads(k), heads(v), bias,
                              causal=causal, scale=d ** -0.5, dropout_p=p,
                              generator=generator if p > 0 else None,
                              dropout_seed=dropout_seed if p > 0 else None)
        return out.permute(2, 0, 1, 3).reshape(sq, b, e)


class SelfMultiheadAttn(_Attn):
    """Fused self-attention: ``forward(query, key_padding_mask=None,
    attn_mask=None, *, causal=False, deterministic=None, generator=None,
    dropout_seed=None)`` with ``query`` (S, B, E) -> (S, B, E).
    ``deterministic=None`` drops nothing in ``eval()`` mode."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 mask_additive: bool = False, impl: str = "fast",
                 dtype=None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, mask_additive, impl, dtype,
                         device, generator)
        self.qkv_proj = _Linear(embed_dim, 3 * embed_dim, **self._lin)
        self.out_proj = _Linear(embed_dim, embed_dim, **self._lin)

    def forward(self, query, key_padding_mask=None, attn_mask=None, *,
                causal: bool = False, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                dropout_seed: Optional[torch.Tensor] = None):
        s, b, e = query.shape
        if e != self.embed_dim:
            raise ValueError(f"query width {e} != embed_dim {self.embed_dim}")
        qkv = self.qkv_proj(self._norm(query)).reshape(s, b, 3, e)
        out = self._attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           key_padding_mask, attn_mask, causal,
                           deterministic, generator, dropout_seed)
        out = self.out_proj(out)
        return out + query if self.include_norm_add else out


class EncdecMultiheadAttn(_Attn):
    """Fused encoder-decoder attention: Q projected from the decoder
    stream ``query`` (Sq, B, E), K and V by one fused projection from
    the encoder stream ``key`` (Sk, B, E).  ``forward(query, key,
    key_padding_mask=None, attn_mask=None, *, deterministic=None,
    generator=None, dropout_seed=None)`` -> (Sq, B, E)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 mask_additive: bool = False, impl: str = "fast",
                 dtype=None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, mask_additive, impl, dtype,
                         device, generator)
        self.q_proj = _Linear(embed_dim, embed_dim, **self._lin)
        self.kv_proj = _Linear(embed_dim, 2 * embed_dim, **self._lin)
        self.out_proj = _Linear(embed_dim, embed_dim, **self._lin)

    def forward(self, query, key, key_padding_mask=None, attn_mask=None, *,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                dropout_seed: Optional[torch.Tensor] = None):
        sq, b, e = query.shape
        if e != self.embed_dim:
            raise ValueError(f"query width {e} != embed_dim {self.embed_dim}")
        q = self.q_proj(self._norm(query))
        kv = self.kv_proj(key).reshape(key.shape[0], b, 2, e)
        out = self._attend(q, kv[:, :, 0], kv[:, :, 1], key_padding_mask,
                           attn_mask, False, deterministic, generator,
                           dropout_seed)
        out = self.out_proj(out)
        return out + query if self.include_norm_add else out


_PROJ = ("qkv_proj", "q_proj", "kv_proj", "out_proj")
_NORM = ("lyr_nrm_gamma_weights", "lyr_nrm_beta_weights")


def from_jax_params(module: _Attn, params_np: Mapping) -> _Attn:
    """Load a JAX module's ``params`` tree (numpy arrays, with or
    without the ``"params"`` level) into ``module``; returns it."""
    tree = params_np.get("params", params_np)
    with torch.no_grad():
        for name in _PROJ:
            if name not in tree:
                continue
            lin = getattr(module, name)
            lin.weight.copy_(torch.tensor(np.asarray(tree[name]["kernel"]).T))
            if lin.bias is not None:
                lin.bias.copy_(torch.tensor(np.asarray(tree[name]["bias"])))
        for name in _NORM:
            if name in tree:
                getattr(module, name).copy_(torch.tensor(
                    np.asarray(tree[name])))
    return module


def to_jax_params(module: _Attn, tensors: Optional[Mapping] = None) -> dict:
    """``module``'s parameters (or ``tensors``, e.g. their gradients,
    keyed by parameter name) in the JAX module's ``params`` layout, as
    f32 numpy arrays."""
    if tensors is None:
        tensors = dict(module.named_parameters())

    def arr(t):
        return t.detach().float().cpu().numpy()  # lint: allow(host-sync): export

    out = {}
    for name in _PROJ:
        if f"{name}.weight" in tensors:
            out[name] = {"kernel": arr(tensors[f"{name}.weight"]).T.copy()}
            if f"{name}.bias" in tensors:
                out[name]["bias"] = arr(tensors[f"{name}.bias"])
    for name in _NORM:
        if name in tensors:
            out[name] = arr(tensors[name])
    return out

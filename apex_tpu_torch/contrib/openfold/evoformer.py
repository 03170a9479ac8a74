"""The evoformer's modules (AlphaFold2 suppl. Algs 6-14), under dynamic
axial parallelism.

Counterpart of ``apex_tpu/contrib/openfold/evoformer.py`` with its module
and parameter names: every ``nn.Linear`` is named after the Flax
``Dense`` it replaces (its ``weight`` is the ``kernel`` transposed) and
each LayerNorm's parameters are the module-level ``<name>_scale`` and
``<name>_bias`` (:func:`apex_tpu_torch.models.convert.evoformer_from_jax_params`
carries a JAX tree across).  Flax infers each width from its input;
here every module takes its widths when it is built.

- Weights are f32 on ``device`` (default ``"cuda"``: entry points run on
  the card unless the caller asks for the CPU), drawn from ``generator``
  (a fresh one seeded with 0 when None) with the JAX module's rules:
  matmul weights N(0, 1/fan_in) (flax's lecun-normal scale), biases 0,
  LayerNorm scale 1 and bias 0; every gate kernel 0 with bias 1 and
  every ``out``/``down`` kernel 0, so each module's output is exactly
  zero at init, as the JAX module's is.
- Everything computes in f32, as the JAX module does, except that
  :class:`GatedAttention` casts q, k and v to its ``dtype`` (default
  bf16, the kernels' type: the counterpart of the JAX module under amp's
  attention cast, ``apex_tpu/ops/attention.py:277-279``).  The pair bias
  stays f32, as the kernels' bias operand is.
- LayerNorm is kernel K1/K2 (:func:`fused_layer_norm_affine`, eps 1e-6)
  and attention K3/K4, with the trainable pair bias's gradient
  (``flash_attention(..., bias_grad=True)``) written by K4's dQ pass
  (``flash_bwd_dbias``: the bias reaches the kernels at G = BH, RS = S)
  in bf16, and by K5's f32 instance with f32 attention.  The triangle and
  outer-product contractions are plain ``torch.einsum``, as the JAX
  package leaves them to XLA.
- ``axis_name`` names a ``parallel_state`` axis to run under dynamic
  axial parallelism (:mod:`apex_tpu_torch.contrib.openfold`'s
  collectives): the leading axial dim of the pair (and the MSA's row
  dim) is sharded over its ranks, rank r holding rows ``[r*per,
  (r+1)*per)``; None runs the same math unsharded.  Parameters stay
  replicated over the group; their local gradients are partial sums the
  caller all-reduces.  The trainable pair bias still reaches the
  kernels at G = BH, RS = S, so in bf16 K4's dQ pass writes each rank's
  share of its gradient and :func:`gather`'s backward sums the shares.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine

__all__ = [
    "GatedAttention",
    "TriangleAttention",
    "TriangleMultiplicativeUpdate",
    "PairTransition",
    "EvoformerPairBlock",
    "MSARowAttentionWithPairBias",
    "MSAColumnAttention",
    "OuterProductMean",
    "EvoformerBlock",
]


def _dap():
    from apex_tpu_torch.contrib import openfold

    return openfold


def _setup(device, generator):
    """(device, generator) of a module: the device resolved (the card by
    default), the generator a fresh one seeded with 0 when None."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return dev, generator


@torch.no_grad()
def _dense(d_in: int, d_out: int, dev, generator, *, bias: bool = True,
           init: str = "lecun") -> nn.Linear:
    """An f32 ``nn.Linear`` with a Flax ``Dense`` init: ``"lecun"`` draws
    N(0, 1/d_in), ``"zeros"`` a zero weight, ``"gate"`` a zero weight and
    a bias of 1; the bias is 0 otherwise."""
    lin = nn.Linear(d_in, d_out, bias=bias, device=dev, dtype=torch.float32)
    if init == "lecun":
        draw = torch.randn(lin.weight.shape, generator=generator,
                           dtype=torch.float32, device=generator.device)
        lin.weight.copy_(draw * d_in ** -0.5)
    else:
        lin.weight.zero_()
    if bias:
        lin.bias.fill_(1.0 if init == "gate" else 0.0)
    return lin


def _add_layer_norm(mod: nn.Module, name: str, dim: int, dev) -> None:
    mod.register_parameter(name + "_scale", nn.Parameter(
        torch.ones(dim, dtype=torch.float32, device=dev)))
    mod.register_parameter(name + "_bias", nn.Parameter(
        torch.zeros(dim, dtype=torch.float32, device=dev)))


def _layer_norm(mod: nn.Module, x, name: str):
    d = x.shape[-1]
    return fused_layer_norm_affine(x, getattr(mod, name + "_scale"),
                                   getattr(mod, name + "_bias"), (d,))


def _pair_bias(proj: nn.Linear, z_ln, n_res: int, axis_name=None):
    """Per-head attention bias projected from the (LN'd) pair rep:
    (1, H, N, N), one bias group shared by every batch row and trainable
    (K5's function).  Under DAP the projection runs on the local rows
    and the small (N/dap, N, H) result is all-gathered.  The attention materialises it at G = B·H (a
    head-dependent bias, as in the JAX package), so the kernel (in bf16
    K4's dQ pass, ``flash_bwd_dbias``) differentiates each batch row's copy and the sum over the batch is the backward of
    that broadcast in :func:`flash_attention`, outside the kernel — not
    the kernel's grouped-G reduction that the JAX docstring names."""
    tri = proj(z_ln)
    if axis_name is not None:
        tri = _dap().gather(tri, axis_name, 0)
    if tri.shape[0] != n_res or tri.shape[1] != n_res:
        raise ValueError(
            f"pair bias needs a square pair representation matching the "
            f"attended dim {n_res}; got {tuple(tri.shape[:2])}"
        )
    return tri.permute(2, 0, 1)[None]


class GatedAttention(nn.Module):
    """OpenFold-style attention: no-bias q/k/v projections, additive pair
    bias, sigmoid gating on the attended values, output projection.
    ``x`` (B, S, dim); optional ``bias`` broadcastable to (B, H, S, S),
    trainable when ``bias_grad``.  q, k and v go to the kernels in
    ``dtype``; the attended values come back to f32."""

    def __init__(self, dim: int, heads: int, *, bias_grad: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        dev, gen = _setup(device, generator)
        self.heads, self.bias_grad, self.dtype = heads, bias_grad, dtype
        self.q = _dense(dim, dim, dev, gen, bias=False)
        self.k = _dense(dim, dim, dev, gen, bias=False)
        self.v = _dense(dim, dim, dev, gen, bias=False)
        self.gate = _dense(dim, dim, dev, gen, init="gate")
        self.out = _dense(dim, dim, dev, gen, init="zeros")

    def forward(self, x, bias=None):
        b, s, d = x.shape
        h = self.heads

        def split_heads(t):
            return t.reshape(b, s, h, d // h).transpose(1, 2).to(self.dtype)

        o = flash_attention(split_heads(self.q(x)), split_heads(self.k(x)),
                            split_heads(self.v(x)), bias,
                            bias_grad=self.bias_grad)
        o = o.float().transpose(1, 2).reshape(b, s, d)
        return self.out(torch.sigmoid(self.gate(x)) * o)


class TriangleAttention(nn.Module):
    """Triangle self-attention around the starting node (AF2 suppl. Algs
    13/14): batch = the leading axial dim, attention along the second,
    bias ``b[h, j, k]`` projected from the pair itself.  The ending-node
    variant is this module on the transposed pair
    (:class:`EvoformerPairBlock` wires it)."""

    def __init__(self, dim: int, heads: int, axis_name=None, *,
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        self.axis_name = axis_name
        _add_layer_norm(self, "ln", dim, dev)
        self.tri_bias = _dense(dim, heads, dev, gen, bias=False)
        self.attn = GatedAttention(dim, heads, dtype=dtype, device=dev,
                                   generator=gen)

    def forward(self, z):
        z_ln = _layer_norm(self, z, "ln")
        return self.attn(z_ln, bias=_pair_bias(self.tri_bias, z_ln,
                                               z.shape[1], self.axis_name))


class TriangleMultiplicativeUpdate(nn.Module):
    """Triangle multiplicative update (AF2 suppl. Algs 11/12):
    ``outgoing`` out[i,j] = Σ_k a[i,k]·b[j,k], ``incoming`` out[i,j] =
    Σ_k a[k,i]·b[k,j], with a, b gated projections of the LN'd pair to
    ``hidden`` channels (default ``dim``) and a gated, LN'd output
    projection.  Under DAP ``outgoing`` all-gathers b and ``incoming``
    reduce-scatters its partial contraction."""

    def __init__(self, dim: int, mode: str, hidden: Optional[int] = None,
                 axis_name=None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ("outgoing", "incoming"):
            raise ValueError(f"unknown mode {mode!r}")
        dev, gen = _setup(device, generator)
        c = hidden or dim
        self.mode, self.axis_name = mode, axis_name
        _add_layer_norm(self, "ln_in", dim, dev)
        self.a = _dense(dim, c, dev, gen)
        self.a_gate = _dense(dim, c, dev, gen, init="gate")
        self.b = _dense(dim, c, dev, gen)
        self.b_gate = _dense(dim, c, dev, gen, init="gate")
        _add_layer_norm(self, "ln_out", c, dev)
        self.out = _dense(c, dim, dev, gen, init="zeros")
        self.gate = _dense(dim, dim, dev, gen, init="gate")

    def forward(self, z):
        z_ln = _layer_norm(self, z, "ln_in")
        a = torch.sigmoid(self.a_gate(z_ln)) * self.a(z_ln)
        b = torch.sigmoid(self.b_gate(z_ln)) * self.b(z_ln)
        ax = self.axis_name
        if self.mode == "outgoing":
            if ax is not None:
                b = _dap().gather(b, ax, 0)
            x = torch.einsum("ikc,jkc->ijc", a, b)
        else:
            x = torch.einsum("kic,kjc->ijc", a, b)
            if ax is not None:
                x = _dap().psum_scatter(x, ax, 0)
        x = self.out(_layer_norm(self, x, "ln_out"))
        return torch.sigmoid(self.gate(z_ln)) * x


class PairTransition(nn.Module):
    """Per-position transition MLP (LN → expand ``ratio``× → relu →
    project)."""

    def __init__(self, dim: int, ratio: int = 4, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        _add_layer_norm(self, "ln", dim, dev)
        self.up = _dense(dim, ratio * dim, dev, gen)
        self.down = _dense(ratio * dim, dim, dev, gen, init="zeros")

    def forward(self, z):
        return self.down(torch.relu(self.up(_layer_norm(self, z, "ln"))))


class EvoformerPairBlock(nn.Module):
    """One pair-stack block on the square pair z (N, N, dim): triangle
    multiplicative outgoing, incoming, triangle attention around the
    starting then the ending node (in the transposed frame), pair
    transition — each a residual update.  Under DAP the block stays
    row-sharded but for the ending-node attention, which runs in the
    transposed frame between :func:`row_to_col` and :func:`col_to_row`."""

    def __init__(self, dim: int, heads: int, axis_name=None,
                 mlp_ratio: int = 4, *, dtype: torch.dtype = torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        self.dim, self.axis_name = dim, axis_name
        kw = dict(device=dev, generator=gen)
        ax = axis_name
        self.tri_mul_out = TriangleMultiplicativeUpdate(
            dim, "outgoing", axis_name=ax, **kw)
        self.tri_mul_in = TriangleMultiplicativeUpdate(
            dim, "incoming", axis_name=ax, **kw)
        self.tri_att_start = TriangleAttention(dim, heads, ax, dtype=dtype,
                                               **kw)
        self.tri_att_end = TriangleAttention(dim, heads, ax, dtype=dtype,
                                             **kw)
        self.transition = PairTransition(dim, mlp_ratio, **kw)

    def forward(self, z):
        if z.shape[-1] != self.dim:
            raise ValueError(
                f"pair channel dim {z.shape[-1]} != configured dim {self.dim}")
        z = z + self.tri_mul_out(z)
        z = z + self.tri_mul_in(z)
        z = z + self.tri_att_start(z)
        ax = self.axis_name
        zc = _dap().row_to_col(z, ax) if ax is not None else z
        zt = zc.transpose(0, 1)
        zt = zt + self.tri_att_end(zt)
        zc = zt.transpose(0, 1)
        z = _dap().col_to_row(zc, ax) if ax is not None else zc
        return z + self.transition(z)


class MSARowAttentionWithPairBias(nn.Module):
    """MSA row-wise gated self-attention biased by the pair rep (AF2
    suppl. Alg 7): each MSA row m (S, R, msa_dim) attends across residues
    with a per-head bias projected from LN(z) (R, R, pair_dim), shared by
    every row and trainable through K5."""

    def __init__(self, msa_dim: int, pair_dim: int, heads: int,
                 axis_name=None, *, dtype: torch.dtype = torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        self.axis_name = axis_name
        _add_layer_norm(self, "ln_m", msa_dim, dev)
        _add_layer_norm(self, "ln_z", pair_dim, dev)
        self.pair_bias = _dense(pair_dim, heads, dev, gen, bias=False)
        self.attn = GatedAttention(msa_dim, heads, dtype=dtype, device=dev,
                                   generator=gen)

    def forward(self, m, z):
        m_ln = _layer_norm(self, m, "ln_m")
        z_ln = _layer_norm(self, z, "ln_z")
        return self.attn(m_ln, bias=_pair_bias(self.pair_bias, z_ln,
                                               m.shape[1], self.axis_name))


class MSAColumnAttention(nn.Module):
    """MSA column-wise gated self-attention (AF2 suppl. Alg 8) on the
    column-major layout (R, S, dim): per residue, attend over the MSA's
    sequences.  No bias."""

    def __init__(self, dim: int, heads: int, *,
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        _add_layer_norm(self, "ln", dim, dev)
        self.attn = GatedAttention(dim, heads, dtype=dtype, device=dev,
                                   generator=gen)

    def forward(self, m_col):
        return self.attn(_layer_norm(self, m_col, "ln"))


class OuterProductMean(nn.Module):
    """Pair update from the MSA (AF2 suppl. Alg 10): o[i,j] =
    Linear(flatten(mean_s a[s,i] ⊗ b[s,j])), a and b projections of
    LN(m) to ``hidden`` channels, the output ``out_dim`` wide.  (The JAX
    module takes ``out_dim`` at call time.)  Under DAP the mean contracts
    the sharded MSA rows locally and one reduce-scatter finishes the sum
    and lands the pair rows on their owners."""

    def __init__(self, msa_dim: int, out_dim: int, hidden: int = 8,
                 axis_name=None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        self.hidden, self.axis_name = hidden, axis_name
        _add_layer_norm(self, "ln", msa_dim, dev)
        self.a = _dense(msa_dim, hidden, dev, gen)
        self.b = _dense(msa_dim, hidden, dev, gen)
        self.out = _dense(hidden * hidden, out_dim, dev, gen, init="zeros")

    def forward(self, m):
        ax = self.axis_name
        # the mean divides by the GLOBAL row count (equal shards)
        s_total = m.shape[0] * (ps.axis_size(ax) if ax is not None else 1)
        m_ln = _layer_norm(self, m, "ln")
        o = torch.einsum("sic,sjd->ijcd", self.a(m_ln),
                         self.b(m_ln)) / s_total
        if ax is not None:
            o = _dap().psum_scatter(o, ax, 0)
        return self.out(o.reshape(o.shape[0], o.shape[1],
                                  self.hidden * self.hidden))


class EvoformerBlock(nn.Module):
    """One evoformer block (AF2 suppl. Alg 6): the MSA stack (row
    attention with pair bias, column attention, transition), the
    outer-product-mean MSA→pair communication, then the pair stack
    (:class:`EvoformerPairBlock`).  m (N_seq, N_res, msa_dim) and z
    (N_res, N_res, pair_dim) in, the updated pair ``(m, z)`` out; under
    DAP m (N_seq/dap, N_res, msa_dim) and z (N_res/dap, N_res, pair_dim),
    each sharded on its leading dim, and every cross-layout move one
    collective."""

    def __init__(self, msa_dim: int, pair_dim: int, heads: int,
                 axis_name=None, mlp_ratio: int = 4, opm_hidden: int = 8, *,
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        self.msa_dim, self.pair_dim = msa_dim, pair_dim
        self.axis_name = axis_name
        kw = dict(device=dev, generator=gen)
        self.msa_row_att = MSARowAttentionWithPairBias(
            msa_dim, pair_dim, heads, axis_name, dtype=dtype, **kw)
        self.msa_col_att = MSAColumnAttention(msa_dim, heads, dtype=dtype,
                                              **kw)
        self.msa_transition = PairTransition(msa_dim, mlp_ratio, **kw)
        self.outer_product_mean = OuterProductMean(msa_dim, pair_dim,
                                                   opm_hidden, axis_name,
                                                   **kw)
        self.pair_block = EvoformerPairBlock(pair_dim, heads, axis_name,
                                             mlp_ratio=mlp_ratio,
                                             dtype=dtype, **kw)

    def forward(self, m, z):
        if m.shape[-1] != self.msa_dim:
            raise ValueError(
                f"MSA channel dim {m.shape[-1]} != configured {self.msa_dim}")
        if z.shape[-1] != self.pair_dim:
            raise ValueError(
                f"pair channel dim {z.shape[-1]} != configured "
                f"{self.pair_dim}")
        ax = self.axis_name
        m = m + self.msa_row_att(m, z)
        mc = _dap().row_to_col(m, ax) if ax is not None else m
        mt = mc.transpose(0, 1)  # (N_res, N_seq, msa_dim)
        mt = mt + self.msa_col_att(mt)
        mc = mt.transpose(0, 1)
        m = _dap().col_to_row(mc, ax) if ax is not None else mc
        m = m + self.msa_transition(m)
        z = z + self.outer_product_mean(m)
        return m, self.pair_block(z)

"""OpenFold kernels, modules and dynamic axial parallelism — counterpart of
:mod:`apex_tpu.contrib.openfold`.

``mha`` is :func:`flash_attention` (K3/K4, K5's function for a trainable
bias: in bf16 at G = BH the epilogue of K4's dQ pass) and
``layer_norm`` :func:`fused_layer_norm_affine` (K1/K2), under the names
OpenFold-shaped code looks for.

Dynamic axial parallelism (DAP) shards the pair representation's
leading axial dim over the ranks of a ``parallel_state`` axis
(``axis_name``, e.g. ``"dp"``): rank r holds rows ``[r*per,
(r+1)*per)``.  The collectives below are ``torch.autograd.Function``s
over that axis's process group, each issued through
:mod:`apex_tpu_torch.parallel.comm`'s wrappers (so the call log sees
it), with the backward JAX's transpose gives:

- :func:`gather` (``all_gather``, tiled) — backward a reduce-scatter
  (sum): every rank's cotangent for the gathered rows is summed into
  the rows' owner;
- :func:`psum_scatter` (``psum_scatter``, tiled) — backward an
  all-gather;
- :func:`row_to_col` / :func:`col_to_row` (the tiled all-to-all of
  ``scatter_rows_gather_cols`` / ``scatter_cols_gather_rows``) —
  backward the inverse all-to-all;
- :func:`scatter` (this rank's slice, ``dynamic_slice`` by the axis
  index) — backward zero-padded, no collective.

An axis of size 1 has no group: every collective is the identity and
issues nothing.  Parameters stay replicated over the DAP group; their
local gradients are partial sums the caller all-reduces over it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.parallel import comm

__all__ = [
    "mha",
    "layer_norm",
    "scatter",
    "gather",
    "psum_scatter",
    "row_to_col",
    "col_to_row",
    "scatter_rows_gather_cols",
    "scatter_cols_gather_rows",
    "DAPAxialBlock",
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


def _gather_rows(x: torch.Tensor, group, world: int, dim: int):
    """The members' ``x`` concatenated along ``dim`` in rank order."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((world * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    comm.all_gather_into(out, xt, group)
    return out.movedim(0, dim)


def _scatter_sum(x: torch.Tensor, group, world: int, dim: int):
    """This rank's block along ``dim`` of the members' summed ``x``."""
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % world:
        raise ValueError(
            f"DAP reduce-scatter: dim {dim} (size {xt.shape[0]}) is not "
            f"divisible by the axis size {world}")
    out = torch.empty((xt.shape[0] // world,) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    comm.reduce_scatter_into(out, xt, group)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim):
        ctx.axis_name, ctx.dim = axis_name, dim
        return _gather_rows(x, ps.get_group(axis_name),
                            ps.axis_size(axis_name), dim)

    @staticmethod
    def backward(ctx, g):
        return (_scatter_sum(g, ps.get_group(ctx.axis_name),
                             ps.axis_size(ctx.axis_name), ctx.dim),
                None, None)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim):
        ctx.axis_name, ctx.dim = axis_name, dim
        return _scatter_sum(x, ps.get_group(axis_name),
                            ps.axis_size(axis_name), dim)

    @staticmethod
    def backward(ctx, g):
        return (_gather_rows(g, ps.get_group(ctx.axis_name),
                             ps.axis_size(ctx.axis_name), ctx.dim),
                None, None)


def _sharded(axis_name: str) -> bool:
    return ps.axis_size(axis_name) > 1


def gather(x, axis_name: str, dim: int):
    """Leave the DAP region: all-gather ``dim`` over ``axis_name``
    (backward: reduce-scatter, summing every rank's cotangent)."""
    if not _sharded(axis_name):
        return x
    return _Gather.apply(x, axis_name, dim % x.ndim)


def psum_scatter(x, axis_name: str, dim: int = 0):
    """Sum ``x`` over ``axis_name`` and keep this rank's block of
    ``dim`` (backward: all-gather)."""
    if not _sharded(axis_name):
        return x
    return _PsumScatter.apply(x, axis_name, dim % x.ndim)


def scatter_rows_gather_cols(x, axis_name: str, row_axis: int = -3,
                             col_axis: int = -2):
    """DAP transition: rows sharded -> columns sharded (one all-to-all;
    backward the inverse one)."""
    if not _sharded(axis_name):
        return x
    return comm.all_to_all(x, axis_name, col_axis, row_axis)


def scatter_cols_gather_rows(x, axis_name: str, row_axis: int = -3,
                             col_axis: int = -2):
    """Inverse DAP transition: columns sharded -> rows sharded."""
    if not _sharded(axis_name):
        return x
    return comm.all_to_all(x, axis_name, row_axis, col_axis)


# the reference surface's names; "row-sharded" = the R axial dim is split
row_to_col = scatter_rows_gather_cols
col_to_row = scatter_cols_gather_rows


def scatter(x, axis_name: str, dim: int):
    """Enter the DAP region: this rank's slice of ``dim`` of a replicated
    tensor (backward: the cotangent zero-padded back, no collective)."""
    n = ps.axis_size(axis_name)
    dim = dim % x.ndim
    if x.shape[dim] % n:
        raise ValueError(
            f"DAP scatter: dim {dim} (size {x.shape[dim]}) is not "
            f"divisible by the {axis_name!r} axis size {n} — trailing "
            "rows would silently belong to no rank; pad the axial dim"
        )
    per = x.shape[dim] // n
    return x.narrow(dim, ps.axis_rank(axis_name) * per, per)


from apex_tpu_torch.contrib.openfold.evoformer import (  # noqa: E402
    EvoformerBlock,
    EvoformerPairBlock,
    GatedAttention,
    MSAColumnAttention,
    MSARowAttentionWithPairBias,
    OuterProductMean,
    PairTransition,
    TriangleAttention,
    TriangleMultiplicativeUpdate,
    _add_layer_norm,
    _dense,
    _layer_norm,
    _setup,
)
from apex_tpu_torch.ops.attention import flash_attention as mha  # noqa: E402
from apex_tpu_torch.ops.layer_norm import (  # noqa: E402
    fused_layer_norm_affine as layer_norm,
)


class DAPAxialBlock(nn.Module):
    """One pair-stack block of the DAP pattern: row-wise self-attention
    while rows are sharded, :func:`row_to_col`, column-wise
    self-attention while columns are sharded, :func:`col_to_row`, then a
    per-position GELU MLP, pre-LN residual form.  x is (R/dap, C, dim)
    under ``axis_name``, (R, C, dim) with None.  The attention is
    K3/K4 without a bias; q, k and v go to it in ``dtype`` (bf16 by
    default, the kernels' type) and everything else is f32.  Parameter
    names are the JAX module's (``row_qkv``, ``row_out``, ``col_qkv``,
    ``col_out``, ``mlp_up``, ``mlp_down``, ``ln_row``/``ln_col``/``ln_mlp``
    ``_scale``/``_bias``)."""

    def __init__(self, dim: int, heads: int, axis_name=None,
                 mlp_ratio: int = 4, *, dtype: torch.dtype = torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.axis_name = axis_name
        for name in ("row", "col"):
            _add_layer_norm(self, f"ln_{name}", dim, dev)
            setattr(self, f"{name}_qkv",
                    _dense(dim, 3 * dim, dev, gen, bias=False))
            setattr(self, f"{name}_out", _dense(dim, dim, dev, gen))
        _add_layer_norm(self, "ln_mlp", dim, dev)
        self.mlp_up = _dense(dim, mlp_ratio * dim, dev, gen)
        self.mlp_down = _dense(mlp_ratio * dim, dim, dev, gen)

    def _attend(self, x, prefix):
        """Self-attention of x (B, S, dim) over S."""
        b, s, d = x.shape
        q, k, v = getattr(self, f"{prefix}_qkv")(x).chunk(3, dim=-1)

        def heads_first(t):
            return t.reshape(b, s, self.heads, d // self.heads).transpose(
                1, 2).to(self.dtype)

        o = mha(heads_first(q), heads_first(k), heads_first(v))
        o = o.float().transpose(1, 2).reshape(b, s, d)
        return getattr(self, f"{prefix}_out")(o)

    def forward(self, x):
        ax = self.axis_name
        x = x + self._attend(_layer_norm(self, x, "ln_row"), "row")
        if ax is not None:
            x = row_to_col(x, ax)
        h = _layer_norm(self, x, "ln_col").transpose(0, 1)
        x = x + self._attend(h, "col").transpose(0, 1)
        if ax is not None:
            x = col_to_row(x, ax)
        h = self.mlp_up(_layer_norm(self, x, "ln_mlp"))
        return x + self.mlp_down(F.gelu(h, approximate="tanh"))

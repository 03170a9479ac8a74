"""OpenFold kernels and modules — counterpart of
:mod:`apex_tpu.contrib.openfold`.

``mha`` is :func:`flash_attention` (K3/K4, K5's function for a trainable
bias: in bf16 at G = BH the epilogue of K4's dQ pass) and
``layer_norm`` :func:`fused_layer_norm_affine` (K1/K2), under the names
OpenFold-shaped code looks for.  :class:`DAPAxialBlock` and the evoformer
modules run unsharded (``axis_name=None``).  Dynamic axial parallelism —
sharding the pair representation's axial dims across cards and swapping
which one is sharded — needs several cards and ``torch.distributed``:
its collectives (``scatter``, ``gather``, ``row_to_col``, ``col_to_row``
and the all-to-all transitions) and any ``axis_name`` but None raise
(ROADMAP item 5).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.contrib.openfold.evoformer import (
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
    _no_dap,
    _setup,
)
from apex_tpu_torch.ops.attention import flash_attention as mha
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine as layer_norm

__all__ = [
    "mha",
    "layer_norm",
    "scatter",
    "gather",
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


def _dap_collective(name):
    def collective(*args, **kwargs):
        _no_dap(name)

    collective.__name__ = collective.__qualname__ = name
    collective.__doc__ = (f"DAP's ``{name}`` (a collective over several "
                          f"cards): not ported yet, raises (ROADMAP item 5).")
    return collective


scatter_rows_gather_cols = _dap_collective("scatter_rows_gather_cols")
scatter_cols_gather_rows = _dap_collective("scatter_cols_gather_rows")
row_to_col = _dap_collective("row_to_col")
col_to_row = _dap_collective("col_to_row")
scatter = _dap_collective("scatter")
gather = _dap_collective("gather")


class DAPAxialBlock(nn.Module):
    """One pair-stack block of the DAP pattern, unsharded: row-wise
    self-attention, column-wise self-attention, then a per-position
    GELU MLP, pre-LN residual form, on x (R, C, dim).  The attention is
    K3/K4 without a bias; q, k and v go to it in ``dtype`` (bf16 by
    default, the kernels' type) and everything else is f32.  Parameter
    names are the JAX module's (``row_qkv``, ``row_out``, ``col_qkv``,
    ``col_out``, ``mlp_up``, ``mlp_down``, ``ln_row``/``ln_col``/``ln_mlp``
    ``_scale``/``_bias``)."""

    def __init__(self, dim: int, heads: int, axis_name=None,
                 mlp_ratio: int = 4, *, dtype: torch.dtype = torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        _no_dap(axis_name)
        dev, gen = _setup(device, generator)
        self.dim, self.heads, self.dtype = dim, heads, dtype
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
        x = x + self._attend(_layer_norm(self, x, "ln_row"), "row")
        h = _layer_norm(self, x, "ln_col").transpose(0, 1)
        x = x + self._attend(h, "col").transpose(0, 1)
        h = self.mlp_up(_layer_norm(self, x, "ln_mlp"))
        return x + self.mlp_down(F.gelu(h, approximate="tanh"))

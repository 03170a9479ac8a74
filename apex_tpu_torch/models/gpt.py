"""GPT — configuration and weights of the Megatron-style pre-LN decoder.

Counterpart of ``apex_tpu/models/gpt.py``.  :class:`GptConfig` keeps
the JAX dataclass's fields and defaults (with a torch dtype).
:class:`GptModel` holds the weights under the flax tree's names —
``word_embeddings``, per-layer ``ln_attn``, ``qkv``, ``out``, ``ln_mlp``,
``fc1``, ``fc2``, then ``ln_f`` (plus ``position_embeddings`` when
``rotary=False``) — one :class:`GptBlock` per layer where the JAX stack
scans one block with a leading layer axis.

Storage follows the JAX compute-dtype discipline: the matmul and
embedding weights are stored in ``cfg.dtype`` (the JAX step casts its
f32 parameters to that dtype at every use, so storing them cast gives
the same numbers in half the memory); the LayerNorm affines stay f32,
as the JAX LayerNorm reads them.  ``nn.Linear`` keeps PyTorch's
``(out, in)`` weight layout; :mod:`.convert` is the one place that
transposes flax's ``(in, out)`` kernels.

The forward lives in :mod:`apex_tpu_torch.serve.model` (prefill and
decode); the training forward comes with the training slice.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["GptConfig", "GptBlock", "GptModel", "LayerNorm", "rope_cos_sin"]


@functools.lru_cache(maxsize=16)
def _rope_table(seq_len: int, dim: int, base: float, device: str):
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freqs = torch.outer(torch.arange(seq_len, dtype=torch.float32), inv)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos().to(device), emb.sin().to(device)


def rope_cos_sin(seq_len: int, dim: int, base: float = 10000.0,
                 device="cpu"):
    """Cos/sin tables (S, D) f32 in the rotate_half layout
    (``_rope_cos_sin`` of the JAX package).  Computed on the CPU and
    copied, so every device sees the same table; cached per device (the
    tables are read-only)."""
    return _rope_table(seq_len, dim, float(base), str(torch.device(device)))


@dataclasses.dataclass(frozen=True)
class GptConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 12
    num_heads: int = 16
    intermediate_size: int = 4096
    max_seq_len: int = 2048
    layer_norm_eps: float = 1e-5
    rotary: bool = True
    dtype: torch.dtype = torch.bfloat16
    sequence_parallel: bool = False
    context_parallel: Optional[str] = None
    remat: bool = False
    remat_policy: str = "full"
    num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    def __post_init__(self):
        if self.context_parallel not in (None, "ring", "ring_zigzag",
                                         "ulysses"):
            raise ValueError(
                f"context_parallel must be None, 'ring', 'ring_zigzag' "
                f"or 'ulysses', got {self.context_parallel!r}"
            )
        if self.context_parallel and self.sequence_parallel:
            raise ValueError(
                "context_parallel and sequence_parallel are mutually "
                "exclusive: both shard the sequence dimension"
            )
        if self.remat_policy not in ("full", "dots", "sums"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r} "
                "(expected 'full', 'dots' or 'sums')"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class LayerNorm(nn.Module):
    """LayerNorm affine parameters under the flax names ``scale`` and
    ``bias`` (f32)."""

    def __init__(self, size: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(
            torch.ones(size, dtype=torch.float32, device=device)
        )
        self.bias = nn.Parameter(
            torch.zeros(size, dtype=torch.float32, device=device)
        )


def _linear(n_in: int, n_out: int, dtype, device) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=True, dtype=dtype, device=device)


class GptBlock(nn.Module):
    """One pre-LN decoder block's weights: x + attn(LN(x)); x + mlp(LN(x)).
    The fused ``qkv`` output columns are ordered ``(heads, 3, head_dim)``
    as in the JAX block."""

    def __init__(self, cfg: GptConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.ln_attn = LayerNorm(h, device)
        self.qkv = _linear(h, 3 * h, cfg.dtype, device)
        self.out = _linear(h, h, cfg.dtype, device)
        self.ln_mlp = LayerNorm(h, device)
        self.fc1 = _linear(h, cfg.intermediate_size, cfg.dtype, device)
        self.fc2 = _linear(cfg.intermediate_size, h, cfg.dtype, device)


class GptModel(nn.Module):
    """Embedding + ``num_layers`` blocks + final LN, on ``device`` (the
    card by default; ``device="cpu"`` for the plain versions).

    The weights are drawn from ``generator`` (a fresh one seeded with 0
    when None): embeddings N(0, 0.02), matmul weights N(0, 1/fan_in)
    (flax's lecun-normal scale), biases 0, LayerNorm scale 1 and bias 0.
    """

    def __init__(self, cfg: GptConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.sequence_parallel or cfg.context_parallel or cfg.num_experts:
            raise NotImplementedError(
                "the port's GptModel is the dense single-shard stack"
            )
        dev = resolve_device(device)
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype, device=dev
        )
        if not cfg.rotary:
            self.position_embeddings = nn.Parameter(torch.empty(
                cfg.max_seq_len, cfg.hidden_size, dtype=cfg.dtype,
                device=dev,
            ))
        self.layers = nn.ModuleList(
            GptBlock(cfg, dev) for _ in range(cfg.num_layers)
        )
        self.ln_f = LayerNorm(cfg.hidden_size, dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.ln_f.scale.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init, drawn on the generator's device in f32 and cast
        into each parameter."""
        def normal_(param, std):
            draw = torch.randn(
                param.shape, generator=generator, dtype=torch.float32,
                device=generator.device,
            )
            param.copy_(draw * std)

        normal_(self.word_embeddings.weight, 0.02)
        if not self.cfg.rotary:
            normal_(self.position_embeddings, 0.02)
        for blk in self.layers:
            for lin in (blk.qkv, blk.out, blk.fc1, blk.fc2):
                normal_(lin.weight, lin.in_features ** -0.5)
                lin.bias.zero_()
            for ln in (blk.ln_attn, blk.ln_mlp):
                ln.scale.fill_(1.0)
                ln.bias.zero_()
        self.ln_f.scale.fill_(1.0)
        self.ln_f.bias.zero_()

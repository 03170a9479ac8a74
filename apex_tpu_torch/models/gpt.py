"""GPT — the Megatron-style pre-LN decoder, its forward and its LM loss.

Counterpart of ``apex_tpu/models/gpt.py``.  :class:`GptConfig` keeps
the JAX dataclass's fields and defaults (with a torch dtype).
:class:`GptModel` holds the weights under the flax tree's names —
``word_embeddings``, per-layer ``ln_attn``, ``qkv``, ``out``, ``ln_mlp``,
``fc1``, ``fc2``, then ``ln_f`` (plus ``position_embeddings`` when
``rotary=False``) — one :class:`GptBlock` per layer where the JAX stack
scans one block with a leading layer axis.

Every parameter is stored in f32, as in the JAX tree, and cast to
``cfg.dtype`` where the JAX layers cast it (``layers.py``): each matmul
runs on ``cfg.dtype`` operands with f32 accumulation and its result is
cast back before the bias is added in ``cfg.dtype``; the embedding
lookup is taken on the f32 table and cast, so its gradient is
scatter-added in f32; the LayerNorm affines are read in f32.  Adam's
update then lands on the f32 weight (an update under ~0.4% of a weight
would round away in bf16 storage).  ``nn.Linear`` keeps PyTorch's
``(out, in)`` weight layout; :mod:`.convert` is the one place that
transposes flax's ``(in, out)`` kernels.

:meth:`GptModel.forward` is the training forward, seq-first ``(S, B)``;
``remat=True`` (policy ``"full"``) recomputes each block in the backward
(``torch.utils.checkpoint``, non-reentrant).  :func:`gpt_lm_loss` is the
next-token cross entropy through the tied embedding.  The serving bodies
(:mod:`apex_tpu_torch.serve.model`) drive the same block functions.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine
from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb_cached
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)

__all__ = [
    "GptConfig",
    "GptBlock",
    "GptModel",
    "LayerNorm",
    "apply_block",
    "apply_layer_norm",
    "apply_linear",
    "apply_mlp",
    "embed_tokens",
    "gpt_lm_loss",
    "rope_cos_sin",
    "tied_logits",
    "vocab_logits",
]


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


def _linear(n_in: int, n_out: int, device) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=True, dtype=torch.float32,
                     device=device)


# ---------------------------------------------------------------------------
# functional layers (numerics of the JAX stack at tp=1)
# ---------------------------------------------------------------------------


def apply_layer_norm(x, ln: LayerNorm, eps: float):
    """Fused LayerNorm (K1 forward, K2 backward on the card)."""
    return fused_layer_norm_affine(x, ln.scale, ln.bias, (x.shape[-1],),
                                   eps=eps)


def apply_linear(x, lin: nn.Linear, dtype):
    """Compute-dtype matmul (f32 accumulation inside), cast back, bias
    added in the compute dtype (Column/RowParallelLinear at tp=1)."""
    return F.linear(x.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)


def embed_tokens(model: "GptModel", ids, dtype):
    """Lookup on the stored table, then the cast (VocabParallelEmbedding
    at tp=1)."""
    return F.embedding(ids.long(), model.word_embeddings.weight).to(dtype)


def apply_mlp(x, blk: "GptBlock", cfg: GptConfig):
    """x + fc2(gelu_tanh(fc1(LN(x))))."""
    y = apply_layer_norm(x, blk.ln_mlp, cfg.layer_norm_eps)
    y = apply_linear(y, blk.fc1, cfg.dtype)
    y = F.gelu(y, approximate="tanh")
    y = apply_linear(y, blk.fc2, cfg.dtype)
    return x + y


def apply_block(cfg: GptConfig, blk: "GptBlock", x, cos, sin):
    """One decoder block over ``x`` (S, B, hidden), the JAX ``GptBlock``:
    x + attn(LN(x)), then x + mlp(LN(x)).  Returns the new hidden and
    this layer's rotated K and V as (B, H, S, D) (the serving prefill
    writes them into its cache)."""
    heads = cfg.num_heads
    head_dim = cfg.head_dim
    y = apply_layer_norm(x, blk.ln_attn, cfg.layer_norm_eps)
    qkv = apply_linear(y, blk.qkv, cfg.dtype)
    s, b = qkv.shape[0], qkv.shape[1]
    # per-head-interleaved (heads, 3, head_dim) column layout
    qkv = qkv.reshape(s, b, heads, 3, head_dim)
    q, k, v = (qkv[:, :, :, i].permute(1, 2, 0, 3) for i in range(3))
    if cfg.rotary:
        q = fused_apply_rotary_pos_emb_cached(q, cos, sin)
        k = fused_apply_rotary_pos_emb_cached(k, cos, sin)
    ctx = flash_attention(q, k, v, causal=True, scale=head_dim ** -0.5)
    ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, heads * head_dim)
    x = x + apply_linear(ctx, blk.out, cfg.dtype)
    return apply_mlp(x, blk, cfg), k, v


class _TiedLogits(torch.autograd.Function):
    """f32 logits ``h @ E^T`` from compute-dtype ``h`` (..., hidden) and
    ``E`` (V, hidden), as the JAX matmul with ``preferred_element_type=
    f32``.  The backward takes the f32 cotangent in the compute dtype
    (the dtype of the primal operands, where JAX's transposed dots
    return their cotangents)."""

    @staticmethod
    def forward(ctx, h, embed):
        ctx.save_for_backward(h, embed)
        if not h.is_cuda or h.dtype == torch.float32:
            return F.linear(h.float(), embed.float())
        # One tensor-core GEMM on the compute-dtype operands with f32
        # accumulation and an f32 result: the f32 GEMM's numbers up to
        # summation order, with no f32 copy of either operand and no
        # process-wide setting (such as TF32) that other threads see
        out = torch.mm(h.reshape(-1, h.shape[-1]), embed.t(),
                       out_dtype=torch.float32)
        return out.reshape(*h.shape[:-1], embed.shape[0])

    @staticmethod
    def backward(ctx, g):
        h, embed = ctx.saved_tensors
        gc = g.to(h.dtype)
        dh = gc @ embed
        dembed = gc.reshape(-1, gc.shape[-1]).t() @ h.reshape(-1, h.shape[-1])
        return dh, dembed


def vocab_logits(h, embed):
    """f32 logits ``h @ embed^T`` (..., V) from ``h`` (..., hidden) and
    ``embed`` (V, hidden), both in the compute dtype.  V need not be a
    multiple of 8 (BERT's 30522)."""
    return _TiedLogits.apply(h, embed)


def tied_logits(model: "GptModel", h, dtype):
    """Vocab logits (..., V) in f32 through the tied embedding, with
    compute-dtype operands (``_tied_vocab_logits`` at tp=1)."""
    return vocab_logits(h.to(dtype), model.word_embeddings.weight.to(dtype))


class GptBlock(nn.Module):
    """One pre-LN decoder block's f32 weights and its forward.  The fused
    ``qkv`` output columns are ordered ``(heads, 3, head_dim)`` as in the
    JAX block."""

    def __init__(self, cfg: GptConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.ln_attn = LayerNorm(h, device)
        self.qkv = _linear(h, 3 * h, device)
        self.out = _linear(h, h, device)
        self.ln_mlp = LayerNorm(h, device)
        self.fc1 = _linear(h, cfg.intermediate_size, device)
        self.fc2 = _linear(cfg.intermediate_size, h, device)

    def forward(self, x, cos=None, sin=None):
        return apply_block(self.cfg, self, x, cos, sin)[0]


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
        if cfg.remat and cfg.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported yet "
                "(ROADMAP: remat policies 'dots' and 'sums'); use 'full'"
            )
        dev = resolve_device(device)
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, dtype=torch.float32, device=dev
        )
        if not cfg.rotary:
            self.position_embeddings = nn.Parameter(torch.empty(
                cfg.max_seq_len, cfg.hidden_size, dtype=torch.float32,
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
        """Seeded init, drawn on the generator's device in f32."""
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

    def forward(self, input_ids):
        """Hidden states (S, B, hidden) in ``cfg.dtype`` after the final
        LayerNorm, for token ids (S, B)."""
        cfg = self.cfg
        s = input_ids.shape[0]
        x = embed_tokens(self, input_ids, cfg.dtype)
        cos = sin = None
        if cfg.rotary:
            cos, sin = rope_cos_sin(s, cfg.head_dim, device=x.device)
        else:
            if s > cfg.max_seq_len:
                raise ValueError(
                    f"sequence of {s} exceeds max_seq_len {cfg.max_seq_len}"
                )
            x = x + self.position_embeddings[:s, None, :].to(cfg.dtype)
        for blk in self.layers:
            if cfg.remat:
                x = checkpoint(blk, x, cos, sin, use_reentrant=False)
            else:
                x = blk(x, cos, sin)
        return apply_layer_norm(x, self.ln_f, cfg.layer_norm_eps)


def gpt_lm_loss(model: GptModel, input_ids):
    """Next-token cross entropy through the tied embedding: f32 logits
    of every position, then the mean over positions 0..S-2 of the loss
    of predicting token t+1 (``gpt_lm_loss`` of the JAX package at tp=1,
    no MoE).  ``input_ids`` is (S, B)."""
    logits = tied_logits(model, model(input_ids), model.cfg.dtype)
    losses = vocab_parallel_cross_entropy(logits[:-1], input_ids[1:])
    return losses.mean()

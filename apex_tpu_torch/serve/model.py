"""Functional GPT forward for serving — prefill and decode bodies.

Counterpart of ``apex_tpu/serve/model.py``: the same weights driven
through two dataflows — a one-shot **prefill** that also writes every
position's K/V into the paged cache, and a single-token **decode** that
appends to and reads from it.  Numerics follow the JAX bodies:

- matmuls in ``cfg.dtype`` with the result cast back and the bias added
  in ``cfg.dtype`` (tp=1 Column/RowParallelLinear);
- fused LayerNorm (kernel K1 on the card), f32 RoPE rotation, causal
  flash attention for prefill (K3), paged decode attention for decode
  (K6, query RoPE fused);
- tied-embedding logits in f32 from ``cfg.dtype`` operands.

Next tokens are greedy (argmax).  The chunked prefill, the int8 weight
and KV wires and temperature/top-k sampling are not ported yet and
raise.  The KV pool tensors are updated in place.
"""

from __future__ import annotations

from copy import deepcopy

import torch

from apex_tpu_torch.models.gpt import (
    GptConfig,
    GptModel,
    apply_block,
    apply_layer_norm,
    apply_linear,
    apply_mlp,
    embed_tokens,
    rope_cos_sin,
    tied_logits,
)
from apex_tpu_torch.ops.paged_attention import paged_decode_attention
from apex_tpu_torch.ops.rope import rotate_half
from apex_tpu_torch.serve import cache as cache_lib

__all__ = ["validate_config", "serving_copy", "prefill_body", "decode_body"]


def validate_config(cfg: GptConfig) -> GptConfig:
    """Serving supports the dense single-shard GPT stack."""
    if cfg.sequence_parallel or cfg.context_parallel:
        raise ValueError(
            "serving requires sequence_parallel=False and "
            "context_parallel=None (the engine owns the whole sequence)"
        )
    if cfg.num_experts:
        raise ValueError("MoE serving is not supported yet")
    return cfg


def _check_wire(kv_wire: str) -> None:
    if kv_wire != "f32":
        raise NotImplementedError(
            f"kv_wire {kv_wire!r} is not ported yet (only 'f32')"
        )


# ---------------------------------------------------------------------------
# the engine's weights and the serving-only layers
# ---------------------------------------------------------------------------


@torch.no_grad()
def serving_copy(cfg: GptConfig, model: GptModel) -> GptModel:
    """The engine's copy of ``model``: the matmul and embedding weights
    cast to ``cfg.dtype`` once, here, and the LayerNorm affines kept in
    f32, so that no decode step casts f32 weights (the shared layers'
    casts are then no-ops).  Gradients are off."""
    copy = deepcopy(model)
    for blk in copy.layers:
        for lin in (blk.qkv, blk.out, blk.fc1, blk.fc2):
            lin.to(cfg.dtype)
    copy.word_embeddings.to(cfg.dtype)
    if not cfg.rotary:
        copy.position_embeddings.data = copy.position_embeddings.data.to(
            cfg.dtype)
    return copy.requires_grad_(False)


def _rope_rows(x, cos, sin):
    """f32 rotate_half rotation with per-sequence cos/sin rows (B, D)
    broadcast over heads."""
    xf = x.float()
    out = xf * cos[:, None, :] + rotate_half(xf) * sin[:, None, :]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# prefill: full-sequence forward that also yields per-position K/V
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill_body(
    cfg: GptConfig,
    model: GptModel,
    kv_pages: dict,
    tokens,          # (S, 1) int — one sequence, bucket-padded
    length: int,     # live prompt positions
    page_ids,        # (S/page,) int — null-page entries pad the tail
    *,
    page_size: int,
    kv_wire: str = "f32",
):
    """Full prefill: forward the (padded) prompt, write every layer's K/V
    into the assigned pages, and return the last live position's logits.
    Causality makes the padding free: a live query row never attends a
    padded (later) key, and the padded tail's K/V land in pages the
    decode ``lengths`` never read (or in the null page).

    Returns ``(logits (V,) f32, next_token () int64, finite () bool,
    kv_pages)``."""
    _check_wire(kv_wire)
    dtype = cfg.dtype
    x = embed_tokens(model, tokens, dtype)  # (S, 1, h)
    s = tokens.shape[0]
    cos = sin = None
    if cfg.rotary:
        cos, sin = rope_cos_sin(cfg.max_seq_len, cfg.head_dim,
                                device=x.device)
        cos, sin = cos[:s], sin[:s]
    else:
        x = x + model.position_embeddings[:s, None, :].to(dtype)

    ks, vs = [], []
    for blk in model.layers:
        x, k, v = apply_block(cfg, blk, x, cos, sin)
        # (1, H, S, D) -> per-position rows (S, H, D) -> page blocks
        ks.append(cache_lib.pack_prompt_pages(k[0].transpose(0, 1), page_size))
        vs.append(cache_lib.pack_prompt_pages(v[0].transpose(0, 1), page_size))
    cache_lib.write_prompt_pages(kv_pages["k"], torch.stack(ks), page_ids)
    cache_lib.write_prompt_pages(kv_pages["v"], torch.stack(vs), page_ids)

    h_last = x[max(int(length) - 1, 0), 0][None]  # (1, hidden)
    h_last = apply_layer_norm(h_last, model.ln_f, cfg.layer_norm_eps)
    logits = tied_logits(model, h_last, dtype)[0]  # (V,) f32
    next_token = torch.argmax(logits, dim=-1)
    finite = torch.isfinite(logits).all()
    return logits, next_token, finite, kv_pages


# ---------------------------------------------------------------------------
# decode: one token per running sequence through the paged cache
# ---------------------------------------------------------------------------


def _decode_step(cfg: GptConfig, model: GptModel, kv_pages: dict, tokens,
                 lengths, page_tables, *, page_size: int):
    """Embed the token column, append each layer's K/V at this
    position's page slot, run the paged attention, and return the
    final-LN logits (B, V) f32."""
    b = tokens.shape[0]
    heads = cfg.num_heads
    head_dim = cfg.head_dim
    x = embed_tokens(model, tokens, cfg.dtype)  # (B, hidden)

    pos = (lengths.long() - 1).clamp_min(0)  # this token's position
    rows = torch.arange(b, device=x.device)
    page_ids = page_tables.long()[rows, pos // page_size]  # (B,)
    slots = pos % page_size
    cos_rows = sin_rows = None
    if cfg.rotary:
        cos_t, sin_t = rope_cos_sin(cfg.max_seq_len, head_dim,
                                    device=x.device)
        cos_rows, sin_rows = cos_t[pos], sin_t[pos]  # (B, D)
    else:
        x = x + model.position_embeddings[pos].to(cfg.dtype)

    for i, blk in enumerate(model.layers):
        k_l, v_l = kv_pages["k"][i], kv_pages["v"][i]
        y = apply_layer_norm(x, blk.ln_attn, cfg.layer_norm_eps)
        qkv = apply_linear(y, blk.qkv, cfg.dtype).reshape(b, heads, 3, head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, H, D)
        if cfg.rotary:
            k = _rope_rows(k, cos_rows, sin_rows)
        cache_lib.append_token_kv(k_l, k, page_ids, slots)
        cache_lib.append_token_kv(v_l, v, page_ids, slots)
        ctx = paged_decode_attention(
            q.contiguous(), k_l, v_l, page_tables, lengths,
            scale=head_dim ** -0.5, rope_cos=cos_rows, rope_sin=sin_rows,
        )
        ctx = ctx.to(cfg.dtype).reshape(b, heads * head_dim)
        x = x + apply_linear(ctx, blk.out, cfg.dtype)
        x = apply_mlp(x, blk, cfg)

    h = apply_layer_norm(x, model.ln_f, cfg.layer_norm_eps)
    return tied_logits(model, h, cfg.dtype)


@torch.no_grad()
def decode_body(
    cfg: GptConfig,
    model: GptModel,
    kv_pages: dict,
    tokens,       # (B,) int — current token per slot
    lengths,      # (B,) int32 — context length AFTER this token; 0 = idle
    page_tables,  # (B, NP) int32
    *,
    page_size: int,
    kv_wire: str = "f32",
):
    """One continuous-batching decode iteration over the full slot
    array.  Idle slots (``lengths == 0``) write into the null page and
    read zeros.

    Returns ``(logits (B, V) f32, next_tokens (B,) int64, finite (B,)
    bool, kv_pages)`` — ``finite[b]`` screens slot ``b``'s logits row."""
    _check_wire(kv_wire)
    logits = _decode_step(cfg, model, kv_pages, tokens, lengths,
                          page_tables, page_size=page_size)
    next_tokens = torch.argmax(logits, dim=-1)
    finite = torch.isfinite(logits).all(dim=-1)
    return logits, next_tokens, finite, kv_pages

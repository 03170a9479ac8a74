"""Functional GPT forward for serving — prefill, chunked prefill, decode.

Counterpart of ``apex_tpu/serve/model.py``: the same weights driven
through three dataflows — a one-shot **prefill** that also writes every
position's K/V into the paged cache, a **chunked prefill** of one
page-multiple slice of a prompt that reads the positions before it from
the cache, and a single-token **decode** that appends to and reads from
it.  Numerics follow the JAX bodies:

- matmuls in ``cfg.dtype`` with the result cast back and the bias added
  in ``cfg.dtype`` (tp=1 Column/RowParallelLinear);
- fused LayerNorm (kernel K1 on the card), f32 RoPE rotation, causal
  flash attention for the monolithic prefill (K3), paged decode
  attention for decode (K6, query RoPE and the int8 dequant fused); the
  chunked prefill's attention is the reference's dense gather and
  softmax, plain PyTorch;
- tied-embedding logits in f32 from ``cfg.dtype`` operands;
- the fused sampler (:func:`sample_tokens`): greedy where a temperature
  is ``<= 0``, else the Gumbel-argmax draw over ``logits / temp`` after
  the ``top_k`` mask, with noise from a counter-based hash
  (:func:`sample_keys`, :func:`gumbel_noise`) instead of a generator's
  hidden state, so a captured graph replays it and a stream re-draws it.

**Wires.** ``kv_wire="int8"`` stores the KV cache as blockwise int8
codes plus one f32 scale per (head, token) row
(:func:`~apex_tpu_torch.serve.cache.encode_kv`).  ``weight_wire="int8"``
puts every parameter leaf of at least :data:`WEIGHT_WIRE_MIN_SIZE`
elements — leaves of the JAX layout, the stack's leaves stacked over the
layers — on the codec of :mod:`apex_tpu_torch.parallel.comm`
(:func:`quantize_params`); the engine then holds :class:`PackedParams`,
and a step dequantizes one layer's leaves at a time (codes × scale in
f32, cast to ``cfg.dtype`` where the layer computes), so no dense copy
of the weights is kept.  The KV pool tensors are updated in place.
"""

from __future__ import annotations

import functools
import math
from copy import deepcopy
from types import SimpleNamespace
from typing import Mapping

import torch

from apex_tpu_torch.models.convert import _tree_map, gpt_param_tree
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
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.paged_attention import paged_decode_attention
from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb_cached, rotate_half
from apex_tpu_torch.parallel import comm
from apex_tpu_torch.serve import cache as cache_lib

__all__ = [
    "WEIGHT_WIRE_MIN_SIZE",
    "validate_config",
    "rope_tables",
    "serving_copy",
    "PackedWeight",
    "PackedParams",
    "quantize_params",
    "dequantize_params",
    "fold31",
    "sample_keys",
    "gumbel_noise",
    "sample_tokens",
    "prefill_body",
    "chunk_prefill_body",
    "decode_body",
]

#: leaves smaller than this stay exact under weight_wire="int8" (biases,
#: LN affines — the reference's rule)
WEIGHT_WIRE_MIN_SIZE = 1024

#: sampling-key domains: the first word of each row's key
#: (:func:`sample_keys`)
DOMAIN_PREFILL_CALL = 1    # (prefill call index, 0)
DOMAIN_PREFILL_STREAM = 2  # (stream seed, 0)
DOMAIN_DECODE_CALL = 3     # (decode call index, slot)
DOMAIN_DECODE_STREAM = 4   # (stream seed, generation index)
DOMAIN_DRAFT_STREAM = 5    # a speculative draft's proposal (stream, index)
DOMAIN_ACCEPT_STREAM = 6   # a speculative acceptance uniform (stream, index)


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


def rope_tables(cfg: GptConfig, device="cuda"):
    """The f32 cos/sin tables ``(max_seq_len, head_dim)`` in the model's
    rotate_half layout, on ``device`` (the card by default), or ``(None,
    None)`` for a model without RoPE."""
    if not cfg.rotary:
        return None, None
    return rope_cos_sin(cfg.max_seq_len, cfg.head_dim,
                        device=resolve_device(device))


def _check_wire(kv_wire: str) -> None:
    if kv_wire not in ("f32", "int8"):
        raise ValueError(f"kv_wire must be 'f32' or 'int8', got {kv_wire!r}")


# ---------------------------------------------------------------------------
# the engine's weights: a cfg.dtype copy, or the int8 weight wire
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
    copy._serving_copy = True  # prepared: an engine adopts it as it is
    return copy.requires_grad_(False)


class PackedWeight:
    """A parameter leaf on the blockwise int8 wire: the flattened leaf's
    codes ``(n_pad,)`` int8 and scales ``(n_pad / block,)`` f32, with its
    shape, element count, block and dtype."""

    def __init__(self, codes, scale, shape, n, block, dtype):
        self.codes = codes
        self.scale = scale
        self.shape = tuple(shape)
        self.n = int(n)
        self.block = int(block)
        self.dtype = dtype

    def nbytes(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.scale.numel() * self.scale.element_size())

    def unpack(self) -> torch.Tensor:
        """The whole leaf, dense, in its dtype."""
        flat = comm.dequantize_blocks(self.codes, self.scale, self.block,
                                      self.n)
        return flat.reshape(self.shape).to(self.dtype)

    def layer(self, i: int) -> torch.Tensor:
        """Slice ``i`` of a leaf stacked on its first axis, dense, in its
        dtype: only the blocks that hold it are dequantized (the same
        values as ``unpack()[i]``)."""
        per = math.prod(self.shape[1:])
        lo, hi = i * per, (i + 1) * per
        b0, b1 = lo // self.block, -(-hi // self.block)
        codes = self.codes[b0 * self.block: b1 * self.block]
        flat = comm.dequantize_blocks(codes, self.scale[b0:b1], self.block)
        start = lo - b0 * self.block
        return flat[start: start + per].reshape(self.shape[1:]).to(self.dtype)


@torch.no_grad()
def quantize_params(params, *, block: int = comm.DEFAULT_BLOCK,
                    min_size: int = WEIGHT_WIRE_MIN_SIZE):
    """Pack every leaf of ``params`` (a nested dict of tensors, e.g.
    :func:`~apex_tpu_torch.models.convert.gpt_param_tree`) with at least
    ``min_size`` elements onto the blockwise int8 wire (flattened,
    ``comm.quantize_blocks``); smaller leaves pass through exact.
    Inverse: :func:`dequantize_params`."""

    def pack(leaf):
        if leaf.numel() < min_size:
            return leaf
        flat = leaf.reshape(-1).float()
        codes, scale = comm.quantize_blocks(flat, block=block)
        return PackedWeight(codes, scale, leaf.shape, flat.shape[0], block,
                            leaf.dtype)

    return _tree_map(pack, params)


def dequantize_params(params):
    """Unpack a :func:`quantize_params` tree back to dense leaves."""
    return _tree_map(
        lambda leaf: leaf.unpack() if isinstance(leaf, PackedWeight) else leaf,
        params,
    )


def _leaf(leaf, i=None):
    if isinstance(leaf, PackedWeight):
        return leaf.unpack() if i is None else leaf.layer(i)
    return leaf if i is None else leaf[i]


class PackedParams:
    """The engine's weights on the int8 wire: :func:`quantize_params` of
    a model's :func:`~apex_tpu_torch.models.convert.gpt_param_tree`.
    :meth:`view` gives the serving bodies what they read of a
    :class:`GptModel` (``word_embeddings.weight``, ``ln_f``,
    ``position_embeddings`` and ``layers``), dequantized: the embedding
    table once a step (embedding lookup and tied logits), each layer's
    leaves only when the loop reaches that layer."""

    def __init__(self, cfg: GptConfig, model: GptModel, *,
                 block: int = comm.DEFAULT_BLOCK,
                 min_size: int = WEIGHT_WIRE_MIN_SIZE):
        self.cfg = cfg
        self.tree = quantize_params(gpt_param_tree(model), block=block,
                                    min_size=min_size)

    def leaves(self):
        out = []

        def walk(t):
            if isinstance(t, Mapping):
                for v in t.values():
                    walk(v)
            else:
                out.append(t)

        walk(self.tree)
        return out

    def nbytes(self) -> int:
        """Resident bytes: codes and scales of the packed leaves, the
        exact leaves in full."""
        return sum(
            leaf.nbytes() if isinstance(leaf, PackedWeight)
            else leaf.numel() * leaf.element_size()
            for leaf in self.leaves()
        )

    def layer(self, i: int):
        """Layer ``i``'s leaves, dense, shaped as a ``GptBlock`` reads
        them (``nn.Linear`` weights ``(out, in)``)."""
        bp = self.tree["params"]["layers"]["block"]
        blk = SimpleNamespace()
        for name in ("qkv", "out", "fc1", "fc2"):
            setattr(blk, name, SimpleNamespace(
                weight=_leaf(bp[name]["weight"], i).t(),
                bias=_leaf(bp[name]["bias"], i),
            ))
        for name in ("ln_attn", "ln_mlp"):
            setattr(blk, name, SimpleNamespace(
                scale=_leaf(bp[name]["scale"], i),
                bias=_leaf(bp[name]["bias"], i),
            ))
        return blk

    def view(self):
        tree = self.tree["params"]
        view = SimpleNamespace(
            word_embeddings=SimpleNamespace(
                weight=_leaf(tree["word_embeddings"]["weight"])),
            ln_f=SimpleNamespace(scale=_leaf(tree["ln_f"]["scale"]),
                                 bias=_leaf(tree["ln_f"]["bias"])),
            layers=(self.layer(i) for i in range(self.cfg.num_layers)),
        )
        if not self.cfg.rotary:
            view.position_embeddings = _leaf(tree["position_embeddings"])
        return view


def _view(weights):
    """What a body reads: the model itself, or a packed tree's view."""
    return weights.view() if isinstance(weights, PackedParams) else weights


def _rope_rows(x, cos, sin):
    """f32 rotate_half rotation with per-sequence cos/sin rows (B, D)
    broadcast over heads."""
    xf = x.float()
    out = xf * cos[:, None, :] + rotate_half(xf) * sin[:, None, :]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# fused sampling: greedy / temperature / top-k, noise from a counter hash
# ---------------------------------------------------------------------------

_M31 = 0x7FFFFFFF


def _fmix31(x):
    """A murmur3-style finalizer on 31-bit values held in int64: two odd
    multiplies mod 2**31 (constants below 2**31, so no product leaves
    int64) between xor-shifts, each step a bijection."""
    x = x ^ (x >> 16)
    x = (x * 0x045D9F3B) & _M31
    x = x ^ (x >> 13)
    x = (x * 0x2C1B3C6D) & _M31
    return x ^ (x >> 16)


def fold31(words):
    """Fold uint32 words (ints or an int64 array) to the 31 bits the
    hash takes (the top bit xored into the bottom)."""
    return (words ^ (words >> 31)) & _M31


def sample_keys(seed: int, words: torch.Tensor) -> torch.Tensor:
    """Per-row sampling keys ``(B,)`` int64 (31-bit values): the hash
    chained over ``seed`` and each row's words ``(B, k)`` (31-bit values
    in int64, :func:`fold31` — a domain tag, then e.g. a stream seed and
    a generation index)."""
    h = torch.full(words.shape[:1], _fmix31(fold31(seed & 0xFFFFFFFF)),
                   dtype=torch.int64, device=words.device)
    for j in range(words.shape[1]):
        h = _fmix31(h ^ (words[:, j] & _M31))
    return h


@functools.lru_cache(maxsize=8)
def _vocab_hash(vocab: int, device: str) -> torch.Tensor:
    """The hash of every vocab index (read-only; a captured graph reads
    it at a fixed address)."""
    return _fmix31(torch.arange(vocab, dtype=torch.int64, device=device)
                   + 0x3C6EF372)


def _uniform(h: torch.Tensor) -> torch.Tensor:
    """31-bit hashes -> f32 uniforms strictly inside (0, 1): the top 23
    bits plus one half, over 2**23 — every value exact in f32, from
    2**-24 to 1 - 2**-24 (24 bits would round the top one up to 1.0, and
    the Gumbel of 1.0 is +inf)."""
    return ((h >> 8).float() + 0.5) * (2.0 ** -23)


def gumbel_noise(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """Standard Gumbel noise ``(B, vocab)`` f32, finite: element ``(b,
    v)`` is a function of ``keys[b]`` and ``v`` only (a hash to a uniform
    in (0, 1), then ``-log(-log(u))``), on the keys' device."""
    h = _fmix31(keys[:, None] ^ _vocab_hash(vocab, str(keys.device))[None])
    return -torch.log(-torch.log(_uniform(h)))


def _sample_with_noise(logits, temps, gumbel, top_k: int = 0):
    """The reference's sampler with the noise given: argmax of
    ``logits / max(temp, 1e-6) + gumbel`` after the ``top_k`` mask
    (0 = the full vocab); greedy argmax where ``temp <= 0``.  ``logits``
    ``(..., V)`` f32, ``temps`` broadcasting against the leading dims."""
    temps = torch.as_tensor(temps, dtype=torch.float32, device=logits.device)
    greedy = torch.argmax(logits, dim=-1)
    vocab = logits.shape[-1]
    masked = logits
    if 0 < top_k < vocab:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        masked = logits.masked_fill(logits < kth, float("-inf"))
    scaled = masked / torch.clamp_min(temps, 1e-6)[..., None]
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temps > 0, sampled, greedy)


def sample_tokens(logits, temps, keys, *, top_k: int = 0):
    """Next tokens from ``logits`` ``(B, V)`` f32 at per-row ``temps``
    ``(B,)`` with the noise of ``keys`` ``(B,)`` (:func:`sample_keys`):
    greedy rows are the argmax, bit for bit."""
    return _sample_with_noise(logits, temps,
                              gumbel_noise(keys, logits.shape[-1]),
                              top_k=top_k)


def _next_tokens(logits, temps, keys, top_k):
    """Argmax without a sampler (``keys`` None), else the sampler; for
    one row ``(V,)`` or a batch ``(B, V)``."""
    if keys is None:
        return torch.argmax(logits, dim=-1)
    if logits.dim() == 1:
        return sample_tokens(logits[None], temps.reshape(1), keys,
                             top_k=top_k)[0]
    return sample_tokens(logits, temps, keys, top_k=top_k)


# ---------------------------------------------------------------------------
# prefill: full-sequence forward that also yields per-position K/V
# ---------------------------------------------------------------------------


def _write_pages(kv_pages, name, blocks, page_ids, kv_wire):
    """Write layer-stacked page blocks ``(L, NP, H, page, D)`` into pool
    ``name`` at ``page_ids`` (through
    :func:`~apex_tpu_torch.serve.cache.encode_kv` under the int8 wire)."""
    write = cache_lib.write_prompt_pages
    if kv_wire == "int8":
        codes, scale = cache_lib.encode_kv(blocks)
        write(kv_pages[name], codes, page_ids)
        write(kv_pages[name + "_scale"], scale, page_ids)
    else:
        write(kv_pages[name], blocks, page_ids)


@torch.no_grad()
def prefill_body(
    cfg: GptConfig,
    weights,
    kv_pages: dict,
    tokens,          # (S, 1) int — one sequence, bucket-padded
    length: int,     # live prompt positions
    page_ids,        # (S/page,) int — null-page entries pad the tail
    temp=None,       # () f32 sampling temperature
    keys=None,       # (1,) sampling key (None = argmax)
    *,
    page_size: int,
    kv_wire: str = "f32",
    top_k: int = 0,
):
    """Full prefill: forward the (padded) prompt through ``weights`` (a
    :class:`GptModel` or :class:`PackedParams`), write every layer's K/V
    into the assigned pages, and return the last live position's logits.
    Causality makes the padding free: a live query row never attends a
    padded (later) key, and the padded tail's K/V land in pages the
    decode ``lengths`` never read (or in the null page).

    Returns ``(logits (V,) f32, next_token () int64, finite () bool,
    kv_pages)``."""
    _check_wire(kv_wire)
    dtype = cfg.dtype
    view = _view(weights)
    x = embed_tokens(view, tokens, dtype)  # (S, 1, h)
    s = tokens.shape[0]
    cos = sin = None
    if cfg.rotary:
        cos, sin = rope_tables(cfg, x.device)
        cos, sin = cos[:s], sin[:s]
    else:
        x = x + view.position_embeddings[:s, None, :].to(dtype)

    ks, vs = [], []
    for blk in view.layers:
        x, k, v = apply_block(cfg, blk, x, cos, sin)
        # (1, H, S, D) -> per-position rows (S, H, D) -> page blocks
        ks.append(cache_lib.pack_prompt_pages(k[0].transpose(0, 1), page_size))
        vs.append(cache_lib.pack_prompt_pages(v[0].transpose(0, 1), page_size))
    _write_pages(kv_pages, "k", torch.stack(ks), page_ids, kv_wire)
    _write_pages(kv_pages, "v", torch.stack(vs), page_ids, kv_wire)

    h_last = x[max(int(length) - 1, 0), 0][None]  # (1, hidden)
    h_last = apply_layer_norm(h_last, view.ln_f, cfg.layer_norm_eps)
    logits = tied_logits(view, h_last, dtype)[0]  # (V,) f32
    next_token = _next_tokens(logits, temp, keys, top_k)
    finite = torch.isfinite(logits).all()
    return logits, next_token, finite, kv_pages


# ---------------------------------------------------------------------------
# chunked prefill: a page-multiple prompt slice with carry-in KV offset
# ---------------------------------------------------------------------------


def _dequant_rows(codes, scale):
    """(..., page, D) int8 codes + (..., page) f32 scales -> f32 rows
    (the codec at block = D: one scale per row)."""
    return codes.float() * scale[..., None]


@torch.no_grad()
def chunk_prefill_body(
    cfg: GptConfig,
    weights,
    kv_pages: dict,
    tokens,          # (C, 1) int — one chunk, bucket-padded
    length: int,     # live tokens in THIS chunk
    offset: int,     # absolute position of tokens[0]
    chunk_page_ids,  # (C/page,) int — null entries skip the write
    page_table,      # (NP,) int — the request's full page table
    temp=None,       # () f32 sampling temperature
    keys=None,       # (1,) sampling key (None = argmax)
    *,
    page_size: int,
    kv_wire: str = "f32",
    top_k: int = 0,
):
    """One page-multiple prefill chunk with carry-in KV offset: the
    chunk's queries attend every position before ``offset`` through the
    paged cache (a dense gather of ``page_table`` read through the cache
    wire, as decode reads it: committed prefix-cache pages and this
    request's own earlier chunks alike) plus the in-chunk keys causally,
    exact.  Writes the chunk's K/V to ``chunk_page_ids``; entries at the
    null page skip pages a borrowed cache run already holds.  The
    attention is the reference's plain composition (f32 einsum, masked
    softmax); no kernel runs it.

    Returns ``(logits (V,) f32, next_token () int64, finite () bool,
    kv_pages)`` for the last live chunk position."""
    _check_wire(kv_wire)
    dtype = cfg.dtype
    view = _view(weights)
    dev = tokens.device
    x = embed_tokens(view, tokens, dtype)  # (C, 1, h)
    c = tokens.shape[0]
    heads = cfg.num_heads
    head_dim = cfg.head_dim
    # a padded position past the table reads its last row: it is
    # attended by no live query and lands at positions decode masks
    positions = (offset + torch.arange(c, device=dev)).clamp_max(
        cfg.max_seq_len - 1)
    cos_rows = sin_rows = None
    if cfg.rotary:
        cos_t, sin_t = rope_tables(cfg, dev)
        cos_rows, sin_rows = cos_t[positions], sin_t[positions]  # (C, D)
    else:
        x = x + view.position_embeddings[positions][:, None, :].to(dtype)

    int8 = kv_wire == "int8"
    table = page_table.long()
    chunk_ids = chunk_page_ids.long()
    t_ctx = table.shape[0] * page_size
    # carry-in mask: gathered row t is absolute position t; only the
    # positions before the chunk are carry
    carry_valid = torch.arange(t_ctx, device=dev) < offset
    causal = torch.ones(c, c, dtype=torch.bool, device=dev).tril()
    mask = torch.cat([carry_valid[None, :].expand(c, t_ctx), causal], dim=1)
    scale = head_dim ** -0.5
    big_neg = torch.finfo(torch.float32).min

    for i, blk in enumerate(view.layers):
        k_l, v_l = kv_pages["k"][i], kv_pages["v"][i]
        y = apply_layer_norm(x, blk.ln_attn, cfg.layer_norm_eps)
        qkv = apply_linear(y, blk.qkv, dtype).reshape(c, 1, heads, 3,
                                                      head_dim)
        q, k, v = (qkv[:, :, :, j].permute(1, 2, 0, 3) for j in range(3))
        if cfg.rotary:
            q = fused_apply_rotary_pos_emb_cached(q, cos_rows, sin_rows)
            k = fused_apply_rotary_pos_emb_cached(k, cos_rows, sin_rows)
        if int8:
            ks_l, vs_l = kv_pages["k_scale"][i], kv_pages["v_scale"][i]
            k_ctx = _dequant_rows(k_l[table], ks_l[table])
            v_ctx = _dequant_rows(v_l[table], vs_l[table])
        else:
            k_ctx, v_ctx = k_l[table].float(), v_l[table].float()
        # (NP, H, page, D) -> (H, T, D) in absolute position order
        k_ctx = k_ctx.transpose(0, 1).reshape(heads, t_ctx, head_dim)
        v_ctx = v_ctx.transpose(0, 1).reshape(heads, t_ctx, head_dim)
        k_all = torch.cat([k_ctx, k[0].float()], dim=1)  # (H, T+C, D)
        v_all = torch.cat([v_ctx, v[0].float()], dim=1)
        scores = torch.einsum("hcd,htd->hct", q[0].float(), k_all) * scale
        scores = scores.masked_fill(~mask, big_neg)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("hct,htd->hcd", probs, v_all)  # (H, C, D)
        ctx = ctx.transpose(0, 1).reshape(c, 1, heads * head_dim).to(dtype)
        x = x + apply_linear(ctx, blk.out, dtype)
        x = apply_mlp(x, blk, cfg)
        # the chunk's K/V pages (null entries dump cached pages' re-runs)
        for name, rows, pool in (("k", k, k_l), ("v", v, v_l)):
            blocks = cache_lib.pack_prompt_pages(rows[0].transpose(0, 1),
                                                 page_size)
            if int8:
                codes, sc = cache_lib.encode_kv(blocks)
                pool[chunk_ids] = codes
                kv_pages[name + "_scale"][i][chunk_ids] = sc
            else:
                pool[chunk_ids] = blocks.to(pool.dtype)

    h_last = x[max(int(length) - 1, 0), 0][None]  # (1, hidden)
    h_last = apply_layer_norm(h_last, view.ln_f, cfg.layer_norm_eps)
    logits = tied_logits(view, h_last, dtype)[0]  # (V,) f32
    next_token = _next_tokens(logits, temp, keys, top_k)
    finite = torch.isfinite(logits).all()
    return logits, next_token, finite, kv_pages


# ---------------------------------------------------------------------------
# decode: one token per running sequence through the paged cache
# ---------------------------------------------------------------------------


def _decode_step(cfg: GptConfig, view, kv_pages: dict, tokens, lengths,
                 page_tables, *, page_size: int, kv_wire: str):
    """Embed the token column, append each layer's K/V at this
    position's page slot (encoded under the int8 wire), run the paged
    attention (K6 reads the scale planes), and return the final-LN
    logits (B, V) f32."""
    b = tokens.shape[0]
    heads = cfg.num_heads
    head_dim = cfg.head_dim
    int8 = kv_wire == "int8"
    x = embed_tokens(view, tokens, cfg.dtype)  # (B, hidden)

    pos = (lengths.long() - 1).clamp_min(0)  # this token's position
    rows = torch.arange(b, device=x.device)
    page_ids = page_tables.long()[rows, pos // page_size]  # (B,)
    slots = pos % page_size
    cos_rows = sin_rows = None
    if cfg.rotary:
        cos_t, sin_t = rope_tables(cfg, x.device)
        cos_rows, sin_rows = cos_t[pos], sin_t[pos]  # (B, D)
    else:
        x = x + view.position_embeddings[pos].to(cfg.dtype)

    append = cache_lib.append_token_kv
    for i, blk in enumerate(view.layers):
        k_l, v_l = kv_pages["k"][i], kv_pages["v"][i]
        ks_l = vs_l = None
        y = apply_layer_norm(x, blk.ln_attn, cfg.layer_norm_eps)
        qkv = apply_linear(y, blk.qkv, cfg.dtype).reshape(b, heads, 3, head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, H, D)
        if cfg.rotary:
            k = _rope_rows(k, cos_rows, sin_rows)
        if int8:
            ks_l, vs_l = kv_pages["k_scale"][i], kv_pages["v_scale"][i]
            # K and V through one codec call (the same codes and scales
            # as two: every row is its own block)
            codes, sc = cache_lib.encode_kv(torch.stack([k, v]))
            append(k_l, codes[0], page_ids, slots)
            append(v_l, codes[1], page_ids, slots)
            append(ks_l, sc[0], page_ids, slots)
            append(vs_l, sc[1], page_ids, slots)
        else:
            append(k_l, k, page_ids, slots)
            append(v_l, v, page_ids, slots)
        ctx = paged_decode_attention(
            q.contiguous(), k_l, v_l, page_tables, lengths,
            scale=head_dim ** -0.5, k_scale=ks_l, v_scale=vs_l,
            rope_cos=cos_rows, rope_sin=sin_rows,
        )
        ctx = ctx.to(cfg.dtype).reshape(b, heads * head_dim)
        x = x + apply_linear(ctx, blk.out, cfg.dtype)
        x = apply_mlp(x, blk, cfg)

    h = apply_layer_norm(x, view.ln_f, cfg.layer_norm_eps)
    return tied_logits(view, h, cfg.dtype)


@torch.no_grad()
def decode_body(
    cfg: GptConfig,
    weights,
    kv_pages: dict,
    tokens,       # (B,) int — current token per slot
    lengths,      # (B,) int32 — context length AFTER this token; 0 = idle
    page_tables,  # (B, NP) int32
    temps=None,   # (B,) f32 per-slot temperature
    keys=None,    # (B,) per-slot sampling keys (None = argmax)
    *,
    page_size: int,
    kv_wire: str = "f32",
    top_k: int = 0,
):
    """One continuous-batching decode iteration over the full slot
    array, with the fused sampling tail.  Idle slots (``lengths == 0``)
    write into the null page and read zeros.

    Returns ``(logits (B, V) f32, next_tokens (B,) int64, finite (B,)
    bool, kv_pages)`` — ``finite[b]`` screens slot ``b``'s logits row."""
    _check_wire(kv_wire)
    logits = _decode_step(cfg, _view(weights), kv_pages, tokens, lengths,
                          page_tables, page_size=page_size, kv_wire=kv_wire)
    next_tokens = _next_tokens(logits, temps, keys, top_k)
    finite = torch.isfinite(logits).all(dim=-1)
    return logits, next_tokens, finite, kv_pages

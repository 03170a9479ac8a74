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
``remat=True`` checkpoints each block (non-reentrant
``torch.utils.checkpoint``) under ``remat_policy``: ``"full"``
recomputes the whole block in the backward, ``"dots"`` saves the
products' outputs and ``"sums"`` the tagged QKV, first MLP product and
residual sums (:mod:`apex_tpu_torch.transformer.pipeline_parallel.
schedules`).  :func:`gpt_lm_loss` is the
next-token cross entropy through the tied embedding.  The serving bodies
(:mod:`apex_tpu_torch.serve.model`) drive the same block functions.

Tensor and sequence parallelism follow the reference's sites: ``qkv``
and ``fc1`` are :class:`ColumnParallelLinear`, ``out`` and ``fc2``
:class:`RowParallelLinear` (heads and the MLP's columns sharded over
tp), ``word_embeddings`` a :class:`VocabParallelEmbedding`, and the
tied logits are this rank's vocab slice, fed to the vocab-parallel
cross entropy.  With ``sequence_parallel`` the activations between the
tp regions are the rank's ``S / tp`` rows (the LayerNorms run on them,
K1/K2 at ``S * B / tp`` rows), the LayerNorm affines, the Row biases and
the position table register as sequence-parallel, and the final hidden
states are gathered before the logits.  Build the model after
``parallel_state.initialize_model_parallel``; its weights are the tp = 1
model's from the same generator, split.  At tp = 1 every layer is the
dense layer, bit for bit.

Context parallelism (``context_parallel="ring"``, ``"ring_zigzag"`` or
``"ulysses"``, :mod:`apex_tpu_torch.transformer.context_parallel`): the
token inputs are the cp rank's ``S / cp`` rows (contiguous, or the
zigzag pair of chunks), RoPE and the position table read the global
positions of those rows, each block's attention is the ring or the
all-to-all, and :func:`gpt_lm_loss_cp` is the loss (the next-token
targets cross the shard edges).  Gradients are mean-reduced over cp,
as over a data axis.  Experts (``num_experts > 0``): each block's MLP is
a :class:`~apex_tpu_torch.transformer.moe.SwitchMoe` (``moe`` in the
block: ``router``, ``expert_w1``, ``expert_w2``, the experts this
rank's dp shard), and the losses add ``moe_aux_coef`` times the mean
over the layers of their aux losses (the reference's one stacked leaf
of sown values).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine
from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb_cached
from apex_tpu_torch.parallel import comm
from apex_tpu_torch.transformer import context_parallel as cpl
from apex_tpu_torch.transformer.moe import MoeConfig, SwitchMoe
from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication \
    as p2p
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    checkpoint_name,
    remat,
    resolve_remat_policy,
)
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
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
    "gpt_lm_loss_cp",
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
    ``bias`` (f32); ``sequence_parallel`` registers both as
    sequence-parallel (the LayerNorm runs inside the sequence-sharded
    region)."""

    def __init__(self, size: int, device=None,
                 sequence_parallel: bool = False):
        super().__init__()
        self.scale = nn.Parameter(
            torch.ones(size, dtype=torch.float32, device=device)
        )
        self.bias = nn.Parameter(
            torch.zeros(size, dtype=torch.float32, device=device)
        )
        if sequence_parallel:
            ps.register_sequence_parallel_param(self.scale)
            ps.register_sequence_parallel_param(self.bias)


def _tp_world() -> int:
    return ps.axis_size(ps.TENSOR_PARALLEL_AXIS)


_CP = ps.CONTEXT_PARALLEL_AXIS


def _cp_world(cfg: GptConfig) -> int:
    """The cp size when context parallelism is configured, else 1."""
    return ps.axis_size(_CP) if cfg.context_parallel else 1


def _cp_shard_rows(table, cfg: GptConfig, s_local: int):
    """This cp rank's ``s_local`` rows of a GLOBAL per-position table
    (RoPE cos/sin, learned positions): rows ``[rank·s_local, ...)``, or
    under ``"ring_zigzag"`` global chunks ``rank`` and ``2cp−1−rank``
    of the global sequence (the table is trimmed to it first)."""
    rank = ps.axis_rank(_CP)
    if cfg.context_parallel == "ring_zigzag":
        cp = ps.axis_size(_CP)
        return cpl.zigzag_shard(table[: cp * s_local], rank, cp, axis=0)
    return table[rank * s_local:(rank + 1) * s_local]


def _project(x, lin, dtype, name: Optional[str] = None):
    """A tensor-parallel layer's forward, or :func:`apply_linear` of the
    weights of a serving view (a namespace with ``weight`` and
    ``bias``): the same arithmetic at tp = 1."""
    if isinstance(lin, nn.Module):
        return lin(x, name)
    return apply_linear(x, lin, dtype, name)


# ---------------------------------------------------------------------------
# functional layers (numerics of the JAX stack at tp=1)
# ---------------------------------------------------------------------------


def apply_layer_norm(x, ln: LayerNorm, eps: float):
    """Fused LayerNorm (K1 forward, K2 backward on the card)."""
    return fused_layer_norm_affine(x, ln.scale, ln.bias, (x.shape[-1],),
                                   eps=eps)


def apply_linear(x, lin: nn.Linear, dtype, name: Optional[str] = None):
    """Compute-dtype matmul (f32 accumulation inside), cast back, bias
    added in the compute dtype (Column/RowParallelLinear at tp=1).  The
    result carries the checkpoint tag ``name`` (:func:`checkpoint_name`;
    the bias add is the tagged op)."""
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    bias = lin.bias.to(dtype)
    with checkpoint_name(name):
        return y + bias


def embed_tokens(model: "GptModel", ids, dtype):
    """Lookup on the stored table, then the cast (VocabParallelEmbedding
    at tp=1)."""
    return F.embedding(ids.long(), model.word_embeddings.weight).to(dtype)


def apply_mlp(x, blk: "GptBlock", cfg: GptConfig):
    """x + fc2(gelu_tanh(fc1(LN(x))))."""
    y = apply_layer_norm(x, blk.ln_mlp, cfg.layer_norm_eps)
    y = _project(y, blk.fc1, cfg.dtype, "gpt_fc1")
    y = F.gelu(y, approximate="tanh")
    y = _project(y, blk.fc2, cfg.dtype)
    with checkpoint_name("gpt_sum_mlp"):
        return x + y


def _attention(cfg: GptConfig, q, k, v):
    """Causal attention of the block: flash attention (K3/K4), or under
    context parallelism the ring (contiguous or zigzag) or Ulysses."""
    scale = cfg.head_dim ** -0.5
    if _cp_world(cfg) == 1:
        return flash_attention(q, k, v, causal=True, scale=scale)
    if cfg.context_parallel == "ulysses":
        return cpl.ulysses_attention(q, k, v, causal=True, scale=scale)
    return cpl.ring_attention(
        q, k, v, causal=True, scale=scale,
        layout="zigzag" if cfg.context_parallel == "ring_zigzag"
        else "contiguous")


def apply_block(cfg: GptConfig, blk: "GptBlock", x, cos, sin):
    """One decoder block over ``x`` (S, B, hidden), the JAX ``GptBlock``:
    x + attn(LN(x)), then x + mlp(LN(x)).  Returns the new hidden and
    this layer's rotated K and V as (B, H, S, D) (the serving prefill
    writes them into its cache).  Under sequence parallelism ``x`` is
    the rank's (S / tp, B, hidden) rows; the heads are the rank's
    ``num_heads / tp``."""
    return _block(cfg, blk, x, cos, sin)[:3]


def _block(cfg: GptConfig, blk: "GptBlock", x, cos, sin):
    """:func:`apply_block` and the block's MoE aux loss (None for a
    dense MLP): ``(x, k, v, aux)``."""
    head_dim = cfg.head_dim
    y = apply_layer_norm(x, blk.ln_attn, cfg.layer_norm_eps)
    qkv = _project(y, blk.qkv, cfg.dtype, "gpt_qkv")
    s, b = qkv.shape[0], qkv.shape[1]
    heads = qkv.shape[2] // (3 * head_dim)
    # per-head-interleaved (heads, 3, head_dim) column layout
    qkv = qkv.reshape(s, b, heads, 3, head_dim)
    q, k, v = (qkv[:, :, :, i].permute(1, 2, 0, 3) for i in range(3))
    if cfg.rotary:
        q = fused_apply_rotary_pos_emb_cached(q, cos, sin)
        k = fused_apply_rotary_pos_emb_cached(k, cos, sin)
    ctx = _attention(cfg, q, k, v)
    ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, heads * head_dim)
    attn = _project(ctx, blk.out, cfg.dtype)
    with checkpoint_name("gpt_sum_attn"):
        x = x + attn
    moe = getattr(blk, "moe", None)  # a serving view has no experts
    if moe is None:
        return apply_mlp(x, blk, cfg), k, v, None
    y, aux = moe(apply_layer_norm(x, blk.ln_mlp, cfg.layer_norm_eps))
    with checkpoint_name("gpt_sum_mlp"):
        return x + y, k, v, aux


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
    """Vocab logits (..., V / tp) in f32 through the tied embedding (this
    rank's vocab rows), with compute-dtype operands."""
    return vocab_logits(h.to(dtype), model.word_embeddings.weight.to(dtype))


class GptBlock(nn.Module):
    """One pre-LN decoder block's f32 weights and its forward.  The fused
    ``qkv`` output columns are ordered ``(heads, 3, head_dim)`` as in the
    JAX block."""

    def __init__(self, cfg: GptConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        sp = cfg.sequence_parallel
        self.cfg = cfg
        self.ln_attn = LayerNorm(h, device, sequence_parallel=sp)
        self.qkv = ColumnParallelLinear(
            h, 3 * h, sequence_parallel_enabled=sp, dtype=cfg.dtype,
            device=device)
        self.out = RowParallelLinear(
            h, h, input_is_parallel=True, sequence_parallel_enabled=sp,
            dtype=cfg.dtype, device=device)
        self.ln_mlp = LayerNorm(h, device, sequence_parallel=sp)
        self.moe = None
        if cfg.num_experts:
            # routes this rank's (under SP: S / tp) tokens; the experts
            # shard over dp and are replicated over tp
            self.moe = SwitchMoe(MoeConfig(
                hidden_size=h, ffn_hidden_size=cfg.intermediate_size,
                num_experts=cfg.num_experts, top_k=cfg.moe_top_k,
                capacity_factor=cfg.moe_capacity_factor, dtype=cfg.dtype,
                sequence_parallel=sp,
                context_parallel=bool(cfg.context_parallel)),
                device=device)
            return
        self.fc1 = ColumnParallelLinear(
            h, cfg.intermediate_size, sequence_parallel_enabled=sp,
            dtype=cfg.dtype, device=device)
        self.fc2 = RowParallelLinear(
            cfg.intermediate_size, h, input_is_parallel=True,
            sequence_parallel_enabled=sp, dtype=cfg.dtype, device=device)

    def forward(self, x, cos=None, sin=None):
        return self.forward_with_aux(x, cos, sin)[0]

    def forward_with_aux(self, x, cos=None, sin=None):
        """``(hidden, aux)``: the block's output and its MoE aux loss
        (None for a dense MLP)."""
        out = _block(self.cfg, self, x, cos, sin)
        return out[0], out[3]


class GptModel(nn.Module):
    """Embedding + ``num_layers`` blocks + final LN, on ``device`` (the
    card by default; ``device="cpu"`` for the plain versions), holding
    this rank's tensor-parallel shards.

    The weights are drawn from ``generator`` (a fresh one seeded with 0
    when None), each at its full shape and then cut to the rank's shard:
    embeddings N(0, 0.02), matmul weights N(0, 1/fan_in) (flax's
    lecun-normal scale), biases 0, LayerNorm scale 1 and bias 0.
    """

    def __init__(self, cfg: GptConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        sp = cfg.sequence_parallel
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, sequence_parallel_enabled=sp,
            dtype=cfg.dtype, device=dev)
        if not cfg.rotary:
            self.position_embeddings = nn.Parameter(torch.empty(
                cfg.max_seq_len, cfg.hidden_size, dtype=torch.float32,
                device=dev,
            ))
            if sp and _tp_world() > 1:
                ps.register_sequence_parallel_param(self.position_embeddings)
        self.layers = nn.ModuleList(
            GptBlock(cfg, dev) for _ in range(cfg.num_layers)
        )
        self.ln_f = LayerNorm(cfg.hidden_size, dev, sequence_parallel=sp)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.ln_f.scale.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init, drawn at full shape on the generator's device in
        f32 (the same draws at every tp degree), then cut to the shard."""
        def normal(shape, std):
            return torch.randn(shape, generator=generator,
                               dtype=torch.float32,
                               device=generator.device) * std

        cfg = self.cfg
        self.word_embeddings.load_full_(
            normal((cfg.vocab_size, cfg.hidden_size), 0.02))
        if not self.cfg.rotary:
            self.position_embeddings.copy_(
                normal(self.position_embeddings.shape, 0.02))
        for blk in self.layers:
            lins = (blk.qkv, blk.out) if blk.moe is not None else (
                blk.qkv, blk.out, blk.fc1, blk.fc2)
            for lin in lins:
                lin.load_full_(normal((lin.output_size, lin.input_size),
                                      lin.input_size ** -0.5))
                lin.bias.zero_()
            if blk.moe is not None:
                blk.moe.reset_parameters(generator)
            for ln in (blk.ln_attn, blk.ln_mlp):
                ln.scale.fill_(1.0)
                ln.bias.zero_()
        self.ln_f.scale.fill_(1.0)
        self.ln_f.bias.zero_()

    def forward(self, input_ids):
        """Hidden states (S, B, hidden) in ``cfg.dtype`` after the final
        LayerNorm, for token ids (S, B) (under sequence parallelism the
        rows are gathered back to the full sequence; under context
        parallelism ``input_ids`` and the output are the cp rank's
        rows)."""
        return self.forward_with_aux(input_ids)[0]

    def forward_with_aux(self, input_ids):
        """``(hidden, auxes)``: :meth:`forward` and each layer's MoE aux
        loss (an empty list for a dense model)."""
        cfg = self.cfg
        s = input_ids.shape[0]
        sp = cfg.sequence_parallel and _tp_world() > 1
        cp = _cp_world(cfg)
        x = self.word_embeddings(input_ids)  # (S / tp, B, h) under SP
        cos = sin = None
        if cfg.rotary:
            # under cp, s is the rank's rows: RoPE at their global
            # positions
            cos, sin = rope_cos_sin(s * cp, cfg.head_dim, device=x.device)
            if cp > 1:
                cos, sin = (_cp_shard_rows(t, cfg, s) for t in (cos, sin))
        else:
            if cp * s > cfg.max_seq_len:
                raise ValueError(
                    f"sequence of {cp * s} exceeds max_seq_len "
                    f"{cfg.max_seq_len}"
                )
            if cp > 1:
                rows = _cp_shard_rows(self.position_embeddings, cfg, s)
            else:
                start = ps.axis_rank(ps.TENSOR_PARALLEL_AXIS) * x.shape[0] \
                    if sp else 0
                rows = self.position_embeddings[start:start + x.shape[0]]
            x = x + rows[:, None, :].to(cfg.dtype)
        policy = resolve_remat_policy(cfg.remat_policy)
        auxes = []
        for blk in self.layers:
            if cfg.remat:
                x, aux = remat(blk.forward_with_aux, x, cos, sin,
                               policy=policy)
            else:
                x, aux = blk.forward_with_aux(x, cos, sin)
            if aux is not None:
                auxes.append(aux)
        x = apply_layer_norm(x, self.ln_f, cfg.layer_norm_eps)
        if sp:
            x = gather_from_sequence_parallel_region(x)
        return x, auxes


def _apply_with_moe_aux(model: GptModel, input_ids):
    """``(h, aux_total)``: the forward and ``moe_aux_coef`` times the
    mean over the layers of their aux losses (0.0 for a dense model)."""
    h, auxes = model.forward_with_aux(input_ids)
    if not auxes:
        return h, 0.0
    return h, model.cfg.moe_aux_coef * torch.stack(auxes).mean()


def gpt_lm_loss(model: GptModel, input_ids):
    """Next-token cross entropy through the tied embedding: f32 logits
    of every position, then the mean over positions 0..S-2 of the loss
    of predicting token t+1, plus the MoE aux term
    (:func:`_apply_with_moe_aux`).  ``input_ids`` is (S, B), the same on
    every tp rank.  At tp > 1 the logits are the rank's vocab slice:
    without sequence parallelism the hidden states enter through
    ``copy_to`` (the logits' partial cotangents summed in the backward);
    under it the final gather's reduce-scatter sums them."""
    if _cp_world(model.cfg) > 1:
        raise ValueError(
            "the sequence is context-parallel sharded: use gpt_lm_loss_cp "
            "(the next-token shift crosses cp shard boundaries)"
        )
    h, aux_total = _apply_with_moe_aux(model, input_ids)
    if not model.cfg.sequence_parallel and _tp_world() > 1:
        h = copy_to_tensor_model_parallel_region(h)
    logits = tied_logits(model, h, model.cfg.dtype)
    losses = vocab_parallel_cross_entropy(logits[:-1], input_ids[1:])
    return losses.mean() + aux_total


def gpt_lm_loss_cp(model: GptModel, input_ids_local, *,
                   axis_name: str = _CP):
    """Next-token cross entropy of a context-parallel sequence.

    ``input_ids_local`` (S_local, B) is this cp rank's shard in the
    model's layout: contiguous for ``"ring"``/``"ulysses"``, the zigzag
    pair for ``"ring_zigzag"``.  The targets across the shard edges come
    from the neighbours by the pipeline's shift (cyclic); the global last
    position has no target and is masked (the last rank's last row, or
    under zigzag rank 0's).  Returns the mean over the global tokens,
    the same on every cp rank, plus the MoE aux term.  Mean-reduce the
    gradients over cp (beside dp) before the step: the result is the
    unsharded :func:`gpt_lm_loss`'s gradient."""
    h, aux_total = _apply_with_moe_aux(model, input_ids_local)
    # no SP under cp, so the copy_to boundary always applies at tp > 1
    if _tp_world() > 1:
        h = copy_to_tensor_model_parallel_region(h)
    logits = tied_logits(model, h, model.cfg.dtype)
    world, rank = ps.axis_size(axis_name), ps.axis_rank(axis_name)
    ids = input_ids_local
    valid = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    if model.cfg.context_parallel == "ring_zigzag":
        # rows = [chunk rank; chunk 2cp−1−rank].  Chunk r's last row
        # predicts chunk r+1's first token: rank r+1's lo first, except
        # chunk cp−1, whose successor (chunk cp) is this rank's own hi
        # first.  Chunk 2cp−1−r's last row predicts chunk 2cp−r's first
        # token, rank r−1's hi first; rank 0's hi chunk ends the sequence
        sc = ids.shape[0] // 2
        lo, hi = ids[:sc], ids[sc:]
        lo_first_next = p2p.send_backward_recv_backward(
            lo[:1].contiguous(), axis_name, cyclic=True)
        lo_boundary = hi[:1] if rank == world - 1 else lo_first_next
        hi_boundary = p2p.send_forward_recv_forward(
            hi[:1].contiguous(), axis_name, cyclic=True)
        targets = torch.cat([lo[1:], lo_boundary, hi[1:], hi_boundary])
        if rank == 0:
            valid[-1] = 0.0
    else:
        # the last row's target is the next rank's first token
        first_next = p2p.send_backward_recv_backward(
            ids[:1].contiguous(), axis_name, cyclic=True)
        targets = torch.cat([ids[1:], first_next])
        if rank == world - 1:
            valid[-1] = 0.0
    losses = vocab_parallel_cross_entropy(logits, targets)  # (S_local, B)
    local_sum = (losses * valid).sum()
    count = comm.all_reduce(valid.sum(), ps.get_group(axis_name))
    # psum whose backward sums too: a rank's gradient is cp times its
    # share, and the cp mean of the gradients is the whole sequence's
    return comm.psum(local_sum, axis_name) / count + aux_total

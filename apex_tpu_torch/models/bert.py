"""BERT — the encoder of BERT-Large pretraining, its heads and its loss.

Counterpart of ``apex_tpu/models/bert.py``: Megatron's seq-first layout
``(S, B, hidden)``, post-LN blocks (original BERT's residual order),
GELU (tanh), the ``(B, 1, 1, S)`` additive key-padding mask at -1e9,
the NSP pooler on position 0, the MLM
transform (dense, GELU, LayerNorm) and the MLM decoder tied to the word
embedding, with f32 logits plus ``mlm_bias``.

:class:`BertConfig` keeps the JAX dataclass's fields and defaults (with
a torch dtype).  Every parameter is stored in f32 and cast to
``cfg.dtype`` where the JAX layers cast it (``apply_linear``,
``apply_layer_norm`` of :mod:`.gpt`).  The modules carry the flax tree's
names: ``bert.embeddings.{word_embeddings, position_embeddings,
token_type_embeddings, ln}``, ``bert.encoder.layers.<i>.{attention.qkv,
attention.out, ln_attn, mlp.fc1, mlp.fc2, ln_mlp}``, then ``pooler``,
``nsp_head``, ``mlm_dense``, ``mlm_ln`` and ``mlm_bias``; :mod:`.convert`
maps both JAX layouts (scanned and unrolled) onto them.

On the card every LayerNorm runs through K1/K2 and every attention
through K3/K4 with the padding mask as their bias operand (G = B, RS =
1).  :class:`BertEncoderCore` is the stack of blocks.  ``remat=True``
checkpoints each block (non-reentrant ``torch.utils.checkpoint``) under
``remat_policy`` (``"full"``, ``"dots"`` or ``"sums"``,
:mod:`apex_tpu_torch.transformer.pipeline_parallel.schedules`);
``remat_attention=True`` recomputes the attention core in the backward
whatever the policy: an inner checkpoint that saves nothing, needed only
without ``remat`` (a checkpointed block recomputes the core anyway).

Dropout (``deterministic=False``) takes a CPU ``torch.Generator``.
Before each block the model draws that block's seeds on the host — the
attention seed, written to the device as the int32 tensor K3/K4 read,
and the seed of the block's own generator for its two hidden dropouts —
and passes them in, so a recomputed block draws the same masks (the
checkpoint restores no explicit generator) and the draws wait for
nothing on the card.  The same generator state gives the same attention
masks on the card and on the CPU; the hidden masks come from each
device's own generator.

Tensor and sequence parallelism follow the reference's sites, as in
:mod:`.gpt`: ``qkv``/``fc1`` column-parallel, ``out``/``fc2``
row-parallel, the word embedding vocab-parallel, and the tied decoder
this rank's vocab slice plus its slice of ``mlm_bias``, fed to the
vocab-parallel cross entropy.  Under ``sequence_parallel`` the
embeddings, LayerNorms, dropouts and the MLM transform run on the rank's
``S / tp`` rows (their parameters registered as sequence-parallel); the
pooler reads a gather whose backward splits (it is replicated
computation) and the decoder a gather whose backward reduce-scatters.
A dropout mask over rank-local values (tp-sharded heads; sequence shards
under SP) takes its seed folded with the tp rank
(:func:`_per_rank_dropout_rng`); replicated values keep the shared seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.amp.lists import carry_policy
from apex_tpu_torch.models.gpt import (
    LayerNorm,
    _tp_world,
    apply_layer_norm,
    apply_linear,
    vocab_logits,
)
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.attention import MASK_VALUE, flash_attention
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    SUMS_SAVE_NAMES,
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
from apex_tpu_torch.transformer.tensor_parallel.random import to_per_rank_key

__all__ = [
    "BertConfig",
    "BertEmbeddings",
    "BertEncoderCore",
    "BertForPreTraining",
    "BertLayer",
    "BertMlp",
    "BertModel",
    "BertSelfAttention",
    "bert_large_config",
    "bert_pretrain_loss",
    "SUMS_SAVE_NAMES",
]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    sequence_parallel: bool = False
    remat: bool = False
    remat_policy: str = "full"
    # recompute the attention core (scores, softmax, PV) in the backward
    # whatever remat_policy saves: an inner checkpoint that saves nothing
    remat_attention: bool = False
    # the reference's prevent_cse of the per-layer checkpoint (None =
    # auto).  Eager PyTorch has no common-subexpression elimination that
    # could merge the recompute with the forward, so it has no effect
    # here; it is validated and kept for the configs' sake
    remat_prevent_cse: Optional[bool] = None
    # the layout of the JAX tree that ``convert.bert_to_jax_params``
    # writes by default (scanned, as the JAX default)
    scan_layers: bool = True

    def __post_init__(self):
        if self.remat_policy not in ("full", "dots", "sums"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r} "
                "(options are 'full', 'dots', 'sums')"
            )
        if self.remat_prevent_cse not in (None, True, False):
            raise ValueError(
                f"remat_prevent_cse must be None or a bool, got "
                f"{self.remat_prevent_cse!r}"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def bert_large_config(**overrides) -> BertConfig:
    """BERT-Large (336 M parameters), the north-star shape."""
    return BertConfig(**overrides)


def _linear(n_in: int, n_out: int, device) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=True, dtype=torch.float32,
                     device=device)


def _per_rank_dropout_rng(seed, rank_local: bool):
    """A dropout seed, folded with the tp rank when the masked values are
    rank-local (a sequence shard, or tp-sharded heads) — ≙ Megatron's
    model-parallel RNG stream; replicated values need the same mask on
    every rank, so ``rank_local=False`` keeps the shared seed."""
    if rank_local and _tp_world() > 1:
        return to_per_rank_key(seed)
    return seed


def _hidden_dropout(x, p: float, generator: torch.Generator):
    """``nn.Dropout``: keep with probability 1 - p, scale by 1/(1 - p)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class BertSelfAttention(nn.Module):
    """The fused (heads, 3, head_dim) QKV projection, attention through
    the flash kernels and the output projection."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        sp = cfg.sequence_parallel
        self.qkv = ColumnParallelLinear(h, 3 * h, sequence_parallel_enabled=sp,
                                        dtype=cfg.dtype, device=device)
        self.out = RowParallelLinear(h, h, input_is_parallel=True,
                                     sequence_parallel_enabled=sp,
                                     dtype=cfg.dtype, device=device)

    def forward(self, x, attention_bias=None,
                dropout_seed: Optional[torch.Tensor] = None):
        cfg = self.cfg
        qkv = self.qkv(x, "bert_qkv")
        s, b = qkv.shape[0], qkv.shape[1]  # the full sequence under SP
        heads = qkv.shape[2] // (3 * cfg.head_dim)
        qkv = qkv.reshape(s, b, heads, 3, cfg.head_dim)
        q, k, v = (qkv[:, :, :, i].permute(1, 2, 0, 3) for i in range(3))
        p = cfg.attention_dropout if dropout_seed is not None else 0.0

        def core(q, k, v, bias, seed):
            return flash_attention(q, k, v, bias, scale=cfg.head_dim ** -0.5,
                                   dropout_p=p, dropout_seed=seed)

        if cfg.remat_attention and not cfg.remat:
            # under the block's own checkpoint the core is recomputed
            # whatever the policy (K3 is invisible to it), so only a
            # block without one needs this.  The seed is an explicit
            # operand: the recompute draws the same keep mask
            ctx = checkpoint(carry_policy(core), q, k, v, attention_bias,
                             dropout_seed,
                             use_reentrant=False, preserve_rng_state=False)
        else:
            ctx = core(q, k, v, attention_bias, dropout_seed)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, heads * cfg.head_dim)
        return self.out(ctx)


class BertMlp(nn.Module):
    """fc1 (hidden -> intermediate), GELU (tanh), fc2."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        sp = cfg.sequence_parallel
        self.fc1 = ColumnParallelLinear(
            cfg.hidden_size, cfg.intermediate_size,
            sequence_parallel_enabled=sp, dtype=cfg.dtype, device=device)
        self.fc2 = RowParallelLinear(
            cfg.intermediate_size, cfg.hidden_size, input_is_parallel=True,
            sequence_parallel_enabled=sp, dtype=cfg.dtype, device=device)

    def forward(self, x):
        y = F.gelu(self.fc1(x, "bert_fc1"), approximate="tanh")
        return self.fc2(y)


class BertLayer(nn.Module):
    """Post-LN block: x = LN(x + attn(x)), then LN(x + mlp(x)), with
    hidden dropout on both branches when ``hidden_seed`` is given."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        sp = cfg.sequence_parallel
        self.attention = BertSelfAttention(cfg, device)
        self.ln_attn = LayerNorm(h, device, sequence_parallel=sp)
        self.mlp = BertMlp(cfg, device)
        self.ln_mlp = LayerNorm(h, device, sequence_parallel=sp)

    def forward(self, x, attention_bias=None,
                attention_seed: Optional[torch.Tensor] = None,
                hidden_seed: Optional[int] = None):
        cfg = self.cfg
        gen = None
        if hidden_seed is not None and cfg.hidden_dropout > 0.0:
            # sequence shards under SP (rank-local), else replicated
            seed = _per_rank_dropout_rng(hidden_seed, cfg.sequence_parallel)
            gen = torch.Generator(device=x.device).manual_seed(seed)
        attn = self.attention(x, attention_bias, attention_seed)
        if gen is not None:
            attn = _hidden_dropout(attn, cfg.hidden_dropout, gen)
        with checkpoint_name("bert_sum_attn"):
            x = x + attn
        x = apply_layer_norm(x, self.ln_attn, cfg.layer_norm_eps)
        mlp = self.mlp(x)
        if gen is not None:
            mlp = _hidden_dropout(mlp, cfg.hidden_dropout, gen)
        with checkpoint_name("bert_sum_mlp"):
            x = x + mlp
        return apply_layer_norm(x, self.ln_mlp, cfg.layer_norm_eps)


class _TypeEmbedding(torch.autograd.Function):
    """``F.embedding`` of the token types, with a backward that sums the
    output gradient over the tokens of each type (one reduction per row
    of the table) instead of CUDA's ``embedding_dense_backward``: with
    every token of a batch in one of two rows, that backward's sum came
    out different in the last bits between two identical runs on an H100
    (3.7e-9 in ``token_type_embeddings`` after 8 BERT-Large steps,
    ``chip_smoke.py`` phase 14), so a resumed run could not equal an
    uninterrupted one bit for bit.  The reductions run in a fixed order."""

    @staticmethod
    def forward(ctx, ids, table):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        flat = ids.reshape(-1, 1)
        return None, torch.stack([torch.where(flat == k, g, 0.0).sum(0)
                                  for k in range(ctx.rows)])


class BertEmbeddings(nn.Module):
    """Word (f32 table, looked up then cast), learned position and token
    type embeddings (:class:`_TypeEmbedding`), LayerNorm."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        sp = cfg.sequence_parallel
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, h, sequence_parallel_enabled=sp, dtype=cfg.dtype,
            device=device)
        self.position_embeddings = nn.Parameter(torch.empty(
            cfg.max_position_embeddings, h, dtype=torch.float32,
            device=device))
        if cfg.type_vocab_size:
            self.token_type_embeddings = nn.Parameter(torch.empty(
                cfg.type_vocab_size, h, dtype=torch.float32, device=device))
        if sp and _tp_world() > 1:
            ps.register_sequence_parallel_param(self.position_embeddings)
            if cfg.type_vocab_size:
                ps.register_sequence_parallel_param(
                    self.token_type_embeddings)
        self.ln = LayerNorm(h, device, sequence_parallel=sp)

    def forward(self, input_ids, token_type_ids=None):
        """The (S, B, hidden) embeddings (the rank's (S / tp, B, hidden)
        rows under sequence parallelism)."""
        cfg = self.cfg
        s = input_ids.shape[0]
        if s > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence of {s} exceeds max_position_embeddings "
                f"({cfg.max_position_embeddings})"
            )
        x = self.word_embeddings(input_ids)
        local_s = x.shape[0]
        start = 0
        if cfg.sequence_parallel and _tp_world() > 1:
            start = ps.axis_rank(ps.TENSOR_PARALLEL_AXIS) * local_s
        rows = self.position_embeddings[start:start + local_s]
        x = x + rows[:, None, :].to(cfg.dtype)
        if cfg.type_vocab_size:
            tt = (torch.zeros_like(input_ids) if token_type_ids is None
                  else token_type_ids)[start:start + local_s]
            x = x + _TypeEmbedding.apply(
                tt.long(), self.token_type_embeddings).to(cfg.dtype)
        return apply_layer_norm(x, self.ln, cfg.layer_norm_eps)


def _draw_seeds(generator: Optional[torch.Generator], n: int):
    """``n`` host integers from the CPU ``generator`` (int32 range)."""
    if generator is None or generator.device.type != "cpu":
        raise ValueError(
            "deterministic=False takes a CPU torch.Generator: the dropout "
            "seeds are drawn on the host"
        )
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,),
                         generator=generator).tolist()  # lint: allow(host-sync): CPU


def _dropout_on(cfg: BertConfig, deterministic: bool) -> bool:
    return not deterministic and (cfg.hidden_dropout > 0.0
                                  or cfg.attention_dropout > 0.0)


class BertEncoderCore(nn.Module):
    """A stack of ``num_layers`` :class:`BertLayer`s (the whole encoder,
    or a pipeline stage of one), each checkpointed under ``cfg.remat``
    and ``cfg.remat_policy``.  Returns the (S, B, hidden) output."""

    def __init__(self, cfg: BertConfig, num_layers: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(BertLayer(cfg, device)
                                    for _ in range(num_layers))

    def forward(self, x, attention_bias=None, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                layer_seeds=None):
        """``deterministic=False`` draws two seeds a layer from the CPU
        ``generator`` before the stack (or takes them as ``layer_seeds``):
        the attention's keep-mask seed, written to the device as the
        int32 tensor K3/K4 read, and the seed of the block's own
        generator for its hidden dropouts.  So a recomputed block draws
        the same masks, and the draws wait for nothing on the card."""
        cfg = self.cfg
        n = len(self.layers)
        dropout = _dropout_on(cfg, deterministic)
        if dropout and layer_seeds is None:
            layer_seeds = _draw_seeds(generator, 2 * n)
        policy = resolve_remat_policy(cfg.remat_policy)
        for i, layer in enumerate(self.layers):
            attn_seed = hidden_seed = None
            if dropout:
                # the heads are tp-sharded: each rank needs its own mask
                attn_seed = torch.full(
                    (1,), _per_rank_dropout_rng(layer_seeds[2 * i], True),
                    dtype=torch.int32, device=x.device)
                hidden_seed = layer_seeds[2 * i + 1]
            if cfg.remat:
                # the block's randomness comes in through its seeds, so
                # the checkpoint has no RNG state to stash
                x = remat(layer, x, attention_bias, attn_seed, hidden_seed,
                          policy=policy, preserve_rng_state=False)
            else:
                x = layer(x, attention_bias, attn_seed, hidden_seed)
        return x


class BertModel(nn.Module):
    """Embeddings + the encoder; returns the (S, B, hidden) sequence
    output in ``cfg.dtype``."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, device)
        self.encoder = BertEncoderCore(cfg, cfg.num_layers, device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        bias = None
        if attention_mask is not None:
            # (B, S), 1 = keep -> the additive (B, 1, 1, S) mask
            keep = attention_mask.bool()[:, None, None, :]
            bias = torch.where(keep, 0.0, MASK_VALUE).to(torch.float32)
        x = self.embeddings(input_ids, token_type_ids)
        dropout = _dropout_on(cfg, deterministic)
        seeds = _draw_seeds(generator, 1 + 2 * cfg.num_layers) if dropout \
            else None
        if dropout and cfg.hidden_dropout > 0.0:
            seed = _per_rank_dropout_rng(seeds[0], cfg.sequence_parallel)
            gen = torch.Generator(device=x.device).manual_seed(seed)
            x = _hidden_dropout(x, cfg.hidden_dropout, gen)
        return self.encoder(x, bias, deterministic=deterministic,
                            layer_seeds=seeds[1:] if dropout else None)


class BertForPreTraining(nn.Module):
    """BERT + the NSP pooler and head + the MLM transform, on ``device``
    (the card by default; ``device="cpu"`` for the plain versions).
    ``forward`` returns ``((mlm_hidden, mlm_bias), nsp_logits)``; the
    tied decoder runs in :func:`bert_pretrain_loss`.

    The weights are drawn from ``generator`` (a fresh one seeded with 0
    when None): embeddings N(0, 0.02), matmul weights N(0, 1/fan_in)
    (flax's lecun-normal scale), biases and ``mlm_bias`` 0, LayerNorm
    scale 1 and bias 0."""

    def __init__(self, cfg: BertConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        h = cfg.hidden_size
        sp = cfg.sequence_parallel and _tp_world() > 1
        self.bert = BertModel(cfg, dev)
        self.pooler = _linear(h, h, dev)
        self.nsp_head = _linear(h, 2, dev)
        self.mlm_dense = _linear(h, h, dev)
        self.mlm_ln = LayerNorm(h, dev, sequence_parallel=sp)
        if sp:
            # the transform runs on the SP rows, between the decoder's
            # gather and its vocab-partial cotangents
            ps.register_sequence_parallel_param(self.mlm_dense.weight)
            ps.register_sequence_parallel_param(self.mlm_dense.bias)
        # this rank's slice of the vocab-sharded decoder bias
        self.mlm_bias = nn.Parameter(torch.zeros(
            ps.divide(cfg.vocab_size, _tp_world()), dtype=torch.float32,
            device=dev))
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.mlm_bias.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init, drawn on the generator's device in f32."""
        def normal_(param, std):
            draw = torch.randn(param.shape, generator=generator,
                               dtype=torch.float32, device=generator.device)
            param.copy_(draw * std)

        emb = self.bert.embeddings
        cfg = self.cfg
        emb.word_embeddings.load_full_(torch.randn(
            (cfg.vocab_size, cfg.hidden_size), generator=generator,
            dtype=torch.float32, device=generator.device) * 0.02)
        normal_(emb.position_embeddings, 0.02)
        if self.cfg.type_vocab_size:
            normal_(emb.token_type_embeddings, 0.02)
        for mod in self.modules():
            if isinstance(mod, (ColumnParallelLinear, RowParallelLinear)):
                # the full weight's draw, cut to the shard
                mod.load_full_(torch.randn(
                    (mod.output_size, mod.input_size), generator=generator,
                    dtype=torch.float32, device=generator.device)
                    * mod.input_size ** -0.5)
                mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                normal_(mod.weight, mod.in_features ** -0.5)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
        self.mlm_bias.zero_()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        seq = self.bert(input_ids, token_type_ids, attention_mask,
                        deterministic=deterministic, generator=generator)
        sp = cfg.sequence_parallel and _tp_world() > 1
        # the pooler is replicated computation: its gather's backward
        # splits (a reduce-scatter would feed the encoder tp x NSP's grad)
        seq_full = (gather_from_sequence_parallel_region(
            seq, tensor_parallel_output_grad=False) if sp else seq)
        pooled = torch.tanh(apply_linear(seq_full[0], self.pooler, cfg.dtype))
        nsp_logits = apply_linear(pooled, self.nsp_head, cfg.dtype)
        h = F.gelu(apply_linear(seq, self.mlm_dense, cfg.dtype),
                   approximate="tanh")
        h = apply_layer_norm(h, self.mlm_ln, cfg.layer_norm_eps)
        if sp:
            h = gather_from_sequence_parallel_region(h)
        return (h, self.mlm_bias), nsp_logits


def bert_pretrain_loss(model: BertForPreTraining, batch, *,
                       deterministic: bool = True,
                       generator: Optional[torch.Generator] = None,
                       mlm_loss_chunks: Optional[int] = None):
    """MLM + NSP loss (the phase-1 pretraining objective), a 0-dim f32
    tensor.

    ``batch`` holds tensors on the model's device: ``input_ids`` and
    ``token_type_ids`` (S, B), ``attention_mask`` (B, S), ``nsp_labels``
    (B,), and either the dense ``mlm_labels`` (S, B; -1 = not predicted)
    or the fixed-K triple ``mlm_positions`` / ``mlm_label_ids`` /
    ``mlm_weights`` (K, B), which the loss prefers: the MLM head then runs
    on the K gathered rows only.  The decoder is the word embedding (f32
    logits from compute-dtype operands) plus ``mlm_bias``; the MLM loss
    is the weighted mean over the predicted positions.
    ``mlm_loss_chunks`` splits the logits and their cross entropy into
    that many row chunks, each recomputed in the backward, so the full
    f32 logits never exist at once."""
    cfg = model.cfg
    (h, mlm_bias), nsp_logits = model(
        batch["input_ids"], batch.get("token_type_ids"),
        batch.get("attention_mask"), deterministic=deterministic,
        generator=generator,
    )
    positions = batch.get("mlm_positions")
    if positions is not None:
        # (S, B, hidden) -> (K, B, hidden); the backward scatter-adds
        idx = positions.long()[:, :, None].expand(-1, -1, h.shape[-1])
        h = torch.gather(h, 0, idx)
        # a hand-built triple may pad ids with -1: clamp as the dense
        # path does (the weight-0 rows then add nothing)
        labels = batch["mlm_label_ids"].clamp_min(0)
        weights = batch["mlm_weights"].float()
    else:
        labels = batch["mlm_labels"]
        weights = (labels >= 0).float()
        labels = labels.clamp_min(0)
    if not cfg.sequence_parallel and _tp_world() > 1:
        # the decoder's cotangent is partial per tp rank (its vocab
        # slice): copy_to sums it in the backward (under SP the MLM
        # gather's reduce-scatter does)
        h = copy_to_tensor_model_parallel_region(h)
    dec = model.bert.embeddings.word_embeddings.weight.to(cfg.dtype)

    def rows_loss(h_rows, dec, l_rows, w_rows):
        logits = vocab_logits(h_rows.to(cfg.dtype), dec) + mlm_bias
        losses = vocab_parallel_cross_entropy(logits, l_rows)
        return (losses * w_rows).sum(), w_rows.sum()

    rows = labels.numel()
    h = h.reshape(rows, h.shape[-1])
    labels, weights = labels.reshape(rows), weights.reshape(rows)
    nc = mlm_loss_chunks or 1
    if nc > 1:
        if rows % nc:
            raise ValueError(
                f"mlm_loss_chunks={nc} must divide the number of MLM "
                f"prediction rows ({rows})"
            )
        total = count = 0.0
        for hc, lc, wc in zip(h.chunk(nc), labels.chunk(nc),
                              weights.chunk(nc)):
            s, c = checkpoint(carry_policy(rows_loss), hc, dec, lc, wc,
                              use_reentrant=False, preserve_rng_state=False)
            total, count = total + s, count + c
    else:
        total, count = rows_loss(h, dec, labels, weights)
    loss = total / torch.clamp(count, min=1.0)

    nsp_labels = batch.get("nsp_labels")
    if nsp_labels is not None:
        logp = torch.log_softmax(nsp_logits.float(), dim=-1)
        loss = loss - logp.gather(-1, nsp_labels.long()[:, None]).mean()
    return loss

"""Speculative decoding — draft proposals, verify, rollback.

Counterpart of ``apex_tpu/serve/spec.py``.  A small **draft** model
proposes ``k`` tokens a round; the target model then scores ``k + 1``
positions, and an acceptance rule keeps a leading run of the proposals
plus one token of its own, so one round emits up to ``k + 1`` tokens.

- :func:`draft_body` — ``k + 1`` draft decode steps: feed the stream's
  last token, then each proposal, so the draft KV cache stays in
  lockstep with the proposals (the extra step writes the last proposal's
  KV; its logits are not sampled).
- :func:`verify_body` — ``k + 1`` steps of
  :func:`apex_tpu_torch.serve.model._decode_step`, the very function the
  plain decode step runs, over the columns ``[t_last, d_1..d_k]`` at
  successive lengths.  Position ``j``'s logits are therefore the bits
  ``j`` sequential decode iterations would have produced, which makes the
  greedy speculative stream equal to plain decode by construction.
- :func:`rollback_body` — zero the KV rows of rejected positions through
  the page table (int8 wire: codes to 0, scales to 1.0), in place.

Each body is a Python loop over PyTorch ops and the kernels the decode
step launches (K1, K6); every KV row is written in place, so the engine
can capture a whole round (draft, verify and acceptance) as one CUDA
graph with the pool at fixed addresses.

**Acceptance** (:func:`speculative_verify`): greedy slots (``temp <=
0``) accept ``d_{j+1}`` iff it equals the argmax of position ``j``'s
logits; temperature slots run the Leviathan et al. rejection sampler
(accept with probability ``min(1, p_j(d) / q_j(d))``, a residual draw
from ``normalize(max(p_j - q_j, 0))`` at the first rejection, a bonus
draw from ``p_k`` when all are accepted), whose emitted tokens follow the
target softmax.  :func:`verify_with_noise` is the same rule with its
noise given as tensors.

**Randomness** is a counter hash (:func:`~apex_tpu_torch.serve.model.
sample_keys`) of the engine's seed, a domain, the request's stream and
the emission index, hashed on the device (a generator's state would
replay the captured draw).  The residual and bonus draws at index ``g``
take plain decode's own key (``DOMAIN_DECODE_STREAM``, stream, ``g``), so
a ``k = 0`` stream equals plain decode, sampled tokens too; the draft's
proposals take :data:`DRAFT_TAG` and the acceptance uniforms
:data:`ACCEPT_TAG` at the same index, so no draw is reused.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
from torch import nn

from apex_tpu_torch.models.gpt import GptConfig, GptModel
from apex_tpu_torch.serve import model as model_lib
from apex_tpu_torch.serve.model import (
    DOMAIN_ACCEPT_STREAM,
    DOMAIN_DECODE_STREAM,
    DOMAIN_DRAFT_STREAM,
)

__all__ = [
    "SpecConfig",
    "DRAFT_TAG",
    "ACCEPT_TAG",
    "target_probs",
    "emission_keys",
    "verify_with_noise",
    "speculative_verify",
    "draft_body",
    "verify_body",
    "rollback_body",
    "draft_from_params",
]

#: key domains of the draft's proposals and of the acceptance uniforms
#: (the reference's ``fold_in`` tags); the residual and bonus draws take
#: plain decode's ``DOMAIN_DECODE_STREAM``
DRAFT_TAG = DOMAIN_DRAFT_STREAM
ACCEPT_TAG = DOMAIN_ACCEPT_STREAM


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs for an
    :class:`~apex_tpu_torch.serve.engine.InferenceEngine`.

    ``mode`` names the intended acceptance regime — ``"greedy"``
    (exact-match, output equal to plain decode) or ``"temperature"``
    (the rejection sampler).  The round dispatches per slot on the
    request temperature either way, so a mixed batch is safe in both.
    """

    #: the draft model (a :class:`~apex_tpu_torch.models.GptModel` on the
    #: engine's device, e.g. :func:`draft_from_params`); None = the target
    #: itself (self-draft: the engine's own weights, greedy acceptance
    #: 100% by definition)
    draft_params: Optional[GptModel]
    #: proposals per round; each round emits up to ``k + 1`` tokens.
    #: ``k = 0`` is plain decode through the verify step
    k: int = 4
    mode: str = "greedy"
    #: the draft's shape; None = the draft model's own config (or the
    #: target's for a self-draft)
    draft_cfg: Optional[GptConfig] = None
    #: once the acceptance rate over the last ``window`` rounds falls
    #: below this, the scheduler falls back to plain decode
    min_accept_rate: float = 0.3
    window: int = 64

    def __post_init__(self):
        if self.k < 0:
            raise ValueError(f"k must be >= 0, got {self.k}")
        if self.mode not in ("greedy", "temperature"):
            raise ValueError(
                f"mode must be greedy|temperature, got {self.mode!r}"
            )
        if not 0.0 <= self.min_accept_rate <= 1.0:
            raise ValueError("min_accept_rate must be within [0, 1]")
        if self.window < 1:
            raise ValueError("window must be >= 1")


def draft_from_params(params, num_layers: int):
    """A draft from the FIRST ``num_layers`` blocks of a target (the
    ``serve_bench --draft-layers N`` draft: same checkpoint, truncated
    depth).

    ``params`` is a :class:`~apex_tpu_torch.models.GptModel`: the draft
    is a ``GptModel`` whose config has ``num_layers`` layers and which
    shares the target's first blocks, embeddings and final LayerNorm
    (the same parameters, no copy).  Or ``params`` is a tree in the JAX
    layout (``{"params": {...}}``, the stack's leaves stacked on a
    leading layer axis — :func:`~apex_tpu_torch.models.gpt_param_tree`
    or a JAX tree as numpy arrays): the draft is that tree with its
    stacked leaves cut to ``num_layers``, which
    :func:`~apex_tpu_torch.models.from_jax_params` carries into the
    same draft model."""
    if num_layers < 1:
        raise ValueError(f"draft needs >= 1 layer, got {num_layers}")
    if isinstance(params, Mapping):
        tree = dict(params["params"])
        tree["layers"] = {"block": {
            name: {leaf: arr[:num_layers] for leaf, arr in sub.items()}
            for name, sub in tree["layers"]["block"].items()
        }}
        return {"params": tree}
    if num_layers > params.cfg.num_layers:
        raise ValueError(
            f"draft of {num_layers} layers from a target of "
            f"{params.cfg.num_layers}"
        )
    draft = GptModel.__new__(GptModel)
    nn.Module.__init__(draft)
    draft.cfg = dataclasses.replace(params.cfg, num_layers=num_layers)
    draft.word_embeddings = params.word_embeddings
    if not params.cfg.rotary:
        draft.position_embeddings = params.position_embeddings
    draft.layers = nn.ModuleList(params.layers[:num_layers])
    draft.ln_f = params.ln_f
    return draft


# ---------------------------------------------------------------------------
# acceptance
# ---------------------------------------------------------------------------


def target_probs(logits, temps, *, top_k: int = 0):
    """The distribution :func:`~apex_tpu_torch.serve.model.sample_tokens`
    draws from: softmax of the top-k-masked logits over the temperature.
    ``logits`` ``(..., V)`` f32, ``temps`` broadcasting over the leading
    dims.  Rows with ``temp <= 0`` are computed at the clamped temperature
    and must not be consumed (greedy acceptance never reads them)."""
    temps = torch.as_tensor(temps, dtype=torch.float32, device=logits.device)
    vocab = logits.shape[-1]
    masked = logits
    if 0 < top_k < vocab:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        masked = logits.masked_fill(logits < kth, float("-inf"))
    scaled = masked / torch.clamp_min(temps, 1e-6)[..., None]
    return torch.softmax(scaled, dim=-1)


def emission_keys(seed: int, domain: int, streams, gens) -> torch.Tensor:
    """Sampling keys ``(B,)`` of the draws at emission index ``gens`` of
    each stream in ``domain``: the plain decode step's key construction
    (``streams`` folded to 31 bits, ``gens`` below 2**31)."""
    words = torch.stack(
        [torch.full_like(streams, domain), streams, gens], dim=1)
    return model_lib.sample_keys(seed, words)


def _residual_sample(p, q, gumbel):
    """Gumbel-argmax draw from ``normalize(max(p - q, 0))`` per row (the
    all-zero residual, where ``p == q`` and no rejection happens, falls
    to token 0)."""
    res = torch.clamp_min(p - q, 0.0)
    logr = torch.where(res > 0, torch.log(torch.clamp_min(res, 1e-38)),
                       torch.full_like(res, float("-inf")))
    return torch.argmax(logr + gumbel, dim=-1)


def verify_with_noise(ver_logits, draft_tokens, draft_probs, temps,
                      uniforms, gumbel, *, top_k: int = 0):
    """The acceptance rule of one round, its noise given.

    - ``ver_logits`` ``(k+1, B, V)`` f32: target logits at positions
      ``j = 0..k``; proposal ``d_{j+1}`` is judged against position
      ``j``;
    - ``draft_tokens`` ``(B, k)``, ``draft_probs`` ``(k, B, V)``: the
      proposals and the draft distributions they were drawn from;
    - ``uniforms`` ``(k, B)`` in (0, 1): the acceptance draws;
    - ``gumbel`` ``(k+1, B, V)``: standard Gumbel noise of the residual
      draw at ``j < k`` and of the bonus draw at ``j = k``.

    Returns ``(out_tokens (B, k+1), n_accept (B,))`` int64: slot ``s``
    emits ``out_tokens[s, :n_accept[s] + 1]``."""
    kp1, b, _ = ver_logits.shape
    k = kp1 - 1
    dev = ver_logits.device
    temps = torch.as_tensor(temps, dtype=torch.float32, device=dev)
    tgt = torch.argmax(ver_logits, dim=-1)                   # (k+1, B)
    if k == 0:
        bonus = model_lib._sample_with_noise(ver_logits[0], temps,
                                             gumbel[0], top_k=top_k)
        return bonus[:, None], torch.zeros(b, dtype=torch.int64, device=dev)

    d_cols = draft_tokens.long().t()                         # (k, B)
    g_accept = d_cols == tgt[:k]
    p = target_probs(ver_logits, temps[None, :], top_k=top_k)  # (k+1, B, V)
    p_d = p[:k].gather(-1, d_cols[..., None])[..., 0]
    q_d = draft_probs.gather(-1, d_cols[..., None])[..., 0]
    t_accept = uniforms * torch.clamp_min(q_d, 1e-38) < p_d
    accept = torch.where(temps[None, :] > 0, t_accept, g_accept)
    # leading-run length: proposals past the first rejection are dead
    n_accept = torch.cumprod(accept.long(), dim=0).sum(dim=0)  # (B,)

    corr = [_residual_sample(p[j], draft_probs[j], gumbel[j])
            for j in range(k)]
    corr.append(model_lib._sample_with_noise(ver_logits[k], temps,
                                             gumbel[k], top_k=top_k))
    corr = torch.stack(corr)                                 # (k+1, B)
    idx = torch.arange(k + 1, device=dev)[:, None]
    drafts_pad = torch.cat(
        [d_cols, torch.zeros((1, b), dtype=torch.int64, device=dev)])
    temp_out = torch.where(idx < n_accept[None, :], drafts_pad, corr)
    out = torch.where(temps[None, :] > 0, temp_out, tgt)
    return out.t(), n_accept


def speculative_verify(ver_logits, draft_tokens, draft_probs, temps, seed,
                       streams, gens, *, top_k: int = 0):
    """:func:`verify_with_noise` with the round's noise hashed on the
    device: the acceptance uniform at index ``j`` from (``ACCEPT_TAG``,
    stream, ``gens + j``), the residual and bonus Gumbel noise at ``j``
    from plain decode's key (``DOMAIN_DECODE_STREAM``, stream, ``gens +
    j``).  ``seed`` is the engine's ``sample_seed``, ``streams`` the
    31-bit stream ids and ``gens`` the emission index bases, ``(B,)``
    int64."""
    kp1, _, vocab = ver_logits.shape
    uniforms = torch.stack([
        model_lib._uniform(emission_keys(seed, ACCEPT_TAG, streams, gens + j))
        for j in range(kp1 - 1)
    ]) if kp1 > 1 else ver_logits.new_zeros((0, ver_logits.shape[1]))
    gumbel = torch.stack([
        model_lib.gumbel_noise(
            emission_keys(seed, DOMAIN_DECODE_STREAM, streams, gens + j),
            vocab)
        for j in range(kp1)
    ])
    return verify_with_noise(ver_logits, draft_tokens, draft_probs, temps,
                             uniforms, gumbel, top_k=top_k)


# ---------------------------------------------------------------------------
# the round's bodies
# ---------------------------------------------------------------------------


def _lengths_at(lengths, j):
    """Each live slot's context length ``j`` steps on; idle slots stay 0
    (the null page)."""
    return torch.where(lengths > 0, lengths + j, torch.zeros_like(lengths))


@torch.no_grad()
def draft_body(cfg: GptConfig, weights, kv_pages: dict, tokens, lengths,
               page_tables, temps, seed: int, streams, gens, *, k: int,
               page_size: int, kv_wire: str = "f32", top_k: int = 0):
    """``k + 1`` draft decode steps.  Step ``j`` feeds the current token
    at length ``lengths + j`` (writing its draft KV) and, for ``j < k``,
    draws the next proposal from the draft distribution (``DRAFT_TAG``
    keys; greedy slots take the argmax).  The last step exists for its
    KV write.  ``weights`` is a model or packed params, as for the
    decode step.

    Returns ``(draft_tokens (B, k) int64, draft_probs (k, B, V) f32,
    finite (B,) bool)`` — ``finite`` over all ``k + 1`` logits rows."""
    model_lib._check_wire(kv_wire)
    cur = tokens
    toks, probs = [], []
    finite = torch.ones(tokens.shape[0], dtype=torch.bool,
                        device=tokens.device)
    for j in range(k + 1):
        logits = model_lib._decode_step(
            cfg, model_lib._view(weights), kv_pages, cur,
            _lengths_at(lengths, j), page_tables, page_size=page_size,
            kv_wire=kv_wire)
        finite = finite & torch.isfinite(logits).all(dim=-1)
        if j == k:
            break
        keys = emission_keys(seed, DRAFT_TAG, streams, gens + j)
        cur = model_lib.sample_tokens(logits, temps, keys, top_k=top_k)
        toks.append(cur)
        probs.append(target_probs(logits, temps, top_k=top_k))
    b = tokens.shape[0]
    if not k:
        return (torch.zeros((b, 0), dtype=torch.int64, device=tokens.device),
                torch.zeros((0, b, cfg.vocab_size), device=tokens.device),
                finite)
    return torch.stack(toks, dim=1), torch.stack(probs), finite


@torch.no_grad()
def verify_body(cfg: GptConfig, weights, kv_pages: dict, tokens,
                draft_tokens, lengths, page_tables, temps, draft_probs,
                seed: int, streams, gens, *, page_size: int,
                kv_wire: str = "f32", top_k: int = 0):
    """The target's ``k + 1`` decode steps over the columns ``[tokens,
    d_1..d_k]`` at successive lengths, each writing its column's KV at
    its position exactly as a plain decode iteration would, then the
    acceptance (:func:`speculative_verify`).

    Returns ``(ver_logits (k+1, B, V), out_tokens (B, k+1), n_accept
    (B,), finite (B,))`` — ``finite[b]`` screens all ``k + 1`` of slot
    ``b``'s logits rows."""
    model_lib._check_wire(kv_wire)
    k = draft_tokens.shape[1]
    cols = torch.cat([tokens.long()[:, None], draft_tokens.long()], dim=1)
    ver_logits = torch.stack([
        model_lib._decode_step(
            cfg, model_lib._view(weights), kv_pages, cols[:, j],
            _lengths_at(lengths, j), page_tables, page_size=page_size,
            kv_wire=kv_wire)
        for j in range(k + 1)
    ])
    out, n_accept = speculative_verify(ver_logits, draft_tokens, draft_probs,
                                       temps, seed, streams, gens,
                                       top_k=top_k)
    finite = torch.isfinite(ver_logits).all(dim=2).all(dim=0)
    return ver_logits, out, n_accept, finite


@torch.no_grad()
def rollback_body(kv_pages: dict, starts, counts, page_tables, *, k: int,
                  page_size: int) -> dict:
    """Zero, in place, the KV rows of positions ``[starts[b], starts[b] +
    counts[b])`` (``counts <= k``) through slot ``b``'s page table: codes
    and pages to 0, int8 scale planes to their initial 1.0.  Masked rows
    (past a slot's count, or a slot with ``starts == 0``) land on the
    null page.  The caller guarantees every touched page is private (the
    scheduler forks shared tail pages before the round)."""
    width = page_tables.shape[1]
    j = torch.arange(k, device=starts.device)
    pos = starts.long()[:, None] + j[None, :]                # (B, k)
    live = (j[None, :] < counts.long()[:, None]) & (starts[:, None] > 0)
    page_idx = torch.clamp(pos // page_size, 0, width - 1)
    page_ids = torch.where(live, page_tables.long().gather(1, page_idx),
                           torch.zeros_like(pos)).reshape(-1)
    slots = (pos % page_size).reshape(-1)
    for name, t in kv_pages.items():
        t[:, page_ids, :, slots] = 1.0 if name.endswith("_scale") else 0
    return kv_pages

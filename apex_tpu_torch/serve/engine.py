"""Inference engine — bucketed prefill and slot-array decode over the cache.

Counterpart of ``apex_tpu/serve/engine.py``.  The engine owns the
device-side pieces of the serving stack: the model's weights, the paged
KV pool (:mod:`apex_tpu_torch.serve.cache`) and its host allocator.  It
moves tokens and pages; :class:`~apex_tpu_torch.serve.scheduler.
ContinuousBatchingScheduler` owns admission and shedding.

Prefill pads a prompt to the smallest bucket that holds it (page
multiples, powers of two by default — the JAX engine's buckets), so a
prompt's attention runs at a bounded set of shapes.  PyTorch runs
eagerly: there is no ahead-of-time build, and CUDA graphs come later.
The analysis build, chaos gates, spans, rebuild, speculative decoding,
chunked prefill, sampling and the int8 wires are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GptConfig, GptModel
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.serve import cache as cache_lib
from apex_tpu_torch.serve import model as model_lib

__all__ = ["ServeConfig", "InferenceEngine"]


def _default_buckets(page_size: int, max_len: int) -> Tuple[int, ...]:
    """Power-of-two page-multiple buckets covering [page, max_len]."""
    buckets = []
    b = page_size
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine shape/wire knobs (model shape lives in ``GptConfig``)."""

    page_size: int = 16
    #: pool size INCLUDING the reserved null page
    num_pages: int = 128
    #: decode slot count — the continuous batch's capacity
    max_batch: int = 4
    #: page-table width: the longest context is ``max_pages_per_seq *
    #: page_size`` tokens
    max_pages_per_seq: int = 8
    #: prefill bucket lengths (page multiples); () = powers of two up
    #: to the max context
    prefill_buckets: Tuple[int, ...] = ()
    #: "f32" keeps KV in the model dtype (the only wire ported so far)
    kv_wire: str = "f32"
    #: "f32" keeps weights dense (the only wire ported so far)
    weight_wire: str = "f32"

    def __post_init__(self):
        for name in ("kv_wire", "weight_wire"):
            wire = getattr(self, name)
            if wire == "int8":
                raise NotImplementedError(
                    f"{name}='int8' is not ported yet (only 'f32')"
                )
            if wire != "f32":
                raise ValueError(f"{name} must be f32|int8, got {wire!r}")
        usable = self.num_pages - 1
        if usable < self.max_pages_per_seq:
            raise ValueError(
                f"pool of {usable} usable pages cannot hold even one "
                f"max-length sequence ({self.max_pages_per_seq} pages)"
            )

    @property
    def max_context(self) -> int:
        return self.max_pages_per_seq * self.page_size

    def buckets(self) -> Tuple[int, ...]:
        if self.prefill_buckets:
            for b in self.prefill_buckets:
                if b % self.page_size or b > self.max_context:
                    raise ValueError(
                        f"bucket {b} must be a page multiple within "
                        f"max context {self.max_context}"
                    )
            return tuple(sorted(self.prefill_buckets))
        return _default_buckets(self.page_size, self.max_context)


class InferenceEngine:
    """Prefill/decode over the paged cache for a :class:`GptModel`.

    >>> eng = InferenceEngine(cfg, model, ServeConfig(max_batch=4))
    >>> logits, tok = eng.prefill(prompt_ids, page_ids)
    >>> logits, toks = eng.decode(tokens, lengths, page_tables)

    Runs on ``device`` — the card by default, raising when there is
    none; ``device="cpu"`` runs the plain PyTorch versions.  The model
    must already live there; the engine serves a copy of its weights
    cast to ``cfg.dtype`` when the engine is built.  Inputs are host
    sequences/arrays; tokens come back on the host.
    """

    def __init__(self, cfg: GptConfig, model: GptModel,
                 serve: Optional[ServeConfig] = None, *, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = model_lib.validate_config(cfg)
        self.serve = serve or ServeConfig()
        if self.serve.max_context > cfg.max_seq_len:
            raise ValueError(
                f"max context {self.serve.max_context} exceeds the "
                f"model's max_seq_len {cfg.max_seq_len}"
            )
        if cfg.hidden_size % cfg.num_heads:
            raise ValueError("num_heads must divide hidden_size")
        if model.device != self.device:
            raise ValueError(
                f"the model lives on {model.device}, the engine on "
                f"{self.device}"
            )
        #: the engine's own copy of the weights, in ``cfg.dtype`` where the
        #: layers compute (:func:`~apex_tpu_torch.serve.model.serving_copy`):
        #: made once here, so decode casts no f32 weight; later changes to
        #: ``model`` do not reach it
        self.model = model_lib.serving_copy(cfg, model)
        self.pool = cache_lib.PagePool(
            self.serve.num_pages, self.serve.page_size
        )
        self.cache = cache_lib.init_kv_pages(
            cfg.num_layers,
            self.serve.num_pages,
            cfg.num_heads,
            self.serve.page_size,
            cfg.head_dim,
            dtype=cfg.dtype,
            device=self.device,
            kv_wire=self.serve.kv_wire,
        )
        #: call counters (always counted)
        self.decode_iters = 0
        self.prefill_calls = 0
        #: the non-finite screens of the LAST prefill/decode call —
        #: a bool, and a (max_batch,) bool array (None before the first
        #: decode); the scheduler's quarantine reads them
        self.last_prefill_finite: bool = True
        self.last_decode_finite: Optional[np.ndarray] = None

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.serve.buckets():
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt of {prompt_len} tokens exceeds the max context "
            f"{self.serve.max_context}"
        )

    def _tensor(self, array, dtype):
        return torch.as_tensor(np.asarray(array), dtype=dtype,
                               device=self.device)

    @staticmethod
    def _greedy_only(temps) -> None:
        if temps is not None and np.any(np.asarray(temps) > 0):
            raise NotImplementedError(
                "temperature sampling is not ported yet (greedy only)"
            )

    @torch.no_grad()
    def prefill(self, prompt_ids, page_ids, *,
                temperature: float = 0.0) -> Tuple[torch.Tensor, int]:
        """Run the prompt through the bucketed prefill: writes its K/V
        into ``page_ids`` (null-padded to the bucket's page count) and
        returns ``(last_logits (V,) on the device, first_token)``."""
        self._greedy_only(temperature)
        n = len(prompt_ids)
        bucket = self.bucket_for(n)
        np_b = bucket // self.serve.page_size
        tokens = np.zeros((bucket, 1), np.int64)
        tokens[:n, 0] = np.asarray(prompt_ids, np.int64)
        ids = np.full((np_b,), cache_lib.NULL_PAGE, np.int64)
        ids[: len(page_ids)] = np.asarray(page_ids, np.int64)
        logits, next_token, finite, self.cache = model_lib.prefill_body(
            self.cfg, self.model, self.cache,
            self._tensor(tokens, torch.int64), n,
            self._tensor(ids, torch.int64),
            page_size=self.serve.page_size, kv_wire=self.serve.kv_wire,
        )
        self.prefill_calls += 1
        first = int(next_token)
        self.last_prefill_finite = bool(finite)
        return logits, first

    @torch.no_grad()
    def decode(self, tokens, lengths, page_tables, temps=None):
        """One decode iteration over the full slot array.  ``lengths``
        counts each slot's context INCLUDING the token being fed (0 =
        idle slot).  Returns ``(logits (B, V) on the device, next_tokens
        (B,) on the host)``; the per-slot non-finite screen lands on
        :attr:`last_decode_finite`."""
        self._greedy_only(temps)
        logits, next_tokens, finite, self.cache = model_lib.decode_body(
            self.cfg, self.model, self.cache,
            self._tensor(tokens, torch.int64),
            self._tensor(lengths, torch.int32),
            self._tensor(page_tables, torch.int32),
            page_size=self.serve.page_size, kv_wire=self.serve.kv_wire,
        )
        self.decode_iters += 1
        out = next_tokens.cpu().numpy()
        self.last_decode_finite = finite.cpu().numpy()
        return logits, out

"""Inference engine — bucketed prefill, chunked prefill and slot-array decode.

Counterpart of ``apex_tpu/serve/engine.py``.  The engine owns the
device-side pieces of the serving stack: the model's weights (a
``cfg.dtype`` copy, or the int8 weight wire), the paged KV pool
(:mod:`apex_tpu_torch.serve.cache`, on the ``cfg.dtype`` or the int8 KV
wire) and its host allocator.  It moves tokens and pages;
:class:`~apex_tpu_torch.serve.scheduler.ContinuousBatchingScheduler`
owns admission, the prefix cache and shedding.

Prefill pads a prompt (or a chunk of one) to the smallest bucket that
holds it (page multiples, powers of two by default — the JAX engine's
buckets), so its attention runs at a bounded set of shapes.  The JAX
engine compiles each step ahead of time; here prefill runs eagerly, and
on the card the **decode step is one CUDA graph**: :meth:`build` (or the
first :meth:`decode`) runs the step once on a side stream — every kernel
built, K6's arrival counters allocated — and captures it; each decode
then copies its inputs into the graph's static input tensor in one copy,
replays, and reads the next tokens and the non-finite screen back in one
copy.  The pool and the weights stay at fixed addresses (every write is
in place), so the graph stays valid for the engine's life.  A capture or
replay that fails raises; the card never falls back to the eager step.
On the CPU (no graphs) the same step runs eagerly.

Sampling follows the JAX engine: per-request temperatures, a static
``top_k`` and a ``sample_seed``; the noise is a counter-based hash
(:func:`~apex_tpu_torch.serve.model.sample_keys`) of the seed and, per
slot, either (stream seed, generation index) or (call index, slot).
The analysis build, chaos gates, spans, rebuild and speculative
decoding are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GptConfig, GptModel
from apex_tpu_torch.ops import _dispatch
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.serve import cache as cache_lib
from apex_tpu_torch.serve import model as model_lib

__all__ = ["ServeConfig", "InferenceEngine"]

#: sampling-key domains: the first word of each row's key
DOMAIN_PREFILL_CALL = 1    # (prefill call index, 0)
DOMAIN_PREFILL_STREAM = 2  # (stream seed, 0)
DOMAIN_DECODE_CALL = 3     # (decode call index, slot)
DOMAIN_DECODE_STREAM = 4   # (stream seed, generation index)
#: decode input columns: token, length, temperature bits, the key's
#: three words, then the page table
_COLS = 6


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
    #: "f32" keeps KV in the model dtype; "int8" stores blockwise codes
    #: and one f32 scale per (head, token) row
    kv_wire: str = "f32"
    #: "f32" keeps weights dense in the model dtype; "int8" packs the
    #: large leaves on the codec and dequantizes a layer at a time
    weight_wire: str = "f32"
    #: static top-k cutoff of the fused sampler (0 = full vocab); the
    #: temperature rides each call (<= 0 is greedy argmax)
    top_k: int = 0
    #: seed of the sampler's noise
    sample_seed: int = 0

    def __post_init__(self):
        if self.kv_wire not in ("f32", "int8"):
            raise ValueError(f"kv_wire must be f32|int8, got {self.kv_wire!r}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.weight_wire not in ("f32", "int8"):
            raise ValueError(
                f"weight_wire must be f32|int8, got {self.weight_wire!r}"
            )
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
    >>> eng.build()                  # warm the buckets, capture decode
    >>> logits, tok = eng.prefill(prompt_ids, page_ids)
    >>> logits, toks = eng.decode(tokens, lengths, page_tables, temps)

    Runs on ``device`` — the card by default, raising when there is
    none; ``device="cpu"`` runs the plain PyTorch versions.  The model
    must already live there; the engine serves its own copy of the
    weights, made when it is built (``cfg.dtype``, or the int8 wire), so
    later changes to the model do not reach it.  Inputs are host
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
        #: the engine's weights: under ``weight_wire="f32"`` a copy of the
        #: model in ``cfg.dtype`` where the layers compute
        #: (:func:`~apex_tpu_torch.serve.model.serving_copy`, also
        #: :attr:`model`); under ``"int8"`` the packed leaves
        #: (:class:`~apex_tpu_torch.serve.model.PackedParams`, also
        #: :attr:`params`; :attr:`model` is None)
        self.model: Optional[GptModel] = None
        self.params: Optional[model_lib.PackedParams] = None
        if self.serve.weight_wire == "int8":
            self.params = model_lib.PackedParams(cfg, model)
            self.weights = self.params
        else:
            self.model = model_lib.serving_copy(cfg, model)
            self.weights = self.model
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
        #: call counters (always counted); the sampler's call-indexed
        #: keys read them
        self.decode_iters = 0
        self.prefill_calls = 0
        #: the non-finite screens of the LAST prefill/decode call —
        #: a bool, and a (max_batch,) bool array (None before the first
        #: decode); the scheduler's quarantine reads them
        self.last_prefill_finite: bool = True
        self.last_decode_finite: Optional[np.ndarray] = None
        #: the captured decode step (card only): the graph, its static
        #: input, its outputs and the launches recorded at capture
        self._graph = None

    # -- sizes ---------------------------------------------------------------
    def kv_pool_bytes(self) -> int:
        """Bytes of the KV pool: codes (or pages) and scale planes."""
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    def weight_bytes(self) -> int:
        """Bytes of the weights the engine keeps resident."""
        if self.params is not None:
            return self.params.nbytes()
        return sum(p.numel() * p.element_size()
                   for p in self.model.parameters())

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

    def _keys(self, words) -> torch.Tensor:
        """Sampling keys of rows of (domain, a, b) uint32 words."""
        w = model_lib.fold31(np.asarray(words, np.int64) & 0xFFFFFFFF)
        return model_lib.sample_keys(self.serve.sample_seed,
                                     self._tensor(w, torch.int64))

    def _prefill_keys(self, stream):
        if stream is None:
            return self._keys([[DOMAIN_PREFILL_CALL, self.prefill_calls, 0]])
        return self._keys([[DOMAIN_PREFILL_STREAM, stream, 0]])

    # -- build ---------------------------------------------------------------
    def build(self, buckets: Optional[Tuple[int, ...]] = None, *,
              chunked: bool = False):
        """Run the prefill at every bucket once (and, with
        ``chunked=True``, the chunked prefill at every bucket) so that
        first-call costs leave the serving path, and on the card capture
        the decode step as a CUDA graph.  The warm-up writes only the
        null page and leaves the call and launch counters as they
        were."""
        s = self.serve
        table = torch.zeros((s.max_pages_per_seq,), dtype=torch.int64,
                            device=self.device)
        with _dispatch.recorded_apart():
            for b in buckets if buckets is not None else s.buckets():
                tokens = torch.zeros((b, 1), dtype=torch.int64,
                                     device=self.device)
                ids = torch.zeros((b // s.page_size,), dtype=torch.int64,
                                  device=self.device)
                temp = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
                keys = self._prefill_keys(None)
                model_lib.prefill_body(
                    self.cfg, self.weights, self.cache, tokens, 1, ids, temp,
                    keys, page_size=s.page_size, kv_wire=s.kv_wire,
                    top_k=s.top_k)
                if chunked:
                    model_lib.chunk_prefill_body(
                        self.cfg, self.weights, self.cache, tokens, 1, 0,
                        ids, table, temp, keys, page_size=s.page_size,
                        kv_wire=s.kv_wire, top_k=s.top_k)
        if self.device.type == "cuda":
            self._capture_decode()
        return self

    # -- serving calls -------------------------------------------------------
    @torch.no_grad()
    def prefill(self, prompt_ids, page_ids, *, temperature: float = 0.0,
                stream: Optional[int] = None) -> Tuple[torch.Tensor, int]:
        """Run the prompt through the bucketed prefill: writes its K/V
        into ``page_ids`` (null-padded to the bucket's page count) and
        returns ``(last_logits (V,) on the device, first_token)``.  The
        first token is sampled in the step (``temperature <= 0`` is
        greedy), its noise keyed by ``stream`` when given, else by the
        call index."""
        n = len(prompt_ids)
        bucket = self.bucket_for(n)
        np_b = bucket // self.serve.page_size
        tokens = np.zeros((bucket, 1), np.int64)
        tokens[:n, 0] = np.asarray(prompt_ids, np.int64)
        ids = np.full((np_b,), cache_lib.NULL_PAGE, np.int64)
        ids[: len(page_ids)] = np.asarray(page_ids, np.int64)
        keys = self._prefill_keys(stream)
        logits, next_token, finite, self.cache = model_lib.prefill_body(
            self.cfg, self.weights, self.cache,
            self._tensor(tokens, torch.int64), n,
            self._tensor(ids, torch.int64),
            self._tensor(temperature, torch.float32), keys,
            page_size=self.serve.page_size, kv_wire=self.serve.kv_wire,
            top_k=self.serve.top_k,
        )
        self.prefill_calls += 1
        out = torch.stack([next_token, finite.long()]).cpu()
        self.last_prefill_finite = bool(out[1])
        return logits, int(out[0])

    @torch.no_grad()
    def chunk_prefill(self, chunk_ids, offset, page_table_row,
                      chunk_page_ids, *, temperature: float = 0.0,
                      stream: Optional[int] = None
                      ) -> Tuple[torch.Tensor, int]:
        """One page-multiple prefill chunk with carry-in KV offset
        (:func:`~apex_tpu_torch.serve.model.chunk_prefill_body`): the
        positions before ``offset`` are read from the paged cache through
        ``page_table_row``, and the chunk's K/V are written to
        ``chunk_page_ids`` (null entries skip pages a borrowed cache run
        already holds).  Returns ``(last_logits (V,), next_token)`` for
        the chunk's final live position; the screen lands on
        :attr:`last_prefill_finite`, as for :meth:`prefill`."""
        n = len(chunk_ids)
        bucket = self.bucket_for(n)
        np_b = bucket // self.serve.page_size
        tokens = np.zeros((bucket, 1), np.int64)
        tokens[:n, 0] = np.asarray(chunk_ids, np.int64)
        ids = np.full((np_b,), cache_lib.NULL_PAGE, np.int64)
        ids[: len(chunk_page_ids)] = np.asarray(chunk_page_ids, np.int64)
        table = np.full((self.serve.max_pages_per_seq,), cache_lib.NULL_PAGE,
                        np.int64)
        table[: len(page_table_row)] = np.asarray(page_table_row, np.int64)
        keys = self._prefill_keys(stream)
        logits, next_token, finite, self.cache = model_lib.chunk_prefill_body(
            self.cfg, self.weights, self.cache,
            self._tensor(tokens, torch.int64), n, int(offset),
            self._tensor(ids, torch.int64), self._tensor(table, torch.int64),
            self._tensor(temperature, torch.float32), keys,
            page_size=self.serve.page_size, kv_wire=self.serve.kv_wire,
            top_k=self.serve.top_k,
        )
        self.prefill_calls += 1
        out = torch.stack([next_token, finite.long()]).cpu()
        self.last_prefill_finite = bool(out[1])
        return logits, int(out[0])

    @torch.no_grad()
    def fork_page(self, src: int, dst: int) -> None:
        """Copy-on-write fork: copy page ``src`` into ``dst`` in every
        layer, codes and scale planes alike, in place — the device half
        of the scheduler's shared-tail-page fork."""
        for t in self.cache.values():
            t[:, dst].copy_(t[:, src])

    def _decode_input(self, tokens, lengths, page_tables, temps, streams,
                      gens) -> np.ndarray:
        """The decode step's inputs as one int64 host array (B, 6 + NP):
        token, length, the temperature's f32 bits, the sampling key's
        words, the page table."""
        s = self.serve
        b = s.max_batch
        arr = np.zeros((b, _COLS + s.max_pages_per_seq), np.int64)
        arr[:, 0] = np.asarray(tokens, np.int64)
        arr[:, 1] = np.asarray(lengths, np.int64)
        t = (np.zeros(b, np.float32) if temps is None
             else np.asarray(temps, np.float32).reshape(b))
        arr[:, 2] = t.view(np.int32)
        if streams is None:
            words = (DOMAIN_DECODE_CALL, self.decode_iters, np.arange(b))
        else:
            words = (DOMAIN_DECODE_STREAM, np.asarray(streams, np.int64),
                     np.asarray(gens, np.int64))
        for j, w in enumerate(words):
            arr[:, 3 + j] = model_lib.fold31(np.asarray(w, np.int64)
                                             & 0xFFFFFFFF)
        arr[:, _COLS:] = np.asarray(page_tables, np.int64)
        return arr

    def _decode_compute(self, inp: torch.Tensor):
        """The decode step on an input tensor laid out as
        :meth:`_decode_input`'s (the key words folded to 31 bits):
        returns ``(logits (B, V), out (2, B))``,
        ``out`` the next tokens and the finite screen (one readback)."""
        s = self.serve
        temps = inp[:, 2].to(torch.int32).view(torch.float32)
        keys = model_lib.sample_keys(s.sample_seed, inp[:, 3:_COLS])
        logits, next_tokens, finite, _ = model_lib.decode_body(
            self.cfg, self.weights, self.cache, inp[:, 0].contiguous(),
            inp[:, 1].to(torch.int32).contiguous(),
            inp[:, _COLS:].to(torch.int32).contiguous(), temps, keys,
            page_size=s.page_size, kv_wire=s.kv_wire, top_k=s.top_k,
        )
        return logits, torch.stack([next_tokens, finite.long()])

    @torch.no_grad()
    def _capture_decode(self) -> None:
        """Run the decode step once on a side stream with every slot idle
        (it writes only the null page), then capture it into a CUDA
        graph.  The launch counters and the path log are left as they
        were; the launches and paths of the captured step are kept, and
        every replay adds them."""
        s = self.serve
        dev = self.device
        inp = torch.zeros((s.max_batch, _COLS + s.max_pages_per_seq),
                          dtype=torch.int64, device=dev)
        staging = torch.zeros(inp.shape, dtype=torch.int64, pin_memory=True)
        with _dispatch.recorded_apart():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._decode_compute(inp)
            torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _dispatch.recorded_apart() as rec:
            with torch.cuda.graph(graph):
                logits, out = self._decode_compute(inp)
        if not rec["launches"]:
            raise RuntimeError("the captured decode step launched no kernel")
        self._graph = dict(graph=graph, inp=inp, staging=staging,
                           logits=logits, out=out, record=rec)

    @property
    def graph_launches(self) -> dict:
        """Kernel -> launches in one replay of the captured decode step
        (empty before the capture, and on the CPU)."""
        return dict(self._graph["record"]["launches"]) if self._graph else {}

    @torch.no_grad()
    def decode(self, tokens, lengths, page_tables, temps=None, *,
               streams=None, gens=None):
        """One decode iteration over the full slot array.  ``lengths``
        counts each slot's context INCLUDING the token being fed (0 =
        idle slot); ``temps`` are per-slot temperatures (None = greedy).
        ``streams``/``gens`` (both ``(B,)``) key each slot's noise by its
        stream seed and generation index, so a stream re-draws the same
        tokens whatever call carries it; without them the noise is keyed
        by the call index and the slot.  On the card the step is a replay
        of the captured graph.  Returns ``(logits (B, V) on the device,
        next_tokens (B,) on the host)``; the per-slot non-finite screen
        lands on :attr:`last_decode_finite`."""
        arr = self._decode_input(tokens, lengths, page_tables, temps,
                                 streams, gens)
        if self.device.type == "cuda":
            if self._graph is None:
                self._capture_decode()
            g = self._graph
            g["staging"].numpy()[...] = arr
            g["inp"].copy_(g["staging"], non_blocking=True)
            g["graph"].replay()
            _dispatch.replay_record(g["record"])
            logits, out = g["logits"].clone(), g["out"].cpu()
        else:
            logits, out = self._decode_compute(torch.from_numpy(arr))
        self.decode_iters += 1
        out = out.numpy()
        self.last_decode_finite = out[1].astype(bool)
        return logits, out[0]

    @torch.no_grad()
    def _decode_eager(self, tokens, lengths, page_tables, temps=None, *,
                      streams=None, gens=None):
        """The decode step run eagerly on the engine's device, with the
        inputs, keys and counters :meth:`decode` would use, and no call
        counted: the reference that the captured graph is held to, bit
        for bit.  Returns ``(logits (B, V), next_tokens, finite)``."""
        arr = self._decode_input(tokens, lengths, page_tables, temps,
                                 streams, gens)
        logits, out = self._decode_compute(
            torch.from_numpy(arr).to(self.device))
        out = out.cpu().numpy()
        return logits, out[0], out[1].astype(bool)

    @torch.no_grad()
    def reset_cache(self) -> None:
        """Re-zero the paged KV pool in place (codes and pages to zero,
        scale planes to one), so a captured graph keeps its addresses.
        Only legal with an empty pool: live pages hold state requests
        will read."""
        if self.pool.in_use != 0:
            raise RuntimeError(
                f"reset_cache with {self.pool.in_use} pages in use"
            )
        for name, t in self.cache.items():
            t.fill_(1 if name.endswith("_scale") else 0)

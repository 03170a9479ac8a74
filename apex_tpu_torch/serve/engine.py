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

With a :class:`~apex_tpu_torch.serve.spec.SpecConfig` the engine also
holds a draft (the target's own weights, or a separate model packed or
copied on its own) with a KV pool of the target's page geometry, and
runs speculative rounds (:meth:`spec_step`): on the card the draft's
``k + 1`` steps, the verify's ``k + 1`` steps and the acceptance are one
more captured CUDA graph.

**Failure surface** (the reference's): every step screens its logits
for non-finite values (:attr:`last_prefill_finite`,
:attr:`last_decode_finite`, the scheduler's quarantine evidence); the
chaos gates of the ``serve.prefill``, ``serve.decode`` and
``serve.draft`` sites (:meth:`_chaos_gate`) run on the host before a
call — before a graph's replay, never inside a capture — so they add no
launch to a graph: ``stall`` sleeps, ``raise`` raises
:class:`~apex_tpu_torch.resilience.chaos.InjectedFault`, and ``nan`` /
``inf`` mark the first live slot's screen non-finite after the readback
(a poisoned draft round pins every proposal, through one column of the
round's input).  :meth:`rebuild` is the supervised recovery: on the card
it drops the captured graphs (and their private memory pools) and
captures new ones, while the KV pool, its scale planes, the weights and
the page pool stay at their addresses, so surviving requests resume from
their pages.  With a span recorder attached (``engine.spans``, set by
the scheduler) each prefill and decode call records an
``engine/prefill`` / ``engine/decode`` span, measured up to its
readback.  The build gauges go to the board (``serve/page_size``, ...).

**Build checks** (``ServeConfig.verify``, on by default as in the
reference): the build records the warm-up it runs anyway — each prefill
bucket, each chunk bucket, the draft's prefill, and on the card the run of
the decode step (and the spec round) before its capture
(:func:`apex_tpu_torch.analysis.capture`; on the CPU one decode warm-up on
idle slots) — and lints each record: no host transfer, no f64, the KV
pool updated in place, and the estimated peak against
``ServeConfig.hbm_budget_bytes`` (:mod:`apex_tpu_torch.analysis.memory`).
Each program's report lands on :attr:`InferenceEngine.reports`, its
estimate on the board (``serve/hbm/<program>/peak_hbm_bytes``,
``serve/peak_hbm_bytes``), and an ERROR fails the build with the rendered
report.  :meth:`InferenceEngine.lint` merges the reports and never raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GptConfig, GptModel
from apex_tpu_torch.observability.metrics import board
from apex_tpu_torch.observability.spans import TRACK_ENGINE
from apex_tpu_torch.ops import _dispatch
from apex_tpu_torch.resilience import chaos
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.serve import cache as cache_lib
from apex_tpu_torch.serve import model as model_lib
from apex_tpu_torch.serve import spec as spec_lib
from apex_tpu_torch.serve.model import (
    DOMAIN_DECODE_CALL,
    DOMAIN_DECODE_STREAM,
    DOMAIN_PREFILL_CALL,
    DOMAIN_PREFILL_STREAM,
)

__all__ = ["ServeConfig", "InferenceEngine"]

#: decode input columns: token, length, temperature bits, the key's
#: three words, then the page table
_COLS = 6
#: spec-round input columns: token, length, temperature bits, stream,
#: generation index, the draft's poison threshold (1; 2 pins every
#: proposal: a ``serve.draft`` nan/inf fault), then the target's and the
#: draft's page tables
_SPEC_COLS = 6


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
    #: lint every step program at build from its recorded warm-up (ERROR
    #: findings raise)
    verify: bool = True
    #: estimated peak-memory budget in bytes for each step program
    #: (weights + KV pool + activations, from the recorded warm-up's live
    #: ranges — apex_tpu_torch.analysis.memory).  None skips the gate;
    #: with ``verify=True`` an over-budget program fails the BUILD
    hbm_budget_bytes: Optional[int] = None

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
                 serve: Optional[ServeConfig] = None, *,
                 spec: Optional[spec_lib.SpecConfig] = None, registry=None,
                 device="cuda", weights=None):
        self.device = resolve_device(device)
        #: the metric registry a scheduler inherits by default
        self.registry = registry
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
        #: :attr:`params`; :attr:`model` is None).  ``weights=`` serves
        #: another engine's prepared weights (its :attr:`weights`, same
        #: config and wire) instead of a copy: replicas of one model then
        #: share one copy, as the reference's engines share one tree
        self.model: Optional[GptModel] = None
        self.params: Optional[model_lib.PackedParams] = None
        self._adopt(weights if weights is not None
                    else self.prepare_weights(model))
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
        #: keys and the chaos gates read them, and they are the
        #: correlation ids of a request's span chain
        self.decode_iters = 0
        self.prefill_calls = 0
        #: optional :class:`~apex_tpu_torch.observability.spans.
        #: SpanRecorder` (the scheduler attaches its own)
        self.spans = None
        #: supervised recoveries (:meth:`rebuild` calls)
        self.rebuilds = 0
        #: graph captures by step ("decode", "spec"; card only): one each
        #: at build, one more each rebuild
        self.captures: Dict[str, int] = {}
        #: the non-finite screens of the LAST prefill/decode call —
        #: a bool, and a (max_batch,) bool array (None before the first
        #: decode); the scheduler's quarantine reads them
        self.last_prefill_finite: bool = True
        self.last_decode_finite: Optional[np.ndarray] = None
        #: the captured decode step (card only): the graph, its static
        #: input, its outputs and the launches recorded at capture
        self._graph = None
        #: the stream every capture warms up and captures on (card only)
        self._side = None
        #: speculative decoding: None = plain serving; a SpecConfig adds
        #: the draft's weights and KV pool, and the spec round (one
        #: captured graph on the card, :meth:`spec_step`)
        self.spec = spec
        self.draft_cfg: Optional[GptConfig] = None
        self.draft_weights = None
        self.draft_cache = None
        self._spec_graph = None
        self.last_verify_logits: Optional[torch.Tensor] = None
        #: spec rounds run and draft prefills (the draft's own counter,
        #: so a spec deployment leaves the target's counters as they are)
        self.spec_rounds = 0
        self.draft_prefill_calls = 0
        #: build checks (``ServeConfig.verify``): program name -> its
        #: :class:`~apex_tpu_torch.analysis.Report`, its recorded warm-up
        #: (:class:`~apex_tpu_torch.analysis.StepRecord`) and, on the card,
        #: the allocator's readings over that run (``peak``:
        #: ``max_memory_allocated``, ``before``: ``memory_allocated`` at
        #: its start)
        self.reports: Dict[str, object] = {}
        self.records: Dict[str, object] = {}
        self.measured: Dict[str, dict] = {}
        if spec is not None:
            self._init_draft(spec)
        self._publish_build_gauges()

    def prepare_weights(self, model: GptModel, cfg=None):
        """``model`` prepared as this engine serves it, in tensors of its
        own: a serving copy (in ``cfg.dtype``; ``cfg`` the target's by
        default, the draft's for a draft), or packed (quantized anew) on
        the int8 weight wire."""
        if model.device != self.device:
            raise ValueError(
                f"the model lives on {model.device}, the engine on "
                f"{self.device}"
            )
        cfg = cfg or self.cfg
        if self.serve.weight_wire == "int8":
            return model_lib.PackedParams(cfg, model)
        return model_lib.serving_copy(cfg, model)

    def _own(self, weights, cfg):
        """``weights`` as served: a model prepared anew, prepared weights
        as they are."""
        if isinstance(weights, GptModel) and not getattr(
                weights, "_serving_copy", False):
            return self.prepare_weights(weights, cfg)
        return weights

    def _adopt(self, weights) -> None:
        want = (model_lib.PackedParams if self.serve.weight_wire == "int8"
                else GptModel)
        if not isinstance(weights, want):
            raise ValueError(
                f"weights must be a {want.__name__} on "
                f"weight_wire={self.serve.weight_wire!r}"
            )
        self.weights = weights
        if want is GptModel:
            self.model = weights
        else:
            self.params = weights

    @torch.no_grad()
    def swap_weights(self, weights, draft_weights=None) -> None:
        """Serve new target weights: ``weights`` is a :class:`GptModel`,
        prepared here into tensors of the engine's own
        (:meth:`prepare_weights`: never copied into the old tensors,
        which other engines may share), or an already prepared weight
        object (an engine's :attr:`weights`), adopted as it is — a
        rollback's incumbent comes back bit for bit.  ``draft_weights``
        does the same for a separate draft (None keeps it); a self-draft
        follows the new target.  Then every graph is captured anew
        (:meth:`rebuild` with ``full=True``): the old graphs read the old
        tensors' addresses.  Only legal on a quiet engine."""
        if self.pool.in_use != 0:
            raise RuntimeError(
                f"swap_weights with {self.pool.in_use} pages in use"
            )
        self._adopt(self._own(weights, self.cfg))
        if self.spec is not None:
            if self.spec.draft_params is None:
                self.draft_weights = self.weights
            elif draft_weights is not None:
                self.draft_weights = self._own(draft_weights, self.draft_cfg)
        self.rebuild(full=True)

    def _publish_build_gauges(self) -> None:
        s = self.serve
        board.set("serve/page_size", s.page_size)
        board.set("serve/num_pages", s.num_pages - 1)
        board.set("serve/max_batch", s.max_batch)
        board.set("serve/max_context", s.max_context)
        board.set("serve/kv_wire", s.kv_wire)
        board.set("serve/weight_wire", s.weight_wire)
        if self.spec is not None:
            board.set("serve/spec_k", self.spec.k)
            board.set("serve/spec_mode", self.spec.mode)

    def _init_draft(self, spec: spec_lib.SpecConfig) -> None:
        """Validate the draft against the target and give it its weights
        and its KV pool, which mirrors the target's page geometry so that
        one :class:`PagePool` indexes both (draft pages ride the
        ``"draft"`` namespace)."""
        cfg, s = self.cfg, self.serve
        draft = spec.draft_params
        dcfg = spec.draft_cfg or (draft.cfg if draft is not None else cfg)
        if draft is not None and draft.cfg != dcfg:
            raise ValueError("SpecConfig.draft_cfg differs from the draft "
                             "model's config")
        dcfg = model_lib.validate_config(dcfg)
        if dcfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{cfg.vocab_size} (proposals must share the token space)"
            )
        if s.max_context > dcfg.max_seq_len:
            raise ValueError(
                f"max context {s.max_context} exceeds the draft model's "
                f"max_seq_len {dcfg.max_seq_len}"
            )
        if dcfg.hidden_size % dcfg.num_heads:
            raise ValueError("draft num_heads must divide hidden_size")
        self.draft_cfg = dcfg
        if draft is None:
            # self-draft: the target's own weights, shared
            self.draft_weights = self.weights
        else:
            # the draft's own weights (on the int8 wire its own stacked
            # tree: its blocks follow its layout)
            self.draft_weights = self.prepare_weights(draft, dcfg)
        self.draft_cache = cache_lib.init_kv_pages(
            dcfg.num_layers, s.num_pages, dcfg.num_heads, s.page_size,
            dcfg.head_dim, dtype=dcfg.dtype, device=self.device,
            kv_wire=s.kv_wire,
        )

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
        ``chunked=True``, the chunked prefill at every bucket; with a
        draft, the draft's prefill too) so that first-call costs leave
        the serving path, and on the card capture the decode step (and
        the spec round) as CUDA graphs.  The warm-up writes only the
        null page and leaves the call and launch counters as they
        were."""
        s = self.serve
        with _dispatch.recorded_apart():
            for b in buckets if buckets is not None else s.buckets():
                for name, run, draft in self._warmups(b, chunked):
                    self._warm(name, run, draft=draft)
            if self.device.type != "cuda" and s.verify:
                # no capture to warm up on the CPU: one decode on idle
                # slots (it writes only the null pages) is the record
                self._warm("decode", self._idle_decode())
        if self.device.type == "cuda":
            self._capture_decode(verify=s.verify)
            if self.spec is not None:
                self._capture_spec(verify=s.verify)
        return self

    def _warmups(self, bucket: int, chunked: bool):
        """``[(name, run, draft)]``: the warm-ups of ``bucket`` — its
        prefill, with ``chunked`` its chunked prefill, with a draft the
        draft's prefill — on inputs that write only the null page."""
        s = self.serve
        dev = self.device
        tokens = torch.zeros((bucket, 1), dtype=torch.int64, device=dev)
        ids = torch.zeros((bucket // s.page_size,), dtype=torch.int64,
                          device=dev)
        temp = torch.zeros((), dtype=torch.float32, device=dev)
        keys = self._prefill_keys(None)
        out = [(f"prefill_{bucket}", lambda: model_lib.prefill_body(
            self.cfg, self.weights, self.cache, tokens, 1, ids, temp, keys,
            page_size=s.page_size, kv_wire=s.kv_wire, top_k=s.top_k), False)]
        if chunked:
            table = torch.zeros((s.max_pages_per_seq,), dtype=torch.int64,
                                device=dev)
            out.append((f"chunk_prefill_{bucket}",
                        lambda: model_lib.chunk_prefill_body(
                            self.cfg, self.weights, self.cache, tokens, 1, 0,
                            ids, table, temp, keys, page_size=s.page_size,
                            kv_wire=s.kv_wire, top_k=s.top_k), False))
        if self.spec is not None:
            out.append((f"draft_prefill_{bucket}",
                        lambda: self._draft_prefill_body(tokens, 1, ids),
                        True))
        return out

    def _idle_decode(self):
        """The decode step on idle slots (it writes only the null pages)."""
        s = self.serve
        inp = torch.zeros((s.max_batch, _COLS + s.max_pages_per_seq),
                          dtype=torch.int64, device=self.device)
        return lambda: self._decode_compute(inp)

    # -- build checks --------------------------------------------------------
    def _weight_tree(self, weights) -> dict:
        """The tensors of a weight holder by name (a module's parameters
        and buffers, or the int8 wire's codes and scales)."""
        if isinstance(weights, torch.nn.Module):
            return {**dict(weights.named_parameters()),
                    **dict(weights.named_buffers())}
        out = {}
        for i, leaf in enumerate(weights.leaves()):
            if isinstance(leaf, model_lib.PackedWeight):
                out[f"{i}/codes"], out[f"{i}/scale"] = leaf.codes, leaf.scale
            elif isinstance(leaf, torch.Tensor):
                out[str(i)] = leaf
        return out

    def _arguments(self, draft: bool = False, spec: bool = False):
        """The trees a program reads besides its inputs, by path (the
        weights and the KV pools), and the paths it must update in place
        (the pools it writes)."""
        named = {"params": self._weight_tree(
            self.draft_weights if draft else self.weights)}
        donated = ()
        if not draft:
            named["kv_cache"] = self.cache
            donated += ("kv_cache",)
        if draft or spec:
            named["draft/params"] = self._weight_tree(self.draft_weights)
            named["draft/kv_cache"] = self.draft_cache
            donated += ("draft/kv_cache",)
        return named, donated

    def _warm(self, name: str, run, *, draft: bool = False,
              spec: bool = False):
        """Run one warm-up of program ``name``; with ``verify`` record it
        (:func:`apex_tpu_torch.analysis.capture`) and lint the record
        (:meth:`_verify`), reading the allocator over the same run on the
        card."""
        if not self.serve.verify:
            return run()
        from apex_tpu_torch import analysis

        named, donated = self._arguments(draft, spec)
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            before = torch.cuda.memory_allocated(self.device)
        out, record = analysis.capture(run, named=named)
        if on_card:
            torch.cuda.synchronize(self.device)
            self.measured[name] = {
                "peak": torch.cuda.max_memory_allocated(self.device),
                "before": before}
        self.records[name] = record
        self._verify(name, record, donated)
        return out

    def _verify(self, name: str, record, donated) -> None:
        """Lint one program's record: transfer, promotion (f64),
        donation of ``donated`` and the memory budget; publish the
        estimate and the counts; raise on an ERROR."""
        from apex_tpu_torch import analysis

        report = analysis.lint_graph(
            record, donated_paths=donated,
            hbm_budget=self.serve.hbm_budget_bytes, name=f"serve/{name}")
        est = analysis.memory.estimate_peak(record)
        analysis.memory.publish_peak(est, prefix=f"serve/hbm/{name}")
        board.set("serve/peak_hbm_bytes", max(
            int(board.get("serve/peak_hbm_bytes") or 0), est["peak_bytes"]))
        report.sections["peak_hbm_bytes"] = est["peak_bytes"]
        report.sections["recorded_run_ms"] = record.run_ms
        analysis.publish_report(report)
        self.reports[name] = report
        errors = report.errors()
        if errors:
            raise RuntimeError(
                f"serve step {name} failed graph lint with {len(errors)} "
                f"ERROR finding(s):\n{report.render()}")

    def lint(self, bucket: Optional[int] = None):
        """One merged :class:`~apex_tpu_torch.analysis.Report` over the
        prefill (the smallest bucket by default) and decode programs,
        with their memory sections.  It reads the build's records; a
        program not recorded yet (``verify=False``) is recorded now with
        a warm-up that writes only the null pages.  Unlike the build
        checks it never raises: findings come back for rendering."""
        from apex_tpu_torch import analysis

        s = self.serve
        bucket = bucket or s.buckets()[0]
        names = (f"prefill_{bucket}", "decode")
        reports = []
        for name in names:
            if name not in self.records:
                self._record_for_lint(name, bucket)
            record = self.records[name]
            donated = ("kv_cache",)
            reports.append(analysis.lint_graph(
                record, donated_paths=donated, hbm_budget=s.hbm_budget_bytes,
                name=f"serve/{name}"))
        report = reports[0]
        analysis.attach_shard_sections(report, [
            (f"serve/{n}", self.records[n]) for n in names])
        report.merge(reports[1])
        report.target = "serve"
        return report

    @torch.no_grad()
    def _record_for_lint(self, name: str, bucket: int) -> None:
        from apex_tpu_torch import analysis

        run = (self._idle_decode() if name == "decode"
               else self._warmups(bucket, False)[0][1])
        with _dispatch.recorded_apart():
            _, self.records[name] = analysis.capture(
                run, named=self._arguments()[0])

    # -- failure surface -----------------------------------------------------
    @staticmethod
    def _chaos_gate(site: str, call_idx: int):
        """The serving chaos hook, on the host before the call (never in
        a captured graph): ``stall`` sleeps (a hung call: the scheduler's
        decode timeouts see it), ``raise`` raises
        :class:`~apex_tpu_torch.resilience.chaos.InjectedFault`, and
        ``nan`` / ``inf`` return the fault so that the caller poisons its
        non-finite screen.  ``call_idx`` is the 0-based prefill-call,
        decode-iteration or spec-round index."""
        fault = chaos.active(site, call_idx)
        if fault is None:
            return None
        if fault.mode == "stall":
            time.sleep(fault.stall_seconds)
            return None
        if fault.mode in ("nan", "inf"):
            return fault
        raise chaos.InjectedFault(site, call_idx, fault.mode)

    def _span(self, name: str, t0, **args) -> None:
        """Record an ``engine/...`` span from ``t0`` to now, when a
        recorder is attached."""
        rec = self.spans
        if rec is not None:
            rec.span(name, t0, rec.now(), track=TRACK_ENGINE, **args)

    def _now(self):
        return self.spans.now() if self.spans is not None else None

    @staticmethod
    def _poison_first_live(finite: np.ndarray, lengths) -> np.ndarray:
        """An injected poisoned-logits fault: the first live slot's
        screen reads non-finite, as a real non-finite row would; the
        quarantine downstream is the production path."""
        live = np.flatnonzero(np.asarray(lengths) > 0)
        if live.size:
            finite[live[0]] = False
        return finite

    @torch.no_grad()
    def rebuild(self, *, full: bool = False):
        """Supervised recovery: on the card, drop the captured decode
        graph (and the spec round's) and capture new ones — a re-capture,
        with the KV pool, its scale planes, the weights and the page pool
        left at their addresses, so surviving requests resume from their
        pages and the new graphs read the same tensors.  Each old graph
        is reset and its private memory pool released before the new
        capture, so rebuilds do not grow the allocator's reservation.  A
        replay after a rebuild gives the bits the replay before it gave.

        ``full=True`` also drops what the engine caches per prefill
        bucket; prefill runs eagerly and caches nothing per bucket, so
        it is the default rebuild.  On the CPU (no graphs) a rebuild only
        counts."""
        self.rebuilds += 1
        if self.device.type == "cuda":
            had_spec = self._spec_graph is not None
            self._release_graphs()
            self._capture_decode()
            if self.spec is not None and had_spec:
                self._capture_spec()
        board.set("serve/engine_rebuilds", self.rebuilds)
        return self

    def _release_graphs(self) -> None:
        """Reset the captured graphs and return their private memory
        pools to the card (nothing may still hold a graph's output)."""
        torch.cuda.synchronize(self.device)
        for g in (self._graph, self._spec_graph):
            if g is not None:
                g["graph"].reset()
                g.clear()
        self._graph = self._spec_graph = None
        self.last_verify_logits = None
        torch.cuda.empty_cache()

    # -- serving calls -------------------------------------------------------
    @torch.no_grad()
    def prefill(self, prompt_ids, page_ids, *, temperature: float = 0.0,
                stream: Optional[int] = None) -> Tuple[torch.Tensor, int]:
        """Run the prompt through the bucketed prefill: writes its K/V
        into ``page_ids`` (null-padded to the bucket's page count) and
        returns ``(last_logits (V,) on the device, first_token)``.  The
        first token is sampled in the step (``temperature <= 0`` is
        greedy), its noise keyed by ``stream`` when given, else by the
        call index.  Rides the ``serve.prefill`` chaos site."""
        poison = self._chaos_gate(chaos.SERVE_PREFILL, self.prefill_calls)
        n = len(prompt_ids)
        bucket = self.bucket_for(n)
        np_b = bucket // self.serve.page_size
        tokens = np.zeros((bucket, 1), np.int64)
        tokens[:n, 0] = np.asarray(prompt_ids, np.int64)
        ids = np.full((np_b,), cache_lib.NULL_PAGE, np.int64)
        ids[: len(page_ids)] = np.asarray(page_ids, np.int64)
        keys = self._prefill_keys(stream)
        t0 = self._now()
        logits, next_token, finite, self.cache = model_lib.prefill_body(
            self.cfg, self.weights, self.cache,
            self._tensor(tokens, torch.int64), n,
            self._tensor(ids, torch.int64),
            self._tensor(temperature, torch.float32), keys,
            page_size=self.serve.page_size, kv_wire=self.serve.kv_wire,
            top_k=self.serve.top_k,
        )
        self.prefill_calls += 1
        out = torch.stack([next_token, finite.long()]).cpu()  # lint: allow(host-sync): its token
        self.last_prefill_finite = bool(out[1]) and poison is None
        # the readback above waited for the card: the span covers the
        # device time
        self._span("engine/prefill", t0, bucket=bucket, tokens=n,
                   call=self.prefill_calls)
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
        :attr:`last_prefill_finite`, as for :meth:`prefill`, and it rides
        the ``serve.prefill`` chaos site."""
        poison = self._chaos_gate(chaos.SERVE_PREFILL, self.prefill_calls)
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
        t0 = self._now()
        logits, next_token, finite, self.cache = model_lib.chunk_prefill_body(
            self.cfg, self.weights, self.cache,
            self._tensor(tokens, torch.int64), n, int(offset),
            self._tensor(ids, torch.int64), self._tensor(table, torch.int64),
            self._tensor(temperature, torch.float32), keys,
            page_size=self.serve.page_size, kv_wire=self.serve.kv_wire,
            top_k=self.serve.top_k,
        )
        self.prefill_calls += 1
        out = torch.stack([next_token, finite.long()]).cpu()  # lint: allow(host-sync): its token
        self.last_prefill_finite = bool(out[1]) and poison is None
        self._span("engine/prefill", t0, bucket=bucket, tokens=n,
                   offset=int(offset), call=self.prefill_calls, chunked=True)
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

    def _capture(self, compute, width: int, verify: Optional[str] = None,
                 spec: bool = False) -> dict:
        """Run ``compute`` once on the engine's side stream over an
        all-zero input (every slot idle: it writes only the null pages),
        then capture it into a CUDA graph over a static ``(max_batch,
        width)`` int64 input on the same stream.  The launch counters and
        the path log are left as they were; the launches and paths of the
        captured step are kept, and every replay adds them.  One stream
        for every capture of the engine's life: cuBLAS keeps a workspace
        per stream, so a new stream at each re-capture would grow the
        allocator's reservation by one workspace a rebuild."""
        dev = self.device
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        side = self._side
        inp = torch.zeros((self.serve.max_batch, width), dtype=torch.int64,
                          device=dev)
        staging = torch.zeros(inp.shape, dtype=torch.int64, pin_memory=True)
        with _dispatch.recorded_apart():
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                if verify:
                    # the build checks record this warm-up (no second run)
                    self._warm(verify, lambda: compute(inp), spec=spec)
                else:
                    compute(inp)
            torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _dispatch.recorded_apart() as rec:
            with torch.cuda.graph(graph, stream=side):
                outs = compute(inp)
        if not rec["launches"]:
            raise RuntimeError("the captured step launched no kernel")
        return dict(graph=graph, inp=inp, staging=staging, outs=outs,
                    record=rec)

    @staticmethod
    def _replay(g: dict, arr: np.ndarray):
        """One copy of ``arr`` into the graph's input, one replay, its
        launches counted; returns the graph's outputs."""
        g["staging"].numpy()[...] = arr  # lint: allow(host-sync): host buffer
        g["inp"].copy_(g["staging"], non_blocking=True)
        g["graph"].replay()
        _dispatch.replay_record(g["record"])
        return g["outs"]

    @torch.no_grad()
    def _capture_decode(self, verify: bool = False) -> None:
        """Capture the decode step (:meth:`_capture`); ``verify`` records
        and lints its warm-up (the build's checks)."""
        self._graph = self._capture(
            self._decode_compute, _COLS + self.serve.max_pages_per_seq,
            verify="decode" if verify else None)
        self.captures["decode"] = self.captures.get("decode", 0) + 1

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
        lands on :attr:`last_decode_finite`.  Rides the ``serve.decode``
        chaos site, its gate on the host before the replay."""
        poison = self._chaos_gate(chaos.SERVE_DECODE, self.decode_iters)
        arr = self._decode_input(tokens, lengths, page_tables, temps,
                                 streams, gens)
        self.decode_iters += 1
        t0 = self._now()
        if self.device.type == "cuda":
            if self._graph is None:
                self._capture_decode()
            logits, out = self._replay(self._graph, arr)
            logits, out = logits.clone(), out.cpu()  # lint: allow(host-sync): tokens
        else:
            logits, out = self._decode_compute(torch.from_numpy(arr))
        out = out.numpy()  # lint: allow(host-sync): already on the host
        finite = out[1].astype(bool)
        if poison is not None:
            finite = self._poison_first_live(finite, lengths)
        self.last_decode_finite = finite
        # the readback above waited for the card
        self._span("engine/decode", t0, iter=self.decode_iters,
                   batch=int((np.asarray(lengths) > 0).sum()))
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
        out = out.cpu().numpy()  # lint: allow(host-sync): the step's tokens
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
        for cache in (self.cache, self.draft_cache or {}):
            for name, t in cache.items():
                t.fill_(1 if name.endswith("_scale") else 0)

    @torch.no_grad()
    def probe_stream(self, prompt_ids, max_new_tokens: int):
        """The golden-probe hook: run ONE prompt greedily through prefill
        and a single-slot decode loop and return ``(tokens,
        prefill_logits_bytes, finite)`` — the raw material of a model
        fingerprint (greedy argmax ignores the sampler's noise, so the
        stream is a function of the weights and the steps; the prefill's
        last logits as f32 bytes make a digest sensitive to changes too
        small to flip an argmax).  Pages come from the engine's own pool
        and are freed before returning: probe a quiet engine.  ``finite``
        folds in the non-finite screens."""
        n = len(prompt_ids)
        total = n + int(max_new_tokens)
        if total > self.serve.max_context:
            raise ValueError(
                f"probe needs {total} tokens of context, "
                f"max_context={self.serve.max_context}"
            )
        pages_needed = -(-total // self.serve.page_size)
        page_ids = self.pool.alloc(pages_needed)
        if page_ids is None:
            raise RuntimeError(
                f"probe_stream: page pool exhausted ({pages_needed} pages "
                f"needed) — probe a quiet engine"
            )
        try:
            # prefill takes the prompt's pages; decode reaches the growth
            # pages through the full page-table row
            prompt_pages = page_ids[: -(-n // self.serve.page_size)]
            logits, first = self.prefill(prompt_ids, prompt_pages)
            logits_bytes = logits.float().cpu().numpy().tobytes()  # lint: allow(host-sync): hashed
            finite = bool(self.last_prefill_finite)
            tokens = [first]
            b = self.serve.max_batch
            table = np.full((b, self.serve.max_pages_per_seq),
                            cache_lib.NULL_PAGE, np.int32)
            table[0, :pages_needed] = np.asarray(page_ids, np.int32)
            for i in range(int(max_new_tokens) - 1):
                tok = np.zeros((b,), np.int64)
                lengths = np.zeros((b,), np.int32)
                tok[0] = tokens[-1]
                lengths[0] = n + i + 1  # context incl. the fed token
                _, next_tokens = self.decode(tok, lengths, table)
                finite = finite and bool(self.last_decode_finite[0])
                tokens.append(int(next_tokens[0]))
        finally:
            self.pool.free(page_ids)
        return tokens, logits_bytes, finite

    # -- speculative decoding ------------------------------------------------
    def _need_spec(self) -> spec_lib.SpecConfig:
        if self.spec is None:
            raise ValueError("engine has no speculative config")
        return self.spec

    def _draft_prefill_body(self, tokens, length, ids):
        return model_lib.prefill_body(
            self.draft_cfg, self.draft_weights, self.draft_cache, tokens,
            length, ids, page_size=self.serve.page_size,
            kv_wire=self.serve.kv_wire)

    @torch.no_grad()
    def draft_prefill(self, prompt_ids, page_ids) -> None:
        """Prefill the draft's KV for a prompt into the request's draft
        pages (its greedy token is discarded: the target's prefill gives
        the stream's first token).  Counted on
        :attr:`draft_prefill_calls`, not on the target's counters."""
        self._need_spec()
        n = len(prompt_ids)
        bucket = self.bucket_for(n)
        tokens = np.zeros((bucket, 1), np.int64)
        tokens[:n, 0] = np.asarray(prompt_ids, np.int64)
        ids = np.full((bucket // self.serve.page_size,), cache_lib.NULL_PAGE,
                      np.int64)
        ids[: len(page_ids)] = np.asarray(page_ids, np.int64)
        self._draft_prefill_body(self._tensor(tokens, torch.int64), n,
                                 self._tensor(ids, torch.int64))
        self.draft_prefill_calls += 1

    def _spec_input(self, tokens, lengths, page_tables, draft_tables, temps,
                    streams, gens, draft_poisoned=False) -> np.ndarray:
        """The spec round's inputs as one int64 host array (B, 6 + 2 NP):
        token, length, the temperature's f32 bits, the stream folded to
        31 bits, the generation index, the draft's poison threshold (2
        when ``draft_poisoned``, else 1), the target's and the draft's
        page tables."""
        s = self.serve
        b, np_ = s.max_batch, s.max_pages_per_seq
        arr = np.zeros((b, _SPEC_COLS + 2 * np_), np.int64)
        arr[:, 0] = np.asarray(tokens, np.int64)
        arr[:, 1] = np.asarray(lengths, np.int64)
        t = (np.zeros(b, np.float32) if temps is None
             else np.asarray(temps, np.float32).reshape(b))
        arr[:, 2] = t.view(np.int32)
        arr[:, 3] = model_lib.fold31(np.asarray(streams, np.int64)
                                     & 0xFFFFFFFF)
        arr[:, 4] = np.asarray(gens, np.int64)
        arr[:, 5] = 2 if draft_poisoned else 1
        arr[:, _SPEC_COLS:_SPEC_COLS + np_] = np.asarray(page_tables,
                                                          np.int64)
        arr[:, _SPEC_COLS + np_:] = np.asarray(draft_tables, np.int64)
        return arr

    def _spec_compute(self, inp: torch.Tensor) -> torch.Tensor:
        """One spec round on an input laid out as :meth:`_spec_input`'s:
        the draft's ``k + 1`` steps, the pin of a non-finite draft's
        proposals, the target's ``k + 1`` verify steps and the
        acceptance.  Returns the verify logits ``(k + 1, B, V)`` and
        ``(B, k + 3)`` int64: the tokens, n_accept and the finite screen
        (one readback)."""
        s, k = self.serve, self.spec.k
        np_ = s.max_pages_per_seq
        tokens = inp[:, 0].contiguous()
        lengths = inp[:, 1].to(torch.int32).contiguous()
        temps = inp[:, 2].to(torch.int32).view(torch.float32)
        streams, gens = inp[:, 3].contiguous(), inp[:, 4].contiguous()
        tables = inp[:, _SPEC_COLS:_SPEC_COLS + np_].to(torch.int32)
        dtables = inp[:, _SPEC_COLS + np_:].to(torch.int32)
        d_tokens, d_probs, d_finite = spec_lib.draft_body(
            self.draft_cfg, self.draft_weights, self.draft_cache, tokens,
            lengths, dtables.contiguous(), temps, s.sample_seed, streams,
            gens, k=k, page_size=s.page_size, kv_wire=s.kv_wire,
            top_k=s.top_k)
        if k:
            # a non-finite (or chaos-poisoned) draft must not smuggle a
            # token into the stream: its proposals are pinned to one id
            # with the matching point-mass distribution, which the
            # rejection sampler handles like any q (greedy emits only the
            # argmax chain), so such a round degrades to ~zero
            # acceptance.  A row is bad where finite (0 or 1) is under
            # its threshold (1; 2 under a serve.draft nan/inf fault): one
            # comparison, the op count of a plain negation
            pin = self.cfg.vocab_size - 1
            bad = torch.lt(d_finite, inp[:, 5])
            d_tokens = torch.where(bad[:, None],
                                   torch.full_like(d_tokens, pin), d_tokens)
            point = (torch.arange(d_probs.shape[-1], device=bad.device)
                     == pin).float()
            d_probs = torch.where(bad[None, :, None], point, d_probs)
        logits, out, n_accept, finite = spec_lib.verify_body(
            self.cfg, self.weights, self.cache, tokens, d_tokens, lengths,
            tables.contiguous(), temps, d_probs, s.sample_seed, streams,
            gens, page_size=s.page_size, kv_wire=s.kv_wire, top_k=s.top_k)
        return logits, torch.cat(
            [out, n_accept[:, None], finite.long()[:, None]], dim=1)

    @torch.no_grad()
    def _capture_spec(self, verify: bool = False) -> None:
        """Capture the spec round (:meth:`_capture`)."""
        self._spec_graph = self._capture(
            self._spec_compute, _SPEC_COLS + 2 * self.serve.max_pages_per_seq,
            verify="spec" if verify else None, spec=True)
        self.captures["spec"] = self.captures.get("spec", 0) + 1

    @property
    def spec_graph_launches(self) -> dict:
        """Kernel -> launches in one replay of the captured spec round
        (empty before the capture, and on the CPU)."""
        g = self._spec_graph
        return dict(g["record"]["launches"]) if g else {}

    @torch.no_grad()
    def spec_step(self, tokens, lengths, page_tables, draft_tables, temps,
                  streams, gens):
        """One speculative round over the full slot array: the draft
        proposes ``k`` tokens per live slot, the target scores ``k + 1``
        positions and the acceptance runs on the device.  ``lengths``
        counts each slot's context including the fed token (0 = idle);
        ``draft_tables`` are the slots' draft pages.  Each slot's draws
        are keyed by its stream and the emission index ``gens + j``.  On
        the card the round is one replay of a captured CUDA graph (one
        input copy, one readback).  Returns ``(out_tokens (B, k+1),
        n_accept (B,), finite (B,))`` on the host: slot ``b`` emits
        ``out_tokens[b, :n_accept[b] + 1]``; the screen also lands on
        :attr:`last_decode_finite`, and the target's logits ``(k + 1, B,
        V)`` on the device on :attr:`last_verify_logits` (on the card the
        graph's own output: valid until the next round).

        Rides the ``serve.draft`` chaos site (indexed by the round,
        counted on attempts: a raise burns its index) — ``raise`` raises
        before the round runs (the scheduler decodes those slots plain),
        ``nan``/``inf`` pin every proposal (zero acceptance, never a
        corrupt token) — and the ``serve.decode`` site for the verify, as
        :meth:`decode`."""
        spec = self._need_spec()
        k = spec.k
        round_idx = self.spec_rounds
        self.spec_rounds += 1
        draft_fault = self._chaos_gate(chaos.SERVE_DRAFT, round_idx)
        poison = self._chaos_gate(chaos.SERVE_DECODE, self.decode_iters)
        arr = self._spec_input(tokens, lengths, page_tables, draft_tables,
                               temps, streams, gens,
                               draft_poisoned=draft_fault is not None)
        self.decode_iters += 1
        t0 = self._now()
        if self.device.type == "cuda":
            if self._spec_graph is None:
                self._capture_spec()
            logits, out = self._replay(self._spec_graph, arr)
            out = out.cpu()  # lint: allow(host-sync): the round's tokens
        else:
            logits, out = self._spec_compute(torch.from_numpy(arr))
        self.last_verify_logits = logits
        out = out.numpy()  # lint: allow(host-sync): already on the host
        finite = out[:, k + 2].astype(bool)
        if poison is not None:
            finite = self._poison_first_live(finite, lengths)
        self.last_decode_finite = finite
        acc = out[:, k + 1]
        live = int((np.asarray(lengths) > 0).sum())
        self._span("engine/decode", t0, iter=self.decode_iters, batch=live,
                   spec=True, drafted=k * live, accepted=int(acc.sum()))
        return out[:, : k + 1], acc, finite

    def _rollback(self, cache, starts, counts, page_tables) -> None:
        s = self.serve
        spec_lib.rollback_body(
            cache, self._tensor(starts, torch.int64),
            self._tensor(counts, torch.int64),
            self._tensor(page_tables, torch.int64),
            k=self._need_spec().k + 1, page_size=s.page_size)

    def rollback(self, starts, counts, page_tables) -> None:
        """Zero the target KV rows of rejected positions ``[starts[b],
        starts[b] + counts[b])`` through each slot's page table, in place
        and eagerly (:func:`~apex_tpu_torch.serve.spec.rollback_body`:
        indexed writes, no kernel of the port).  The scheduler forked any
        shared tail page before the round, so every touched page is
        private."""
        self._rollback(self.cache, starts, counts, page_tables)

    def draft_rollback(self, starts, counts, page_tables) -> None:
        """:meth:`rollback` for the draft's KV pool (draft page ids)."""
        self._rollback(self.draft_cache, starts, counts, page_tables)

    @torch.no_grad()
    def update_draft_params(self, draft_params) -> None:
        """Load new draft weights in place (cast to the draft's dtype, or
        packed on the int8 weight wire), so a captured spec round keeps
        its addresses.  ``None`` means no new draft: a self-draft already
        reads the engine's own weights.  The draft must have the engine's
        draft architecture; a self-draft engine takes none (its draft is
        its target)."""
        spec = self._need_spec()
        if draft_params is None:
            return
        if spec.draft_params is None:
            raise ValueError(
                "a self-draft engine's draft is its target: build an engine "
                "with a separate draft to load draft weights"
            )
        if draft_params.cfg != self.draft_cfg:
            raise ValueError("the new draft's config differs from the "
                             "engine's draft")
        if self.serve.weight_wire == "int8":
            new = model_lib.PackedParams(self.draft_cfg, draft_params)
            for dst, src in zip(self.draft_weights.leaves(), new.leaves()):
                if isinstance(dst, model_lib.PackedWeight):
                    dst.codes.copy_(src.codes)
                    dst.scale.copy_(src.scale)
                else:
                    dst.copy_(src)
        else:
            src = dict(draft_params.named_parameters())
            for name, dst in self.draft_weights.named_parameters():
                dst.copy_(src[name])

"""Serving — paged KV cache, inference engine, continuous batching.

Counterpart of :mod:`apex_tpu.serve`'s core:

- :mod:`apex_tpu_torch.serve.cache` — :class:`PagePool`,
  :class:`PrefixCache` and the paged KV pool tensors ``(L, P, H, page,
  D)``, on the model dtype or the int8 KV wire;
- :mod:`apex_tpu_torch.serve.model` — the functional prefill, chunked
  prefill and decode forward over :class:`~apex_tpu_torch.models.GptModel`
  weights or the int8 weight wire, and the fused sampler;
- :mod:`apex_tpu_torch.serve.spec` — speculative decoding's
  :class:`SpecConfig`, the draft, verify and rollback bodies and the
  acceptance rule;
- :mod:`apex_tpu_torch.serve.engine` — :class:`InferenceEngine` (the
  decode step and the spec round as CUDA graphs on the card) and
  :class:`ServeConfig`;
- :mod:`apex_tpu_torch.serve.scheduler` —
  :class:`ContinuousBatchingScheduler` (retries, engine supervision, the
  overload ladder, drain and resume, TTFT attribution) and
  :class:`Request`.
"""

from apex_tpu_torch.serve.cache import (  # noqa: F401
    NULL_PAGE,
    PagePool,
    PrefixCache,
    append_token_kv,
    encode_kv,
    init_kv_pages,
    prefix_keys,
    pack_prompt_pages,
    write_prompt_pages,
)
from apex_tpu_torch.serve.engine import (  # noqa: F401
    InferenceEngine,
    ServeConfig,
)
from apex_tpu_torch.serve.model import (  # noqa: F401
    WEIGHT_WIRE_MIN_SIZE,
    PackedParams,
    PackedWeight,
    chunk_prefill_body,
    decode_body,
    dequantize_params,
    prefill_body,
    quantize_params,
    rope_tables,
    sample_tokens,
    validate_config,
)
from apex_tpu_torch.serve.spec import (  # noqa: F401
    SpecConfig,
    draft_from_params,
    speculative_verify,
    target_probs,
)
from apex_tpu_torch.serve.scheduler import (  # noqa: F401
    SHED_REASONS,
    SHED_REROUTED,
    TTFT_COMPONENTS,
    ContinuousBatchingScheduler,
    Request,
    declare_serve_metrics,
    ttft_attribution,
)

"""Serving — paged KV cache, inference engine, continuous batching.

Counterpart of :mod:`apex_tpu.serve` for the greedy serving path:

- :mod:`apex_tpu_torch.serve.cache` — :class:`PagePool` and the paged KV
  pool tensors ``(L, P, H, page, D)``;
- :mod:`apex_tpu_torch.serve.model` — the functional prefill/decode
  forward over :class:`~apex_tpu_torch.models.GptModel` weights;
- :mod:`apex_tpu_torch.serve.engine` — :class:`InferenceEngine` and
  :class:`ServeConfig`;
- :mod:`apex_tpu_torch.serve.scheduler` —
  :class:`ContinuousBatchingScheduler` and :class:`Request`.
"""

from apex_tpu_torch.serve.cache import (  # noqa: F401
    NULL_PAGE,
    PagePool,
    append_token_kv,
    init_kv_pages,
    pack_prompt_pages,
    write_prompt_pages,
)
from apex_tpu_torch.serve.engine import (  # noqa: F401
    InferenceEngine,
    ServeConfig,
)
from apex_tpu_torch.serve.model import (  # noqa: F401
    decode_body,
    prefill_body,
    validate_config,
)
from apex_tpu_torch.serve.scheduler import (  # noqa: F401
    SHED_REASONS,
    ContinuousBatchingScheduler,
    Request,
)

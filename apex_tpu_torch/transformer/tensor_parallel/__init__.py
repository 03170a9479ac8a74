"""Tensor-parallel layers of the port (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel`); so far the cross entropy
and the RNG tracker (``random``) at tp = 1."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (  # noqa: F401
    vocab_parallel_cross_entropy,
)

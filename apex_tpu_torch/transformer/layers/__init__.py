"""The persist-LN selector — counterpart of
``apex_tpu/transformer/layers`` (≙ ``apex/transformer/layers``).

The reference picks contrib ``FastLayerNorm`` where it is built and the
hidden size is in its table, else ``FusedLayerNorm``.  The port's K1/K2
take every width, so the selector is the identity, as in the JAX
package."""

from apex_tpu_torch.normalization import (  # noqa: F401
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedLayerNorm,
    MixedFusedRMSNorm,
)

#: ≙ transformer.layers.FastLayerNorm: the same kernels underneath
FastLayerNorm = FusedLayerNorm

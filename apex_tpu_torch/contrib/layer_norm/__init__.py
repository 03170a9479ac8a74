"""≙ apex/contrib/layer_norm — ``FastLayerNorm`` (counterpart of
``apex_tpu/contrib/layer_norm``).

The reference's FastLayerNorm is a persistent-kernel LayerNorm for a
table of hidden sizes; the port's K1/K2 already pick their launch by
hidden size (``ops/layer_norm.py`` :: ``norm_launch_plan``), so the
"fast" module is :class:`~apex_tpu_torch.normalization.FusedLayerNorm`.
"""

from apex_tpu_torch.normalization import FusedLayerNorm as FastLayerNorm  # noqa: F401
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine  # noqa: F401

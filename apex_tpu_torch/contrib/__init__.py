"""Contrib features — counterpart of :mod:`apex_tpu.contrib`.

Ported so far:

- :mod:`apex_tpu_torch.contrib.openfold` — the OpenFold surface: the
  fused attention and LayerNorm under their OpenFold names, the dynamic
  axial parallelism collectives, ``DAPAxialBlock`` and the evoformer
  modules (each with ``axis_name``);
- :mod:`apex_tpu_torch.contrib.optimizers` — ``DistributedFusedAdam``
  and ``DistributedFusedLamb`` (ZeRO);
- :mod:`apex_tpu_torch.contrib.multihead_attn` — ``SelfMultiheadAttn``
  and ``EncdecMultiheadAttn`` over K1–K4;
- :mod:`apex_tpu_torch.contrib.fmha` — packed attention over a padded
  batch with ``seqlens``;
- :mod:`apex_tpu_torch.contrib.layer_norm` (``FastLayerNorm``),
  :mod:`apex_tpu_torch.contrib.xentropy` and
  :mod:`apex_tpu_torch.contrib.clip_grad` — re-exports.
"""

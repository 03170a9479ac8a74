"""Contrib features — counterpart of :mod:`apex_tpu.contrib`.

Ported so far:

- :mod:`apex_tpu_torch.contrib.openfold` — the OpenFold surface: the
  fused attention and LayerNorm under their OpenFold names, the dynamic
  axial parallelism collectives, ``DAPAxialBlock`` and the evoformer
  modules (each with ``axis_name``);
- :mod:`apex_tpu_torch.contrib.optimizers` — ``DistributedFusedAdam``
  and ``DistributedFusedLamb`` (ZeRO).
"""

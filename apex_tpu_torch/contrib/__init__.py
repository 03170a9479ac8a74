"""Contrib features — counterpart of :mod:`apex_tpu.contrib`.

Ported so far:

- :mod:`apex_tpu_torch.contrib.openfold` — the OpenFold surface: the
  fused attention and LayerNorm under their OpenFold names,
  ``DAPAxialBlock`` and the evoformer modules (one card; the dynamic
  axial parallelism collectives are the rest of ROADMAP item 5);
- :mod:`apex_tpu_torch.contrib.optimizers` — ``DistributedFusedAdam``
  and ``DistributedFusedLamb`` (ZeRO).
"""

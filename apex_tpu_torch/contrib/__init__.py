"""Contrib features — counterpart of :mod:`apex_tpu.contrib` (≙
``apex/contrib``).

Upstream gates each feature behind a build flag and a try-import; here
every package is importable, in plain PyTorch or over the port's
kernels, each under the reference's path and names:

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
  :mod:`apex_tpu_torch.contrib.clip_grad` — re-exports;
- :mod:`apex_tpu_torch.contrib.conv_bias_relu` — convolution + bias
  (+ ReLU, + mask) on NHWC activations (cuDNN's channels-last kernels);
- :mod:`apex_tpu_torch.contrib.group_norm` — NHWC GroupNorm with an
  optional SiLU, f32 statistics;
- :mod:`apex_tpu_torch.contrib.groupbn` — ``BatchNorm2d_NHWC`` with the
  fused ReLU and residual add, statistics over a ``bn_group`` of ranks;
  :mod:`apex_tpu_torch.contrib.cudnn_gbn` — the same class as
  ``GroupBatchNorm2d``;
- :mod:`apex_tpu_torch.contrib.bottleneck` — the ResNet bottleneck and
  ``SpatialBottleneck`` (H split over ranks, halo rows exchanged);
- :mod:`apex_tpu_torch.contrib.peer_memory` and
  :mod:`apex_tpu_torch.contrib.nccl_p2p` — halo exchange over a
  parallel axis (``comm.shift``); ``PeerMemoryPool`` holds nothing;
- :mod:`apex_tpu_torch.contrib.focal_loss` — the sigmoid focal loss;
- :mod:`apex_tpu_torch.contrib.index_mul_2d` — the gather-multiply,
  accumulating over repeated indices in the backward;
- :mod:`apex_tpu_torch.contrib.transducer` — the RNN-T joint and loss
  (alpha and beta over the lattice's anti-diagonals);
- :mod:`apex_tpu_torch.contrib.sparsity` — ASP 2:4 masks along the
  input axis and the channel-permutation search;
- :mod:`apex_tpu_torch.contrib.nccl_allocator` — no-ops, and
  :mod:`apex_tpu_torch.contrib.gpu_direct_storage` — refusals that point
  at the port's checkpoint engine.
"""

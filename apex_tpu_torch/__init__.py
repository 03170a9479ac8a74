"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu for NVIDIA Hopper.

The second package beside :mod:`apex_tpu`: the same module names, the
same public functions, the same numerics, with PyTorch for the plain
tensor code and a hand-written CUDA C++ kernel (``csrc/``, built for
``sm_90a``) wherever the JAX package wrote a Pallas TPU kernel.  It
never imports JAX or :mod:`apex_tpu`; only the parity tests import both.

Subpackages
-----------
- :mod:`apex_tpu_torch.ops` — fused LayerNorm/RMSNorm (forward and
  backward), RoPE, flash attention (forward and backward, and packed
  QKV) and paged decode attention, each kernel with its plain PyTorch
  twin, the plain softmax cross entropy and scaled softmaxes, plus the
  device rule, the kernel build and the launch counters
  (``ops._dispatch``, ``ops._build``).
- :mod:`apex_tpu_torch.models` — GPT, BERT and ResNet-50 (f32 weights,
  the training forward and losses, the remat policies) and the
  converters to and from the JAX parameter trees.
- :mod:`apex_tpu_torch.normalization` — ``FusedLayerNorm`` and
  ``FusedRMSNorm`` over K1/K2, ``InstanceNorm3d``.
- :mod:`apex_tpu_torch.parallel_state` — the ``(dp, pp, cp, tp)``
  process groups.
- :mod:`apex_tpu_torch.transformer` — tensor and sequence parallelism
  (the mappings, the Column/Row/VocabParallel layers, the vocab-parallel
  cross entropy, the RNG tracker and RNG-correct checkpoint), the enums,
  ``FusedScaleMaskSoftmax`` and the remat policy resolution.
- :mod:`apex_tpu_torch.optimizers` — FusedAdam, FusedLAMB, FusedSGD,
  FusedAdagrad, FusedNovoGrad, FusedMixedPrecisionLamb, LARC,
  ``clip_grad_norm`` and the ``by_name`` registry;
  :mod:`apex_tpu_torch.multi_tensor_apply` the applier, ``flatten`` and
  ``unflatten``.
- :mod:`apex_tpu_torch.data` — token files, the synthetic corpus, the
  sharded shuffling loader, the BERT batches and ``DevicePrefetcher``.
- :mod:`apex_tpu_torch.parallel` — data parallelism: the gradient-sync
  engine (three wires, chunking, plans, the collective call log, the
  int8 codec the serving wires use too), DDP, ZeRO Adam/LAMB,
  SyncBatchNorm and the process group's start-up.
- :mod:`apex_tpu_torch.serve` — paged KV cache (bf16/f32 or int8 pages),
  prefix cache, inference engine (sampling, chunked prefill, the decode
  step and the speculative round as CUDA graphs) and continuous-batching
  scheduler.
- :mod:`apex_tpu_torch.checkpoint` — step-numbered checkpoints on
  ``torch.distributed.checkpoint`` with the commit-marker rule, and the
  training state (params, optimizer state, step, RNG streams, stream
  cursor) in one tree; at world size > 1 every rank writes its own
  shards.
- :mod:`apex_tpu_torch.goodput` — the async checkpoint engine and the
  resumable batch stream.
- :mod:`apex_tpu_torch.resilience` — chaos fault injection, retry,
  ``run_resilient`` (auto-resume, preemption, rollback) and the guarded
  amp update.
- :mod:`apex_tpu_torch.observability` — the metric registry, spans, the
  flight recorder, the health rules, the step meters and the lock-order
  sanitizer.
- :mod:`apex_tpu_torch.train` — the composable trainer (``TrainConfig``,
  ``Trainer.build``/``verify``/``fit``, ``build_guarded``).
- :mod:`apex_tpu_torch.amp` — the opt-level policies and the loss
  scalers.
- :mod:`apex_tpu_torch.mlp`, :mod:`apex_tpu_torch.fused_dense`,
  :mod:`apex_tpu_torch.RNN` and :mod:`apex_tpu_torch.reparameterization`
  — the fused MLP and dense layers (cuBLAS products), the recurrent
  networks, weight norm; :mod:`apex_tpu_torch.utils` — the tracing
  hooks under their old names; ``apex_tpu_torch._native`` — the host
  C++ ops (flatten, row gather, MLM corruption) the data loader calls.
- :mod:`apex_tpu_torch.analysis` — the rule tables and findings the
  trainer's verification reads.
- :mod:`apex_tpu_torch.examples` — ``train_gpt``, ``pretrain_bert``,
  ``distributed_data_parallel``, ``imagenet.main_amp`` and the others.
- :mod:`apex_tpu_torch.contrib` — the OpenFold surface (``mha``,
  ``layer_norm``, the DAP collectives, ``DAPAxialBlock``, the evoformer
  modules), the ZeRO optimizers under their contrib names, ``fmha``,
  ``multihead_attn``, ``layer_norm``, ``xentropy`` and ``clip_grad``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.
"""

__version__ = "0.1.0"

_LAZY_SUBMODULES = ("ops", "models", "transformer", "optimizers", "data",
                    "parallel", "parallel_state", "serve", "examples",
                    "contrib", "checkpoint", "goodput", "resilience",
                    "observability", "train", "amp", "analysis",
                    "normalization", "multi_tensor_apply", "fp16_utils",
                    "mlp", "fused_dense", "RNN", "reparameterization",
                    "utils")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib

        module = importlib.import_module(f"apex_tpu_torch.{name}")
        globals()[name] = module
        return module
    raise AttributeError(f"module 'apex_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals().keys()) + list(_LAZY_SUBMODULES))

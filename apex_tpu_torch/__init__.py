"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu for NVIDIA Hopper.

The second package beside :mod:`apex_tpu`: the same module names, the
same public functions, the same numerics, with PyTorch for the plain
tensor code and a hand-written CUDA C++ kernel (``csrc/``, built for
``sm_90a``) wherever the JAX package wrote a Pallas TPU kernel.  It
never imports JAX or :mod:`apex_tpu`; only the parity tests import both.

Subpackages
-----------
- :mod:`apex_tpu_torch.ops` — fused LayerNorm/RMSNorm (forward and
  backward), RoPE, flash attention (forward and backward) and paged
  decode attention, each kernel with its plain PyTorch twin, plus the
  device rule, the kernel build and the launch counters
  (``ops._dispatch``, ``ops._build``).
- :mod:`apex_tpu_torch.models` — ``GptConfig`` / ``GptModel`` (f32
  weights, the training forward, ``gpt_lm_loss``) and the converters to
  and from a JAX ``GptModel.init`` parameter tree.
- :mod:`apex_tpu_torch.transformer` — the cross entropy at tp = 1.
- :mod:`apex_tpu_torch.optimizers` — ``FusedAdam`` / ``fused_adam``.
- :mod:`apex_tpu_torch.data` — token files, the synthetic corpus and
  the sharded shuffling loader.
- :mod:`apex_tpu_torch.serve` — paged KV cache, inference engine and
  continuous-batching scheduler.
- :mod:`apex_tpu_torch.examples` — ``train_gpt``, ``pretrain_bert``.
- :mod:`apex_tpu_torch.contrib` — the OpenFold surface: ``mha``,
  ``layer_norm``, ``DAPAxialBlock`` and the evoformer modules.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.
"""

__version__ = "0.1.0"

_LAZY_SUBMODULES = ("ops", "models", "transformer", "optimizers", "data",
                    "serve", "examples", "contrib")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib

        module = importlib.import_module(f"apex_tpu_torch.{name}")
        globals()[name] = module
        return module
    raise AttributeError(f"module 'apex_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals().keys()) + list(_LAZY_SUBMODULES))

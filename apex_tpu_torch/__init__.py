"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu for NVIDIA Hopper.

The second package beside :mod:`apex_tpu`: the same module names, the
same public functions, the same numerics, with PyTorch for the plain
tensor code and a hand-written CUDA C++ kernel (``csrc/``, built for
``sm_90a``) wherever the JAX package wrote a Pallas TPU kernel.  It
never imports JAX or :mod:`apex_tpu`; only the parity tests import both.

Subpackages
-----------
- :mod:`apex_tpu_torch.ops` — fused LayerNorm/RMSNorm, RoPE, causal
  flash attention and paged decode attention, each kernel with its plain
  PyTorch twin, plus the device rule, the kernel build and the launch
  counters (``ops._dispatch``, ``ops._build``).
- :mod:`apex_tpu_torch.models` — ``GptConfig`` / ``GptModel`` and the
  converter from a JAX ``GptModel.init`` parameter tree.
- :mod:`apex_tpu_torch.serve` — paged KV cache, inference engine and
  continuous-batching scheduler.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.
"""

__version__ = "0.1.0"

_LAZY_SUBMODULES = ("ops", "models", "serve")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib

        module = importlib.import_module(f"apex_tpu_torch.{name}")
        globals()[name] = module
        return module
    raise AttributeError(f"module 'apex_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals().keys()) + list(_LAZY_SUBMODULES))

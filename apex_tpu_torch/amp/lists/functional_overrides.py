"""The op-category table for this framework's public ops.

Counterpart of ``apex_tpu/amp/lists/functional_overrides.py`` (≙
``apex/amp/lists/functional_overrides.py`` :: ``FP16_FUNCS`` /
``FP32_FUNCS`` / ``CASTS``), with the same names.  The names are the
op entry points of this package; each calls ``amp_cast(<name>, ...)``
on its tensor inputs (``focal_loss`` computes in f32 with no hook, as
the reference's does).

- **half** (FP16_FUNCS): GEMM/conv-class compute, where half precision
  runs on the tensor cores;
- **fp32** (FP32_FUNCS): reductions, losses, softmax/log/exp, whose
  numerics degrade in half precision;
- **promote** (CASTS): multi-input elementwise ops, the widest input
  dtype wins so mixed half/f32 operands do not silently truncate.
"""

from apex_tpu_torch.amp.lists._registry import register

# GEMM / conv class -> half
FP16_FUNCS = [
    "attention",
    "mlp",
    "fused_dense",
    "fused_dense_gelu_dense",
    "conv_bias_relu",
    "rnn_gemm",
]

# numerics-sensitive -> fp32.  focal_loss carries no amp_cast hook: it
# computes and returns f32 unconditionally (structurally fp32).
FP32_FUNCS = [
    "layer_norm",
    "rms_norm",
    "scaled_softmax",
    "scaled_masked_softmax",
    "xentropy",
    "focal_loss",
    "group_norm",
]

# multi-input elementwise -> promote to widest.  "add" has no single
# entry point: it is the generic promote rule for user code
# (``amp_cast("add", a, b)``).
CASTS = [
    "add",
    "index_mul_2d",
]

for _name in FP16_FUNCS:
    register(_name, "half")
for _name in FP32_FUNCS:
    register(_name, "fp32")
for _name in CASTS:
    register(_name, "promote")

"""apex_tpu_torch.amp.lists (the O1 per-op cast registry) vs the JAX
package's.

- the tables (``FP16_FUNCS``, ``FP32_FUNCS``, ``CASTS``) and every
  op's category;
- ``amp_cast`` for every registered op and an unregistered one, under
  no policy and under ``o1_patch`` with bf16 and f16, over f32, bf16
  and f16 tensors with an int tensor and None beside them: each output's
  dtype and value against the reference's on the same seeded inputs
  (exact: a cast is a rounding of the same value);
- each hooked op (``flash_attention``, ``flash_attention_with_lse``, the
  LayerNorm and RMSNorm entry points, ``softmax_cross_entropy_loss``,
  the scaled softmaxes) under ``o1_patch`` against the JAX op under its
  ``o1_patch``: the output dtype, the value (``TOL_F32`` for the f32
  ops; ``TOL_HALF`` for attention, whose bf16 operands are rounded the
  same way but whose products run in other orders), and each
  gradient's dtype (the caller's, as JAX's ``astype`` VJP gives it),
  and the identity with no policy;
- ``register``, the refusal of an unknown category, and
  ``carry_policy``: a checkpointed LayerNorm backwarded outside the
  ``o1_patch`` block (and on another thread) recomputes under the
  policy its forward saw.
"""

import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from apex_tpu.amp import lists as jlists
from apex_tpu.ops import attention as jattn
from apex_tpu.ops import layer_norm as jln
from apex_tpu_torch.amp import lists
from apex_tpu_torch.ops import attention as pattn
from apex_tpu_torch.ops import layer_norm as pln

# the packages' ops/__init__ export functions under these modules' names
jsm = importlib.import_module("apex_tpu.ops.scaled_softmax")
jxent = importlib.import_module("apex_tpu.ops.xentropy")
psm = importlib.import_module("apex_tpu_torch.ops.scaled_softmax")
pxent = importlib.import_module("apex_tpu_torch.ops.xentropy")

#: f32 ops on f32 inputs: the same formula, other summation orders
TOL_F32 = dict(rtol=1e-5, atol=1e-6)
#: bf16 attention output (8 mantissa bits): one rounding of o apart
TOL_HALF = dict(rtol=2e-2, atol=2e-2)

TORCH_OF = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "int32": torch.int32}
JNP_OF = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.float16: jnp.float16}


def _np(t):
    return t.detach().float().numpy() if t.is_floating_point() else (
        t.numpy())


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def test_tables_and_categories_are_the_references():
    assert lists.FP16_FUNCS == jlists.FP16_FUNCS
    assert lists.FP32_FUNCS == jlists.FP32_FUNCS
    assert lists.CASTS == jlists.CASTS
    for name in (*jlists.FP16_FUNCS, *jlists.FP32_FUNCS, *jlists.CASTS,
                 "not_an_op"):
        assert lists.category(name) == jlists.category(name), name


OPS = (*jlists.FP16_FUNCS, *jlists.FP32_FUNCS, *jlists.CASTS, "not_an_op")
DTYPE_SETS = (("float32",), ("bfloat16",), ("float16",),
              ("bfloat16", "float32"), ("float16", "bfloat16"),
              ("bfloat16", "float16", "float32"))


@pytest.mark.parametrize("half", [None, "bfloat16", "float16"])
@pytest.mark.parametrize("dtypes", DTYPE_SETS, ids="-".join)
@pytest.mark.parametrize("op", OPS)
def test_amp_cast_equals_the_reference(op, dtypes, half):
    rs = np.random.RandomState(len(op) + len(dtypes))
    vals = [rs.randn(3, 5).astype(np.float32) for _ in dtypes]
    ints = rs.randint(0, 7, (4,)).astype(np.int32)
    port_in = [_t(v, TORCH_OF[d]) for v, d in zip(vals, dtypes)]
    ref_in = [_j(v, JNP_OF[TORCH_OF[d]]) for v, d in zip(vals, dtypes)]
    port_in += [torch.from_numpy(ints), None]
    ref_in += [jnp.asarray(ints), None]
    if half is None:
        port_out = lists.amp_cast(op, *port_in)
        ref_out = jlists.amp_cast(op, *ref_in)
    else:
        with lists.o1_patch(TORCH_OF[half]):
            port_out = lists.amp_cast(op, *port_in)
        with jlists.o1_patch(JNP_OF[TORCH_OF[half]]):
            ref_out = jlists.amp_cast(op, *ref_in)
    assert len(port_out) == len(ref_out)
    for p, r in zip(port_out, ref_out):
        if r is None:
            assert p is None
            continue
        assert str(p.dtype).replace("torch.", "") == str(r.dtype), op
        np.testing.assert_array_equal(_np(p), np.asarray(r, np.float32)
                                      if p.is_floating_point()
                                      else np.asarray(r))


def test_single_input_comes_back_bare():
    x = torch.ones(2)
    with lists.o1_patch():
        assert lists.amp_cast("attention", x).dtype == torch.bfloat16
    assert lists.amp_cast("attention", x) is x


# ---------------------------------------------------------------------------
# the hooked ops against the JAX ops, under o1_patch and without
# ---------------------------------------------------------------------------


def _both(port_fn, ref_fn, o1):
    if not o1:
        return port_fn(), ref_fn()
    with lists.o1_patch(torch.bfloat16):
        p = port_fn()
    with jlists.o1_patch(jnp.bfloat16):
        r = ref_fn()
    return p, r


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("o1", [False, True])
@pytest.mark.parametrize("with_lse", [False, True])
def test_attention_hook(o1, with_lse):
    """f32 q/k/v: bf16 out under O1 (the half op), f32 without; the
    gradients come back f32 either way."""
    rs = np.random.RandomState(3)
    q, k, v = (rs.randn(1, 2, 16, 32).astype(np.float32) for _ in range(3))
    pq, pk, pv = (_t(a).requires_grad_() for a in (q, k, v))
    pfn = pattn.flash_attention_with_lse if with_lse else pattn.flash_attention
    jfn = jattn.flash_attention_with_lse if with_lse else jattn.flash_attention
    port, ref = _both(lambda: pfn(pq, pk, pv, causal=True),
                      lambda: jfn(_j(q), _j(k), _j(v), causal=True), o1)
    if with_lse:
        (port, port_lse), (ref, ref_lse) = port, ref
        assert port_lse.dtype == torch.float32
        np.testing.assert_allclose(_np(port_lse), np.asarray(ref_lse),
                                   **(TOL_HALF if o1 else TOL_F32))
    assert _dtype_name(port) == str(ref.dtype)
    assert port.dtype == (torch.bfloat16 if o1 else torch.float32)
    np.testing.assert_allclose(_np(port), np.asarray(ref, np.float32),
                               **(TOL_HALF if o1 else TOL_F32))
    port.float().sum().backward()
    assert all(t.grad.dtype == torch.float32 for t in (pq, pk, pv))


@pytest.mark.parametrize("o1", [False, True])
@pytest.mark.parametrize("kind", ["layer_norm_affine", "layer_norm",
                                  "rms_norm_affine", "rms_norm"])
def test_norm_hook(o1, kind):
    """bf16 rows and bf16 affines: f32 out under O1 (the fp32 op), the
    gradients in the caller's bf16; bf16 out without."""
    rs = np.random.RandomState(4)
    x = rs.randn(6, 64).astype(np.float32)
    w = (1 + 0.1 * rs.randn(64)).astype(np.float32)
    b = (0.1 * rs.randn(64)).astype(np.float32)
    g = rs.randn(6, 64).astype(np.float32)
    px = _t(x, torch.bfloat16).requires_grad_()
    pw = _t(w, torch.bfloat16).requires_grad_()
    pb = _t(b, torch.bfloat16).requires_grad_()
    jx, jw, jb = (_j(a, jnp.bfloat16) for a in (x, w, b))
    port_args, ref_args = {
        "layer_norm_affine": ((px, pw, pb), (jx, jw, jb)),
        "layer_norm": ((px,), (jx,)),
        "rms_norm_affine": ((px, pw), (jx, jw)),
        "rms_norm": ((px,), (jx,)),
    }[kind]
    pf, jf = getattr(pln, f"fused_{kind}"), getattr(jln, f"fused_{kind}")

    def port_fn():
        return pf(*port_args, 64, eps=1e-5)

    def ref_fn():
        y, vjp = jax.vjp(lambda *a: jf(*a, 64, eps=1e-5), *ref_args)
        return y, vjp(jnp.asarray(g, y.dtype))

    port, (ref, ref_grads) = _both(port_fn, ref_fn, o1)
    assert _dtype_name(port) == str(ref.dtype)
    assert port.dtype == (torch.float32 if o1 else torch.bfloat16)
    tol = TOL_F32 if o1 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(port), np.asarray(ref, np.float32), **tol)
    port.backward(_t(g, port.dtype))
    for t, r in zip(port_args, ref_grads):
        assert t.grad.dtype == torch.bfloat16
        assert str(r.dtype) == "bfloat16"
        np.testing.assert_allclose(_np(t.grad), np.asarray(r, np.float32),
                                   rtol=2e-2, atol=5e-2)


@pytest.mark.parametrize("o1", [False, True])
@pytest.mark.parametrize("kind", ["scaled_softmax", "scaled_masked_softmax",
                                  "scaled_upper_triang_masked_softmax",
                                  "generic_scaled_masked_softmax", "xentropy"])
def test_fp32_ops_hook(o1, kind):
    """bf16 in: f32 out under O1 (the fp32 ops), bf16 without (the
    losses are f32 always); the gradient in the caller's bf16."""
    rs = np.random.RandomState(5)
    if kind == "xentropy":
        x = rs.randn(8, 33).astype(np.float32)
        labels = rs.randint(0, 33, (8,)).astype(np.int32)
        px = _t(x, torch.bfloat16).requires_grad_()
        port_fn = lambda: pxent.softmax_cross_entropy_loss(  # noqa: E731
            px, torch.from_numpy(labels), smoothing=0.1)
        ref_fn = lambda: jxent.softmax_cross_entropy_loss(  # noqa: E731
            _j(x, jnp.bfloat16), jnp.asarray(labels), smoothing=0.1)
    else:
        shape = (2, 3, 8, 8) if kind != "scaled_upper_triang_masked_softmax" \
            else (3, 8, 8)
        x = rs.randn(*shape).astype(np.float32)
        mask = rs.rand(2, 1, 8, 8) < 0.3
        px = _t(x, torch.bfloat16).requires_grad_()
        pf, jf = getattr(psm, kind), getattr(jsm, kind)
        if "masked" in kind and "triang" not in kind:
            port_fn = lambda: pf(px, torch.from_numpy(mask), 0.5)  # noqa: E731
            ref_fn = lambda: jf(_j(x, jnp.bfloat16), jnp.asarray(mask),  # noqa: E731
                                0.5)
        else:
            port_fn = lambda: pf(px, 0.5)  # noqa: E731
            ref_fn = lambda: jf(_j(x, jnp.bfloat16), 0.5)  # noqa: E731
    port, ref = _both(port_fn, ref_fn, o1)
    assert _dtype_name(port) == str(ref.dtype)
    if o1 or kind == "xentropy":
        assert port.dtype == torch.float32
        np.testing.assert_allclose(_np(port), np.asarray(ref), **TOL_F32)
    else:
        assert port.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(port), np.asarray(ref, np.float32),
                                   rtol=1e-2, atol=1e-2)
    port.float().sum().backward()
    assert px.grad.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the registry's surface, and the policy carried into a recompute
# ---------------------------------------------------------------------------


def test_register_and_unregistered_passthrough():
    from apex_tpu_torch.amp.lists import _registry

    lists.register("my_custom_op", "half")
    try:
        with lists.o1_patch(torch.bfloat16):
            y = lists.amp_cast("my_custom_op", torch.ones(2))
            assert y.dtype == torch.bfloat16
            z = lists.amp_cast("unknown_op", torch.ones(2))
            assert z.dtype == torch.float32
            assert lists.active_policy() == lists.CastPolicy(torch.bfloat16)
        assert lists.active_policy() is None
    finally:
        del _registry._CATEGORY["my_custom_op"]
    with pytest.raises(ValueError, match="category must be one of"):
        lists.register("bad", "int8")


@pytest.mark.parametrize("where", ["outside", "thread"])
def test_recompute_runs_under_the_forward_policy(where):
    """A checkpointed bf16 LayerNorm run under o1_patch and backwarded
    outside the block (or on another thread, as autograd runs a CUDA
    backward): the recompute casts as the forward did, so the gradient
    equals the uncheckpointed one bit for bit; the same checkpoint
    without :func:`carry_policy` recomputes on bf16 rows and fails."""
    rs = np.random.RandomState(6)
    x0 = _t(rs.randn(4, 32), torch.bfloat16)

    def ln(x):
        return pln.fused_layer_norm(x, 32) * 2.0

    def grad_of(run):
        x = x0.clone().requires_grad_()
        with lists.o1_patch(torch.bfloat16):
            y = run(x)
        assert y.dtype == torch.float32
        loss = y.sum()
        if where == "thread":
            errors = []

            def backward():
                try:
                    loss.backward()
                except Exception as exc:  # re-raised on this thread
                    errors.append(exc)

            t = threading.Thread(target=backward)
            t.start()
            t.join()
            if errors:
                raise errors[0]
        else:
            loss.backward()
        return x.grad

    plain = grad_of(ln)
    carried = grad_of(lambda x: checkpoint(lists.carry_policy(ln), x,
                                           use_reentrant=False))
    assert plain is not None and carried is not None
    assert torch.equal(plain, carried)
    with pytest.raises(torch.utils.checkpoint.CheckpointError,
                       match="different metadata"):
        grad_of(lambda x: checkpoint(ln, x, use_reentrant=False))

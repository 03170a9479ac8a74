"""apex_tpu_torch gradients of the fused ops vs ``jax.vjp`` of the JAX
package.

The same seeded numpy inputs and output cotangents go through the JAX
functions (forced onto their Pallas kernels in interpret mode where the
shape allows, as ``test_torch_attention.py`` does) and through the
port's autograd, whose CPU path runs the plain twins of kernels K1-K4 —
the functions the kernels are held against on the card:

- LayerNorm / RMSNorm, ``memory_efficient`` on and off, f32 and bf16;
- flash attention: causal and not, Sq != Sk both ways, fully-masked rows
  (Sq > Sk), and the lse cotangent of ``flash_attention_with_lse``;
- RoPE (``fused_apply_rotary_pos_emb_cached``, its JAX ``custom_vjp``);
- the vocab cross entropy at tp = 1, label smoothing 0 and 0.1.

Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _dispatch as jax_dispatch
from apex_tpu.ops import attention as jax_attn
from apex_tpu.ops import layer_norm as jax_ln
from apex_tpu.ops.rope import fused_apply_rotary_pos_emb_cached as jax_rope
from apex_tpu.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy as jax_ce,
)
from apex_tpu_torch.ops import _dispatch
from apex_tpu_torch.ops import attention as port_attn
from apex_tpu_torch.ops import layer_norm as port_ln
from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb_cached
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy,
)

#: f32: the two frameworks sum rows and dots in different orders
F32_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs several workers
    at once, and some of their tests time the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def force_pallas():
    jax_dispatch.set_use_pallas(True)
    yield
    jax_dispatch.set_use_pallas(None)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _grads(fn, arrays, cotangent):
    """Port gradients of ``fn`` w.r.t. each numpy array in ``arrays``
    for the output cotangent ``cotangent`` (a tensor or tuple)."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    return torch.autograd.grad(out, ts, cotangent)


# ---------------------------------------------------------------------------
# LayerNorm / RMSNorm (K1 forward, K2 backward)
# ---------------------------------------------------------------------------


def _ln_inputs(rows, hidden, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(rows, hidden) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rs.randn(hidden)).astype(np.float32)
    b = (0.1 * rs.randn(hidden)).astype(np.float32)
    g = rs.randn(rows, hidden).astype(np.float32)
    return x, w, b, g


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("memory_efficient", [False, True])
@pytest.mark.parametrize("rms", [False, True])
def test_layer_norm_grads_match_jax(force_pallas, rms, memory_efficient,
                                    dtype):
    """Hidden 256 (lane-aligned, so JAX runs its Pallas K1/K2 in
    interpret mode).  f32: F32_TOL.  bf16 (x, g and dx in bf16, f32
    affine): dx within two bf16 steps (each side rounds its own f32
    result, and with memory_efficient each recovers xhat from its own
    bf16 y); dw/db are f32 sums over the rows of products whose bf16
    inputs agree, so 1e-3 relative."""
    x, w, b, g = _ln_inputs(12, 256, seed=int(rms) + 2 * memory_efficient)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = _np(jnp.asarray(x).astype(jdt))  # the values both sides see
    g = _np(jnp.asarray(g).astype(jdt))
    kw = dict(eps=1e-5, memory_efficient=memory_efficient)
    x3, g3 = x.reshape(3, 4, 256), g.reshape(3, 4, 256)

    if rms:
        def jfn(a, ww):
            return jax_ln.fused_rms_norm_affine(a, ww, (256,), **kw)

        def pfn(a, ww):
            return port_ln.fused_rms_norm_affine(a.to(tdt), ww, (256,), **kw)

        arrays = (x3, w)
    else:
        def jfn(a, ww, bb):
            return jax_ln.fused_layer_norm_affine(a, ww, bb, (256,), **kw)

        def pfn(a, ww, bb):
            return port_ln.fused_layer_norm_affine(a.to(tdt), ww, bb, (256,),
                                                   **kw)

        arrays = (x3, w, b)
    jargs = [jnp.asarray(arrays[0]).astype(jdt)] + [jnp.asarray(a)
                                                    for a in arrays[1:]]
    y_j, vjp = jax.vjp(jfn, *jargs)
    grads_j = vjp(jnp.asarray(g3).astype(jdt))
    assert jax_dispatch.last_paths()["rms_norm" if rms else "layer_norm"] == "pallas"
    grads = _grads(pfn, arrays, torch.from_numpy(g3).to(tdt))
    assert _dispatch.last_paths()["rms_norm" if rms else "layer_norm"] == "torch"
    for i, (gj, gp) in enumerate(zip(grads_j, grads)):
        if dtype == "f32":
            tol = F32_TOL
        elif i == 0:
            tol = dict(atol=2 * 2.0 ** -8, rtol=2 * 2.0 ** -8)
        else:
            tol = dict(atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(gp.float().numpy(), _np(gj), **tol)


def test_layer_norm_twin_is_the_jax_kernel_math():
    """The port's K2 twin against the Pallas K2 itself (interpret mode),
    on the same saved statistics, in both x_is_output modes."""
    from apex_tpu.ops.pallas import layer_norm as jax_kernels

    x, w, b, g = _ln_inputs(16, 256, seed=5)
    for rms in (False, True):
        y, mu, rstd = jax_kernels.layer_norm_fwd(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps=1e-5, rms=rms
        )
        for x_is_output in (False, True):
            saved = y if x_is_output else jnp.asarray(x)
            ref = jax_kernels.layer_norm_bwd(
                saved, jnp.asarray(w), jnp.asarray(b), mu, rstd,
                jnp.asarray(g), rms=rms, x_is_output=x_is_output,
            )
            out = port_ln.layer_norm_bwd_reference(
                torch.from_numpy(_np(saved)), torch.from_numpy(w),
                torch.from_numpy(b), torch.from_numpy(_np(mu)[:, 0]),
                torch.from_numpy(_np(rstd)[:, 0]), torch.from_numpy(g),
                rms, x_is_output,
            )
            for a, r in zip(out, ref):
                np.testing.assert_allclose(a.numpy(), _np(r), **F32_TOL)


# ---------------------------------------------------------------------------
# flash attention (K3 forward, K4 backward)
# ---------------------------------------------------------------------------


def _qkv_do(sq, sk, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(1, 2, s, 64).astype(np.float32) for s in (sq, sk, sk))
    do = rs.randn(1, 2, sq, 64).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("sq,sk,causal", [
    (128, 128, True),    # the training shape class: causal, Sq = Sk
    (200, 200, True),    # ragged: the JAX kernel pads, the port masks
    (128, 128, False),
    (64, 192, True),     # bottom-right causal alignment, Sq < Sk
    (256, 128, True),    # Sq > Sk: rows 0..127 see no key (closed form)
])
def test_attention_grads_match_jax_pallas(force_pallas, sq, sk, causal):
    """dq, dk, dv against the Pallas flash_bwd in interpret mode, f32.
    F32_TOL: the JAX kernels accumulate over key/query blocks, the twin
    over whole rows."""
    q, k, v, do = _qkv_do(sq, sk, seed=sq + sk + causal)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_attn.flash_attention(a, b, c, causal=causal,
                                                 scale=0.125),
        *map(jnp.asarray, (q, k, v)),
    )
    grads_j = vjp(jnp.asarray(do))
    assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    grads = _grads(
        lambda a, b, c: port_attn.flash_attention(a, b, c, causal=causal,
                                                  scale=0.125),
        (q, k, v), torch.from_numpy(do),
    )
    assert _dispatch.last_paths()["flash_attention"] == "torch"
    for gj, gp in zip(grads_j, grads):
        np.testing.assert_allclose(gp.numpy(), _np(gj), **F32_TOL)


def test_fully_masked_rows_feed_dv_uniformly():
    """Sq > Sk causal: a row that sees no key averages V uniformly, so
    its dO reaches every key's dv with weight 1/Sk and gives no dq."""
    q, k, v, do = _qkv_do(24, 8, seed=9)
    do[..., 16:, :] = 0.0  # keep only the 16 fully-masked rows' cotangent
    dq, dk, dv = _grads(
        lambda a, b, c: port_attn.flash_attention(a, b, c, causal=True),
        (q, k, v), torch.from_numpy(do),
    )
    want_dv = np.broadcast_to(do[..., :16, :].sum(axis=2, keepdims=True) / 8,
                              dv.shape)
    np.testing.assert_allclose(dv.numpy(), want_dv, **F32_TOL)
    np.testing.assert_allclose(dq.numpy(), 0.0, atol=0.0)
    np.testing.assert_allclose(dk.numpy(), 0.0, atol=0.0)


@pytest.mark.parametrize("s", [128, 256])
def test_attention_lse_grads_match_jax(force_pallas, s):
    """Both cotangents of flash_attention_with_lse (the dlse fold into
    delta) against JAX's, F32_TOL."""
    q, k, v, do = _qkv_do(s, s, seed=s)
    dlse = np.random.RandomState(s + 1).randn(1, 2, s).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_attn.flash_attention_with_lse(
            a, b, c, causal=True, scale=0.125),
        *map(jnp.asarray, (q, k, v)),
    )
    grads_j = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    grads = _grads(
        lambda a, b, c: port_attn.flash_attention_with_lse(
            a, b, c, causal=True, scale=0.125),
        (q, k, v), (torch.from_numpy(do), torch.from_numpy(dlse)),
    )
    for gj, gp in zip(grads_j, grads):
        np.testing.assert_allclose(gp.numpy(), _np(gj), **F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_twin_is_the_jax_kernel_math(causal):
    """The port's K4 twin against the Pallas flash_bwd itself on the
    same o (the JAX kernel's), with a dlse cotangent, F32_TOL."""
    from apex_tpu.ops.pallas import flash_attention as jax_kernels

    q, k, v, do = (a[0] for a in _qkv_do(256, 256, seed=21))
    dlse = np.random.RandomState(22).randn(2, 256).astype(np.float32)
    o, lse = jax_kernels.flash_fwd(*map(jnp.asarray, (q, k, v)), None,
                                   scale=0.125, causal=causal)
    ref = jax_kernels.flash_bwd(*map(jnp.asarray, (q, k, v)), o, lse,
                                jnp.asarray(do), None, scale=0.125,
                                causal=causal, dlse=jnp.asarray(dlse))
    delta = (do * _np(o)).sum(-1) - dlse
    # the twin recomputes p from the row max and sum of its own forward,
    # whose lse is the JAX kernel's
    _, lse_p, m, l = port_attn.flash_fwd_reference(
        *map(torch.from_numpy, (q, k, v)), scale=0.125, causal=causal)
    np.testing.assert_allclose(lse_p.numpy(), _np(lse)[..., 0], **F32_TOL)
    out = port_attn.flash_bwd_reference(
        *map(torch.from_numpy, (q, k, v, do)), m, l,
        torch.from_numpy(delta), scale=0.125, causal=causal,
    )
    for a, r in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), _np(r), **F32_TOL)


# ---------------------------------------------------------------------------
# RoPE and the cross entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rot_dim", [64, 32])
def test_rope_grads_match_jax(rot_dim, dtype):
    """Autograd through the port's f32 rotation is JAX's transposed
    rotation (``_transpose_apply``), including the passed-through tail.
    f32: F32_TOL; bf16: the same f32 arithmetic rounded once, so equal
    to one bf16 step."""
    from apex_tpu.models.gpt import _rope_cos_sin
    from apex_tpu_torch.models import rope_cos_sin

    rs = np.random.RandomState(rot_dim)
    t = rs.randn(2, 3, 48, 64).astype(np.float32)
    g = rs.randn(2, 3, 48, 64).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    cos_j, sin_j = _rope_cos_sin(48, rot_dim)
    cos, sin = rope_cos_sin(48, rot_dim)
    _, vjp = jax.vjp(lambda a: jax_rope(a, cos_j, sin_j),
                     jnp.asarray(t).astype(jdt))
    (gj,) = vjp(jnp.asarray(g).astype(jdt))
    tt = torch.from_numpy(_np(jnp.asarray(t).astype(jdt))).to(tdt)
    tt.requires_grad_()
    out = fused_apply_rotary_pos_emb_cached(tt, cos, sin)
    (gp,) = torch.autograd.grad(out, tt, torch.from_numpy(g).to(tdt))
    assert gp.dtype == tdt
    tol = F32_TOL if dtype == "f32" else dict(atol=2.0 ** -8, rtol=2.0 ** -8)
    np.testing.assert_allclose(gp.float().numpy(), _np(gj), **tol)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_value_and_grad_match_jax(smoothing):
    """Loss and logits gradient at tp = 1 (an unbound tp axis on the JAX
    side), f32, with a non-uniform cotangent; F32_TOL."""
    rs = np.random.RandomState(int(smoothing * 10))
    logits = (3.0 * rs.randn(5, 3, 97)).astype(np.float32)
    target = rs.randint(0, 97, size=(5, 3)).astype(np.int32)
    g = rs.rand(5, 3).astype(np.float32)
    loss_j, vjp = jax.vjp(
        lambda lg: jax_ce(lg, jnp.asarray(target), smoothing),
        jnp.asarray(logits),
    )
    (grad_j,) = vjp(jnp.asarray(g))
    lt = torch.from_numpy(logits).requires_grad_()
    loss = vocab_parallel_cross_entropy(lt, torch.from_numpy(target),
                                        smoothing)
    (grad,) = torch.autograd.grad(loss, lt, torch.from_numpy(g))
    assert loss.dtype == torch.float32 and loss.shape == (5, 3)
    np.testing.assert_allclose(loss.detach().numpy(), _np(loss_j), **F32_TOL)
    np.testing.assert_allclose(grad.numpy(), _np(grad_j), **F32_TOL)


def test_cross_entropy_refuses_tp_and_shape_mismatch():
    logits = torch.zeros(4, 10)
    with pytest.raises(NotImplementedError, match="tp_size=2"):
        vocab_parallel_cross_entropy(logits, torch.zeros(4, dtype=torch.long),
                                     tp_size=2)
    with pytest.raises(ValueError, match="leading dimensions"):
        vocab_parallel_cross_entropy(logits, torch.zeros(5, dtype=torch.long))

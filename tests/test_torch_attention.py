"""apex_tpu_torch flash attention (and the RoPE it rides with) vs the
JAX package.

The port's plain versions (what its CUDA kernels K3, K4 and K5 are held
against on the card) against ``apex_tpu.ops.attention.flash_attention``
forced onto its Pallas kernels in interpret mode, on the same seeded
numpy inputs, f32, D = 64 and 32: without operands, with every layout of
the additive bias, and with dropout at the same int32 seed (the keep
mask itself bit for bit against ``_dropout_keep_block``); K5's twin
``flash_dbias_reference`` against the Pallas ``flash_dbias`` for every
bias layout, and a trainable bias's gradient end to end.  A row whose every
key the bias masks is held to autodiff of ``mha_reference`` instead:
the Pallas backward is wrong there (ROADMAP C).  Tolerance 2e-5: the
Pallas kernels run an online softmax over key blocks, the port one
softmax over the row, so the two sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _dispatch as jax_dispatch
from apex_tpu.ops import attention as jax_attn
from apex_tpu_torch.ops import _dispatch
from apex_tpu_torch.ops import attention as port_attn

TOL = dict(atol=2e-5, rtol=2e-5)


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


def _qkv(sq, sk, b=1, h=2, d=64, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(
        rs.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk)
    )


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("sq,sk,causal", [
    (128, 128, True),    # the prefill shape class: causal, Sq = Sk
    (200, 200, True),    # ragged: the JAX kernel pads, the port masks
    (128, 128, False),
    (64, 192, True),     # bottom-right causal alignment, Sq < Sk
])
def test_flash_matches_jax_pallas(force_pallas, sq, sk, causal):
    q, k, v = _qkv(sq, sk)
    ref = jax_attn.flash_attention(*_j(q, k, v), causal=causal, scale=0.125)
    out = port_attn.flash_attention(*_t(q, k, v), causal=causal, scale=0.125)
    assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    assert _dispatch.last_paths()["flash_attention"] == "torch"
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("s", [128, 200])
def test_lse_matches_jax(force_pallas, s):
    q, k, v = _qkv(s, s, seed=1)
    o_j, lse_j = jax_attn.flash_attention_with_lse(
        *_j(q, k, v), causal=True, scale=0.125
    )
    o, lse = port_attn.flash_attention_with_lse(
        *_t(q, k, v), causal=True, scale=0.125
    )
    assert lse.shape == (1, 2, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)


def test_reference_matches_jax_reference():
    q, k, v = _qkv(96, 96, seed=2)
    ref = jax_attn.mha_reference(*_j(q, k, v), causal=True)
    out = port_attn.mha_reference(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_fully_masked_rows_average_v():
    """Sq > Sk bottom-right causal: rows that see no key average V
    uniformly (finite MASK_VALUE), as the JAX reference does."""
    q, k, v = _qkv(24, 8, seed=3)
    ref = jax_attn.mha_reference(*_j(q, k, v), causal=True)
    out = port_attn.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        out[0, :, 0].numpy(), v[0].mean(axis=1), **TOL
    )


def test_additive_bias_on_plain_path():
    q, k, v = _qkv(32, 32, seed=4)
    bias = np.random.RandomState(5).randn(1, 1, 1, 32).astype(np.float32)
    ref = jax_attn.mha_reference(*_j(q, k, v), jnp.asarray(bias))
    out = port_attn.flash_attention(*_t(q, k, v), torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("rot_dim", [64, 32])
def test_rope_matches_jax(rot_dim):
    """The f32 rotate_half rotation the prefill applies to q and k,
    including a partial rotary dim that passes the tail through."""
    from apex_tpu.models.gpt import _rope_cos_sin
    from apex_tpu.ops.rope import fused_apply_rotary_pos_emb_cached as jax_rope
    from apex_tpu_torch.models import rope_cos_sin
    from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb_cached

    (x,) = _qkv(48, 48, seed=6)[:1]
    cos_j, sin_j = _rope_cos_sin(48, rot_dim)
    cos, sin = rope_cos_sin(48, rot_dim)
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_j), **TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_j), **TOL)
    ref = jax_rope(jnp.asarray(x), cos_j, sin_j)
    out = fused_apply_rotary_pos_emb_cached(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# the bias and dropout operands of K3/K4
# ---------------------------------------------------------------------------


B, H, S = 2, 2, 128


def _bias(shape, seed):
    """A random bias with a few keys masked by -inf (the torch convention;
    both sides clamp it at MASK_VALUE)."""
    rs = np.random.RandomState(seed)
    bias = (2.0 * rs.randn(*shape)).astype(np.float32)
    bias[..., 5] = -np.inf
    return bias


def _vjp_jax(fn, arrays, cotangent):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return out, vjp(cotangent)


def _vjp_port(fn, arrays, cotangent):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts, cotangent)


def _assert_close(out, grads, out_j, grads_j):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    for g, gj in zip(grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_shape,layout", [
    ((1, 1, 1, S), "G=1 RS=1"),
    ((B, 1, 1, S), "G=B RS=1"),     # BERT's key-padding mask
    ((B, H, 1, S), "G=BH RS=1"),
    ((1, 1, S, S), "G=1 RS=Sq"),
    ((B, 1, S, S), "G=B RS=Sq"),
    ((B, H, S, S), "G=BH RS=Sq"),   # the evoformer's pair bias
])
def test_bias_layouts_match_jax_pallas(force_pallas, bias_shape, layout,
                                       causal):
    """o, lse, dq, dk and dv with each (G, RS) bias layout against the
    Pallas flash_fwd / flash_bwd in interpret mode, TOL."""
    q, k, v = _qkv(S, S, b=B, h=H, seed=len(layout) + causal)
    do = np.random.RandomState(30).randn(B, H, S, 64).astype(np.float32)
    bias = _bias(bias_shape, seed=31)
    kw = dict(causal=causal, scale=0.125)
    out_j, grads_j = _vjp_jax(
        lambda a, b_, c: jax_attn.flash_attention(a, b_, c, jnp.asarray(bias),
                                                  **kw),
        (q, k, v), jnp.asarray(do))
    assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    out, grads = _vjp_port(
        lambda a, b_, c: port_attn.flash_attention(a, b_, c,
                                                   torch.from_numpy(bias),
                                                   **kw),
        (q, k, v), torch.from_numpy(do))
    _assert_close(out, grads, out_j, grads_j)
    _, lse_j = jax_attn.flash_attention_with_lse(
        *_j(q, k, v), jnp.asarray(bias), **kw)
    _, lse = port_attn.flash_attention_with_lse(*_t(q, k, v),
                                                torch.from_numpy(bias), **kw)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)


def test_bias_with_sq_neq_sk_matches_jax_pallas(force_pallas):
    """A per-query bias (G = B, RS = Sq) with Sq < Sk, causal."""
    q, k, v = _qkv(64, 192, b=B, h=H, seed=32)
    do = np.random.RandomState(33).randn(B, H, 64, 64).astype(np.float32)
    bias = _bias((B, 1, 64, 192), seed=34)
    kw = dict(causal=True, scale=0.125)
    out_j, grads_j = _vjp_jax(
        lambda a, b_, c: jax_attn.flash_attention(a, b_, c, jnp.asarray(bias),
                                                  **kw),
        (q, k, v), jnp.asarray(do))
    out, grads = _vjp_port(
        lambda a, b_, c: port_attn.flash_attention(a, b_, c,
                                                   torch.from_numpy(bias),
                                                   **kw),
        (q, k, v), torch.from_numpy(do))
    _assert_close(out, grads, out_j, grads_j)


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 1234567, -1, -2 ** 31, 2 ** 31 - 1])
def test_keep_mask_is_jax_bit_for_bit(seed, p):
    """The port's keep mask against ``_dropout_keep_block`` bit for bit:
    three batch-heads (bh > 0 included), 96 rows and 160 columns; and one
    tile away from the origin (i = 1, j = 2), which must be the same
    global coordinates of the full mask."""
    from apex_tpu.ops.pallas.flash_attention import _dropout_keep_block

    mask = port_attn.dropout_keep_mask(
        torch.tensor([seed], dtype=torch.int32), (3, 96, 160), p).numpy()
    for bh in range(3):
        ref = _dropout_keep_block(jnp.int32(seed), jnp.int32(bh), 0, 0, 96,
                                  160, p)
        np.testing.assert_array_equal(mask[bh], np.asarray(ref))
    tile = _dropout_keep_block(jnp.int32(seed), jnp.int32(2), 1, 2, 32, 48, p)
    np.testing.assert_array_equal(mask[2, 32:64, 96:144], np.asarray(tile))
    assert abs(mask.mean() - (1 - p)) < 0.02


@pytest.mark.parametrize("p,bias_shape,causal", [
    (0.1, None, True),
    (0.1, (B, 1, 1, S), False),     # BERT: padding mask and dropout 0.1
    (0.5, (B, H, S, S), True),
])
def test_dropout_matches_jax_pallas(force_pallas, p, bias_shape, causal):
    """o, lse and the gradients with dropout against the Pallas kernels
    at the same int32 seed (the one JAX's dispatcher derives from its
    key), TOL."""
    q, k, v = _qkv(S, S, b=B, h=H, seed=40)
    do = np.random.RandomState(41).randn(B, H, S, 64).astype(np.float32)
    bias = None if bias_shape is None else _bias(bias_shape, seed=42)
    rng = jax.random.PRNGKey(43)
    seed = np.asarray(jax_attn._derive_dropout_seed(rng, p))
    kw = dict(causal=causal, scale=0.125, dropout_p=p)
    bj = None if bias is None else jnp.asarray(bias)
    bt = None if bias is None else torch.from_numpy(bias)
    out_j, grads_j = _vjp_jax(
        lambda a, b_, c: jax_attn.flash_attention(a, b_, c, bj,
                                                  dropout_rng=rng, **kw),
        (q, k, v), jnp.asarray(do))
    assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    out, grads = _vjp_port(
        lambda a, b_, c: port_attn.flash_attention(
            a, b_, c, bt, dropout_seed=torch.from_numpy(seed), **kw),
        (q, k, v), torch.from_numpy(do))
    _assert_close(out, grads, out_j, grads_j)
    o_j, lse_j = jax_attn.flash_attention_with_lse(*_j(q, k, v), bj,
                                                   dropout_rng=rng, **kw)
    o, lse = port_attn.flash_attention_with_lse(
        *_t(q, k, v), bt, dropout_seed=torch.from_numpy(seed), **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)


def test_fully_bias_masked_row_matches_reference_autodiff(force_pallas):
    """Batch row 1 has every key masked by the bias, row 0 its keys 100+.
    The port's o and gradients equal ``jax.vjp`` of ``mha_reference``
    (TOL) in both rows.  The Pallas backward, which recomputes p =
    exp(s - lse), is off by more than 1 in row 1: its lse rounds back to
    MASK_VALUE in f32, so p comes out 1 instead of 1/S."""
    q, k, v = _qkv(S, S, b=B, h=H, seed=50)
    do = np.random.RandomState(51).randn(B, H, S, 64).astype(np.float32)
    bias = np.zeros((B, 1, 1, S), np.float32)
    bias[0, ..., 100:] = -1e9
    bias[1] = -1e9
    out_r, grads_r = _vjp_jax(
        lambda a, b_, c: jax_attn.mha_reference(a, b_, c, jnp.asarray(bias),
                                                scale=0.125),
        (q, k, v), jnp.asarray(do))
    out, grads = _vjp_port(
        lambda a, b_, c: port_attn.flash_attention(a, b_, c,
                                                   torch.from_numpy(bias),
                                                   scale=0.125),
        (q, k, v), torch.from_numpy(do))
    _assert_close(out, grads, out_r, grads_r)
    _, grads_p = _vjp_jax(
        lambda a, b_, c: jax_attn.flash_attention(a, b_, c, jnp.asarray(bias),
                                                  scale=0.125),
        (q, k, v), jnp.asarray(do))
    assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    for g_p, g_r in zip(grads_p, grads_r):
        assert np.abs(np.asarray(g_p)[1] - np.asarray(g_r)[1]).max() > 1.0


def test_bias_grad_differentiates_mha_reference():
    """``bias_grad=True`` on the CPU (K5's twin through ``_Flash``): the
    bias gets autodiff's gradient of ``mha_reference`` (JAX's jnp path),
    TOL; without it the bias gets none."""
    q, k, v = _qkv(32, 48, b=B, h=H, seed=60)
    do = np.random.RandomState(61).randn(B, H, 32, 64).astype(np.float32)
    bias = _bias((1, H, 32, 48), seed=62)
    bias[..., 5] = -30.0  # finite: the clamp would cut an -inf's gradient
    _, grads_j = _vjp_jax(
        lambda a, b_, c, d: jax_attn.mha_reference(a, b_, c, d, scale=0.125),
        (q, k, v, bias), jnp.asarray(do))
    out, grads = _vjp_port(
        lambda a, b_, c, d: port_attn.flash_attention(
            a, b_, c, d, scale=0.125, bias_grad=True),
        (q, k, v, bias), torch.from_numpy(do))
    for g, gj in zip(grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), **TOL)
    qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
    bt = torch.from_numpy(bias).requires_grad_()
    port_attn.flash_attention(qt, kt, vt, bt, scale=0.125).sum().backward()
    assert bt.grad is None and qt.grad is not None


def test_dropout_seed_sources():
    """The seed comes from ``dropout_seed`` or is drawn from
    ``generator`` (the same generator state, the same output); dropout
    without either raises, as does p outside [0, 1)."""
    q, k, v = _t(*_qkv(16, 16, seed=70))

    def run(**kw):
        return port_attn.flash_attention(q, k, v, dropout_p=0.2, **kw)

    a = run(generator=torch.Generator().manual_seed(5))
    b = run(generator=torch.Generator().manual_seed(5))
    seed = port_attn.draw_dropout_seed(torch.Generator().manual_seed(5), "cpu")
    assert seed.dtype == torch.int32 and seed.shape == (1,)
    assert torch.equal(a, b) and torch.equal(a, run(dropout_seed=seed))
    assert not torch.equal(a, run(dropout_seed=seed + 1))
    with pytest.raises(ValueError, match="generator or a dropout_seed"):
        run()
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        port_attn.flash_attention(q, k, v, dropout_p=1.0, dropout_seed=seed)


# ---------------------------------------------------------------------------
# K5: the gradient of a trainable bias, and K3/K4 at head dim 32
# ---------------------------------------------------------------------------


def _dbias_pair(bh, sq, sk, d, bias_shape, causal, p=0.0, seed=80):
    """(port dbias, Pallas dbias) for one (G, RS, Sk) bias layout: the
    Pallas ``flash_fwd`` and ``flash_dbias`` in interpret mode against
    ``flash_dbias_reference`` on the port's own forward statistics, from
    the same q, k, v, dO, bias and int32 dropout seed."""
    from apex_tpu.ops.pallas import flash_attention as pallas

    rs = np.random.RandomState(seed)
    q = rs.randn(bh, sq, d).astype(np.float32)
    k, v = (rs.randn(bh, sk, d).astype(np.float32) for _ in range(2))
    do = rs.randn(bh, sq, d).astype(np.float32)
    bias = (2.0 * rs.randn(*bias_shape)).astype(np.float32)
    dseed = np.array([rs.randint(-2 ** 31, 2 ** 31 - 1)], np.int32)
    kw = dict(scale=d ** -0.5, causal=causal, dropout_p=p)
    jseed = jnp.asarray(dseed[0]) if p else None
    o_j, lse_j = pallas.flash_fwd(*_j(q, k, v, bias), dropout_seed=jseed,
                                  **kw)
    dbias_j = pallas.flash_dbias(*_j(q, k, v), o_j, lse_j, jnp.asarray(do),
                                 jnp.asarray(bias), dropout_seed=jseed, **kw)
    qt, kt, vt, dot, bt = _t(q, k, v, do, bias)
    st = torch.from_numpy(dseed) if p else None
    o, _, m, l = port_attn.flash_fwd_reference(qt, kt, vt, bt, seed=st, **kw)
    delta = (dot * o).sum(-1)
    dbias = port_attn.flash_dbias_reference(qt, kt, vt, dot, m, l, delta, bt,
                                            seed=st, **kw)
    assert dbias.shape == bias.shape and dbias.dtype == torch.float32
    return dbias.numpy(), np.asarray(dbias_j)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_shape", [
    (1, 1, 128), (2, 1, 128), (8, 1, 128),        # RS = 1: G = 1, B, BH
    (1, 128, 128), (2, 128, 128), (8, 128, 128),  # RS = Sq
])
def test_dbias_reference_matches_jax_pallas(bias_shape, causal):
    """Every (G, RS) layout at BH = 8, S = 128, D = 32: each group's
    members summed (and every row when RS = 1), TOL scaled by the
    number of summed terms' magnitude (atol 1e-4: RS = 1 sums 128 rows
    and up to 8 members)."""
    dbias, ref = _dbias_pair(8, 128, 128, 32, bias_shape, causal)
    np.testing.assert_allclose(dbias, ref, atol=1e-4, rtol=1e-4)
    assert np.abs(ref).max() > 1e-2


@pytest.mark.parametrize("sq,sk,bias_rows,causal,p", [
    (64, 128, 64, True, 0.0),     # Sq < Sk, bottom-right causal
    (128, 64, 128, False, 0.0),   # Sq > Sk
    (128, 128, 128, False, 0.1),  # dropout at the same int32 seed
    (64, 128, 1, True, 0.1),
])
def test_dbias_reference_sq_neq_sk_and_dropout(sq, sk, bias_rows, causal, p):
    dbias, ref = _dbias_pair(4, sq, sk, 64, (2, bias_rows, sk), causal, p=p,
                             seed=81)
    np.testing.assert_allclose(dbias, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bias_shape", [(1, H, S, S), (B, H, S, S),
                                        (B, 1, 1, S)])
@pytest.mark.parametrize("d", [32, 64])
def test_trainable_bias_grad_matches_jax_pallas(force_pallas, bias_shape, d):
    """``flash_attention(..., bias_grad=True)``: o and the gradients of q,
    k, v and the bias against ``jax.vjp`` of the JAX function on its
    Pallas kernels (``flash_dbias`` for the bias), TOL.  (1, H, S, S) is
    the evoformer's pair bias: the kernels see it at G = BH and the sum
    over the batch is the broadcast's backward."""
    q, k, v = _qkv(S, S, b=B, h=H, d=d, seed=82)
    do = np.random.RandomState(83).randn(B, H, S, d).astype(np.float32)
    bias = _bias(bias_shape, seed=84)
    bias[..., 5] = -30.0  # finite: the clamp would cut an -inf's gradient
    kw = dict(scale=d ** -0.5)
    out_j, grads_j = _vjp_jax(
        lambda a, b_, c, e: jax_attn.flash_attention(a, b_, c, e,
                                                     bias_grad=True, **kw),
        (q, k, v, bias), jnp.asarray(do))
    assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    out, grads = _vjp_port(
        lambda a, b_, c, e: port_attn.flash_attention(a, b_, c, e,
                                                      bias_grad=True, **kw),
        (q, k, v, bias), torch.from_numpy(do))
    _assert_close(out, grads, out_j, grads_j)
    assert grads[3].shape == bias_shape


@pytest.mark.parametrize("sq,sk,causal,bias_shape", [
    (128, 128, True, None),
    (200, 200, False, None),          # ragged
    (64, 192, True, None),            # bottom-right, Sq < Sk
    (128, 128, False, (B, H, S, S)),  # the triangle attention's layout
    (128, 128, True, (B, 1, 1, S)),
])
def test_head_dim_32_matches_jax_pallas(force_pallas, sq, sk, causal,
                                        bias_shape):
    """K3/K4's twins at D = 32 (the evoformer's triangle attention): o,
    lse, dq, dk and dv against the Pallas kernels in interpret mode,
    TOL."""
    q, k, v = _qkv(sq, sk, b=B, h=H, d=32, seed=85)
    do = np.random.RandomState(86).randn(B, H, sq, 32).astype(np.float32)
    bias = None if bias_shape is None else _bias(bias_shape, seed=87)
    bj = None if bias is None else jnp.asarray(bias)
    bt = None if bias is None else torch.from_numpy(bias)
    kw = dict(causal=causal, scale=32 ** -0.5)
    out_j, grads_j = _vjp_jax(
        lambda a, b_, c: jax_attn.flash_attention(a, b_, c, bj, **kw),
        (q, k, v), jnp.asarray(do))
    assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    out, grads = _vjp_port(
        lambda a, b_, c: port_attn.flash_attention(a, b_, c, bt, **kw),
        (q, k, v), torch.from_numpy(do))
    _assert_close(out, grads, out_j, grads_j)
    _, lse_j = jax_attn.flash_attention_with_lse(*_j(q, k, v), bj, **kw)
    _, lse = port_attn.flash_attention_with_lse(*_t(q, k, v), bt, **kw)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)


def test_fully_bias_masked_row_dbias_matches_reference_autodiff():
    """A trainable (B, 1, 1, S) bias with batch row 1 fully masked (-1e9,
    exactly the clamp value, whose gradient passes) and row 0's keys
    100+: the port's dbias (K5's twin, p = exp(s - m)/l) equals autodiff
    of the unclamped ``mha_reference`` in both rows, TOL.  The Pallas
    ``flash_dbias``, which recomputes p = exp(s - lse), is off by more
    than 1 in row 1: its lse rounds back to MASK_VALUE in f32, so p
    comes out 1 instead of 1/S (ROADMAP C)."""
    from apex_tpu.ops.pallas import flash_attention as pallas

    q, k, v = _qkv(S, S, b=B, h=H, seed=88)
    do = np.random.RandomState(89).randn(B, H, S, 64).astype(np.float32)
    bias = np.zeros((B, 1, 1, S), np.float32)
    bias[0, ..., 100:] = -1e9
    bias[1] = -1e9
    _, grads_r = _vjp_jax(
        lambda a, b_, c, e: jax_attn.mha_reference(a, b_, c, e, scale=0.125),
        (q, k, v, bias), jnp.asarray(do))
    out, grads = _vjp_port(
        lambda a, b_, c, e: port_attn.flash_attention(
            a, b_, c, e, scale=0.125, bias_grad=True),
        (q, k, v, bias), torch.from_numpy(do))
    for g, g_r in zip(grads, grads_r):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_r), **TOL)
    assert np.abs(np.asarray(grads_r[3])[1]).max() > 1e-3
    # the Pallas dbias on the kernels' layout (G = B, RS = 1)
    flat = [x.reshape(B * H, S, 64) for x in (q, k, v, do)]
    bias_f = jnp.asarray(bias.reshape(B, 1, S))
    o_j, lse_j = pallas.flash_fwd(*_j(*flat[:3]), bias_f, scale=0.125,
                                  causal=False)
    dbias_p = np.asarray(pallas.flash_dbias(
        *_j(*flat[:3]), o_j, lse_j, jnp.asarray(flat[3]), bias_f,
        scale=0.125, causal=False))
    ref = np.asarray(grads_r[3]).reshape(B, 1, S)
    np.testing.assert_allclose(dbias_p[0], ref[0], **TOL)
    assert np.abs(dbias_p[1] - ref[1]).max() > 1.0

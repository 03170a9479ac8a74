"""The accuracy argument of the f32 attention kernels, held on the host.

K3's and K4's f32 instances (``apex_tpu_torch/csrc/flash_f32.cu``) run
every product on the tensor cores as 3xTF32: each f32 operand x is split
into ``big = tf32(x)`` (round to nearest) and ``small = tf32(x - big)``,
and each k8 step of a product is ``small*big + big*small + big*big``,
the small terms first, into a fresh f32 partial that is then added to
the running f32 sum.  This file emulates that arithmetic in numpy (each
8-term partial product summed exactly and rounded to f32, every later
sum rounded to f32) and composes attention's forward and backward from
it, with an f32 (B, H, S, S) bias, at D 32, 64, 128 and 192.  Against
the JAX package's f32 reference (``jax.vjp`` of
``apex_tpu.ops.attention.mha_reference``):

- the 3xTF32 composition meets ``F32_ATTN_TOL`` (atol = rtol = 1e-5,
  ``chip_smoke.py``'s limit for the f32 instances) on o, dq, dk, dv and
  dbias;
- the same composition with one TF32 product per step (what a kernel on
  TF32 or bf16 tensor cores computes) fails it.

K5's f32 instance takes the same products since its redesign: it
recomputes S = Q K^T and dP = dO V^T as 3xTF32 products (64-column blocks
of a wide head in order, which is the same k8 order), p = exp(s - m) / l
from the forward's m and l, ds = p (dp - delta), and sums ds over a
group's heads in member order.  :func:`emulated_dbias` composes that, at
G = BH and at G = B (a head-independent bias, two members), at D 32, 64,
192 and 384, against the gradient of the JAX reference's bias: it meets
``F32_ATTN_TOL`` with three products and fails it with one.

The emulation stands alone here: it is not a feature of the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apex_tpu.ops import attention as jax_attn

#: chip_smoke.py's F32_ATTN_TOL
F32_ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
F32 = np.float32


def tf32(x):
    """``x`` rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero: ``cvt.rna.tf32.f32``."""
    bits = np.asarray(x, F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(x):
    big = tf32(x)
    return big, tf32((np.asarray(x, F32) - big).astype(F32))


def product(a, b, passes=3):
    """``a @ b`` (f32, (..., m, k) by (..., k, n), k a multiple of 8) as
    the kernels take it: per k8 step the TF32 products (exact in f32)
    summed and rounded to f32, small terms first when ``passes`` is 3,
    then added to the running f32 sum."""
    k = a.shape[-1]
    assert k % 8 == 0 and b.shape[-2] == k
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], F32)
    for s in range(0, k, 8):
        def mm(x, y):
            return np.matmul(x[..., s:s + 8].astype(np.float64),
                             y[..., s:s + 8, :].astype(np.float64)).astype(F32)
        if passes == 3:
            t = mm(a_small, b_big)
            t = (t + mm(a_big, b_small)).astype(F32)
            t = (t + mm(a_big, b_big)).astype(F32)
        else:
            t = mm(a_big, b_big)
        acc = (acc + t).astype(F32)
    return acc


def emulated_attention(q, k, v, bias, do, scale, passes):
    """o, dq, dk, dv and dbias of softmax(q k^T * scale + bias) v with
    every product from :func:`product`, in the kernels' order: o = (p
    v) / l with p = exp(s - m); the backward recomputes p from m and l,
    ds = p (dp - delta), delta = rowsum(dO * o)."""
    t = lambda x: np.swapaxes(x, -1, -2)  # noqa: E731
    s = (product(q, t(k), passes) * F32(scale) + bias).astype(F32)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m).astype(F32)
    l = p.sum(-1, keepdims=True, dtype=F32)
    o = (product(p, v, passes) / l).astype(F32)
    p = (p / l).astype(F32)
    dp = product(do, t(v), passes)
    delta = (do * o).sum(-1, keepdims=True, dtype=F32)
    ds = (p * (dp - delta)).astype(F32)
    dq = product(ds, k, passes) * F32(scale)
    dk = product(t(ds), q, passes) * F32(scale)
    dv = product(t(p), do, passes)
    return o, dq, dk, dv, ds


def _inputs(d, seed):
    rs = np.random.RandomState(seed)
    b, h, s = 1, 2, 96
    q, k, v, do = (rs.randn(b, h, s, d).astype(F32) for _ in range(4))
    bias = rs.randn(b, h, s, s).astype(F32)
    return q, k, v, bias, do


def _reference(q, k, v, bias, do, scale):
    """The JAX package's f32 composition and its vjp, at full f32."""
    with jax.default_matmul_precision("float32"):
        out, vjp = jax.vjp(
            lambda a, b_, c, e: jax_attn.mha_reference(a, b_, c, e,
                                                       scale=scale),
            *(jnp.asarray(x) for x in (q, k, v, bias)))
        grads = vjp(jnp.asarray(do))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _worst(got, want):
    """The worst err/allowance over every output under F32_ATTN_TOL."""
    return max(
        float((np.abs(g - w) / (F32_ATTN_TOL["atol"]
                                + F32_ATTN_TOL["rtol"] * np.abs(w))).max())
        for g, w in zip(got, want))


@pytest.mark.parametrize("d", [32, 64, 128, 192])
def test_three_tf32_products_meet_the_f32_limit(d):
    q, k, v, bias, do = _inputs(d, 70 + d)
    scale = d ** -0.5
    want = _reference(q, k, v, bias, do, scale)
    got = emulated_attention(q, k, v, bias, do, scale, passes=3)
    for name, g, w in zip(("o", "dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **F32_ATTN_TOL)
    # with room to spare for the card's own sums in another order
    assert _worst(got, want) < 0.5


@pytest.mark.parametrize("d", [32, 64, 128, 192])
def test_one_tf32_product_fails_the_f32_limit(d):
    q, k, v, bias, do = _inputs(d, 70 + d)
    scale = d ** -0.5
    want = _reference(q, k, v, bias, do, scale)
    got = emulated_attention(q, k, v, bias, do, scale, passes=1)
    assert _worst(got, want) > 10.0


def test_split_recovers_f32_to_22_bits():
    """big + small holds x to within 2^-22 of |x| (a relative error of
    one TF32 product alone is up to 2^-11)."""
    x = np.random.RandomState(7).randn(4096).astype(F32)
    big, small = split(x)
    assert np.all(np.abs(big.view(np.uint32) & 0x1FFF) == 0)
    assert np.all(np.abs(small.view(np.uint32) & 0x1FFF) == 0)
    err = np.abs((big.astype(np.float64) + small) - x) / np.abs(x)
    assert err.max() <= 2.0 ** -22
    assert (np.abs(big.astype(np.float64) - x) / np.abs(x)).max() > 2.0 ** -14


def emulated_dbias(q, k, v, bias, do, scale, passes, members):
    """K5's arithmetic on the emulated products: the forward's m, l and o
    (for delta), then K5's recompute of s and dp, p = exp(s - m) / l, ds =
    p (dp - delta), and each group's ``members`` heads summed in order
    (f32 after every add).  ``bias`` is (B, H // members, S, S)."""
    t = lambda x: np.swapaxes(x, -1, -2)  # noqa: E731
    b, h = q.shape[:2]
    full = np.repeat(bias, members, axis=1)
    s = (product(q, t(k), passes) * F32(scale) + full).astype(F32)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m).astype(F32)
    l = p.sum(-1, keepdims=True, dtype=F32)
    o = (product(p, v, passes) / l).astype(F32)
    delta = (do * o).sum(-1, keepdims=True, dtype=F32)
    # K5: the recompute from m and l
    s5 = (product(q, t(k), passes) * F32(scale) + full).astype(F32)
    p5 = (np.exp(s5 - m) * (F32(1) / l)).astype(F32)
    dp = product(do, t(v), passes)
    ds = (p5 * (dp - delta)).astype(F32)
    ds = ds.reshape(b, h // members, members, *ds.shape[2:])
    acc = np.zeros_like(ds[:, :, 0])
    for member in range(members):
        acc = (acc + ds[:, :, member]).astype(F32)
    return acc


def _dbias_case(d, members, seed):
    rs = np.random.RandomState(seed)
    b, h, s = 1, 2, 96
    q, k, v, do = (rs.randn(b, h, s, d).astype(F32) for _ in range(4))
    bias = rs.randn(b, h // members, s, s).astype(F32)
    scale = d ** -0.5
    with jax.default_matmul_precision("float32"):
        _, vjp = jax.vjp(
            lambda e: jax_attn.mha_reference(*(jnp.asarray(x)
                                               for x in (q, k, v)), e,
                                             scale=scale),
            jnp.asarray(bias))
        want = np.asarray(vjp(jnp.asarray(do))[0])
    return (q, k, v, bias, do, scale), want


@pytest.mark.parametrize("d", [32, 64, 192, 384])
@pytest.mark.parametrize("members", [1, 2])
def test_k5_three_tf32_products_meet_the_f32_limit(d, members):
    args, want = _dbias_case(d, members, 170 + d + members)
    got = emulated_dbias(*args, passes=3, members=members)
    np.testing.assert_allclose(got, want, **F32_ATTN_TOL)
    assert _worst([got], [want]) < 0.5


@pytest.mark.parametrize("d", [32, 64, 192, 384])
def test_k5_one_tf32_product_fails_the_f32_limit(d):
    args, want = _dbias_case(d, 1, 170 + d + 1)
    got = emulated_dbias(*args, passes=1, members=1)
    assert _worst([got], [want]) > 10.0

"""apex_tpu_torch at every head dim and on f32 q/k/v, against the JAX
package, and the launch plan of the redesigned K1/K2.

- The card pads a head dim that has no kernel instance (48, 96, 160) to
  the next one (64, 128, 256), and one above 256 to the next multiple of
  128 (320 to 384, the wide instance), and slices the outputs back; D =
  128 and 256 have their own instances.  Here that composition —
  ``kernel_head_dim``, the wrappers' own padding helper, the plain twins
  at the padded D, the slice — is held against
  ``apex_tpu.ops.attention.flash_attention`` on its Pallas kernels in
  interpret mode (which pads D its own way: above 128 to a multiple of
  128) at D = 48, 96, 128, 160 and 256: o, and dq, dk, dv and a
  trainable bias's gradient through ``jax.vjp``.  Tolerance 2e-5, as
  ``test_torch_attention.py``: the Pallas kernels take an online softmax
  over key blocks, the twins one softmax over the row.
- The port's public ``flash_attention`` at D = 160, 256, 320 and 384 (its
  autograd over the twins on the CPU), with and without a trainable
  bias, against ``jax.vjp`` of the JAX function on the Pallas kernels;
  TOL.
- f32 q/k/v: the port's autograd on f32 inputs (its twins on the CPU,
  the f32 kernel instances on the card) against the JAX function at f32
  (the Pallas dots at ``Precision.HIGHEST``), with a trainable bias and
  with dropout at the same int32 seed, D 64 and 96; TOL.
- The wrappers' route on the card, with the launch stood in for: bf16 to
  K3/K4/K5, f32 to their f32 instances, the padded head dim in the C
  arguments (384 for D = 320, the wide instance); mixed dtypes raise.
- K6's twin at D 96, 128, 192 and 256 (no padding: K6 takes any D) with
  the fused RoPE and int8 pages against the JAX paged decode in
  interpret mode; tolerance 2e-6, as ``test_torch_paged_attention.py``.
- ``norm_launch_plan`` (K1/K2): the load width, the one-element loads of
  misaligned or odd rows, the lanes per row, the persistent grid and
  K2's partial rows.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _dispatch as jax_dispatch
from apex_tpu.ops import attention as jax_attn
from apex_tpu.ops.paged_attention import paged_decode_attention as jax_paged
from apex_tpu.serve.cache import encode_kv
from apex_tpu_torch.ops import _build, _dispatch
from apex_tpu_torch.ops import attention as port_attn
from apex_tpu_torch.ops import layer_norm as port_ln
from apex_tpu_torch.ops.paged_attention import paged_decode_attention

TOL = dict(atol=2e-5, rtol=2e-5)
PAGED_TOL = dict(atol=2e-6, rtol=2e-6)


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


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the padded composition against the Pallas kernels
# ---------------------------------------------------------------------------


def _padded_attention(q, k, v, do, bias, *, causal, scale):
    """What the card computes for (B, H, S, D) q, k, v: the wrappers'
    padding of q, k, v and dO to ``kernel_head_dim(D)``, the twins of
    K3, K4 and K5 at that head dim, and the slice back to D.  Returns o,
    dq, dk, dv (B, H, S, D) and dbias in the bias's (B, H, Sq, Sk)
    shape (or None)."""
    b, h, sq, d = q.shape
    sk = k.shape[-2]
    flat = [t.reshape(b * h, -1, d) for t in (q, k, v, do)]
    dk_, (qp, kp, vp, dop) = port_attn._padded("test", d, *flat)
    assert dk_ == port_attn.kernel_head_dim(d) and qp.shape[-1] == dk_
    bias_k = None
    if bias is not None:
        bias_k = port_attn._format_bias(bias, b, h, sq, sk)
    kw = dict(scale=scale, causal=causal)
    o, _, m, l = port_attn.flash_fwd_reference(qp, kp, vp, bias_k, **kw)
    if dk_ > d:  # the zero columns of V give zero columns of o
        assert float(o[..., d:].abs().max()) == 0.0
    o = port_attn._unpad(o, d)
    delta = (flat[3] * o).sum(-1)
    grads = port_attn.flash_bwd_reference(qp, kp, vp, dop, m, l, delta,
                                          bias_k, **kw)
    dq, dkk, dv = (port_attn._unpad(g, d) for g in grads)
    dbias = None
    if bias is not None:
        dbias = port_attn.flash_dbias_reference(qp, kp, vp, dop, m, l, delta,
                                                bias_k, **kw)
        dbias = dbias.reshape(b, h, sq, sk)
    shape = lambda t, s: t.reshape(b, h, s, d)  # noqa: E731
    return (shape(o, sq), shape(dq, sq), shape(dkk, sk), shape(dv, sk),
            dbias)


@pytest.mark.parametrize("d,padded", [(48, 64), (96, 128), (128, 128),
                                      (160, 256), (256, 256)])
@pytest.mark.parametrize("causal,with_bias", [(True, False), (False, True)])
def test_padded_head_dims_match_jax_pallas(force_pallas, d, padded, causal,
                                           with_bias):
    """D = 48, 96 and 160 padded to the next instance, D = 128 and 256 at
    their own: the forward and every gradient (a (B, H, S, S) trainable
    bias's included) against ``jax.vjp`` of the Pallas path."""
    b, h, s = 1, 2, 72
    q, k, v, do = (_rand((b, h, s, d), seed) for seed in (1, 2, 3, 4))
    bias = _rand((b, h, s, s), 5) if with_bias else None
    scale = d ** -0.5
    assert port_attn.kernel_head_dim(d) == padded
    args = [jnp.asarray(t) for t in (q, k, v)]
    if with_bias:
        fn = lambda a, b_, c, e: jax_attn.flash_attention(  # noqa: E731
            a, b_, c, e, causal=causal, scale=scale, bias_grad=True)
        args.append(jnp.asarray(bias))
    else:
        fn = lambda a, b_, c: jax_attn.flash_attention(  # noqa: E731
            a, b_, c, causal=causal, scale=scale)
    out_j, vjp = jax.vjp(fn, *args)
    grads_j = vjp(jnp.asarray(do))
    assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    o, dq, dk, dv, dbias = _padded_attention(
        *(torch.from_numpy(t) for t in (q, k, v, do)),
        None if bias is None else torch.from_numpy(bias), causal=causal,
        scale=scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(out_j), **TOL)
    for got, want in zip((dq, dk, dv), grads_j[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if with_bias:
        np.testing.assert_allclose(dbias.numpy(), np.asarray(grads_j[3]),
                                   **TOL)


def test_instance_head_dims_are_not_copied():
    """D = 32, 64 and 128 reach the kernels as given: no pad, no copy."""
    for d in port_attn.KERNEL_HEAD_DIMS:
        x = torch.zeros(2, 8, d)
        dk, (y,) = port_attn._padded("test", d, x)
        assert dk == d and y is x
        assert port_attn._unpad(y, d) is y


@pytest.mark.parametrize("d,want", [(1, 32), (32, 32), (33, 64), (48, 64),
                                    (64, 64), (65, 128), (96, 128),
                                    (128, 128), (129, 256), (160, 256),
                                    (192, 256), (256, 256), (257, 384),
                                    (320, 384), (384, 384), (513, 640)])
def test_kernel_head_dim(d, want):
    """The instances up to 256; above, the reference's padded_head_dim (a
    multiple of 128), which the wide instance takes."""
    assert port_attn.kernel_head_dim(d) == want
    if d > 128:
        assert want % 128 == 0 and want - d < 128


@pytest.mark.parametrize("d", [0])
def test_kernel_head_dim_refuses_what_is_not_ported(d):
    """D = 0 is no head dim: the only one the card refuses."""
    with pytest.raises(ValueError, match="positive"):
        port_attn.kernel_head_dim(d)


@pytest.mark.parametrize("d", [160, 256, 320, 384])
@pytest.mark.parametrize("with_bias", [False, True])
def test_wide_head_dims_match_jax(force_pallas, d, with_bias):
    """``flash_attention`` at D = 160, 256, 320 and 384 on the CPU (the port's
    autograd over the twins), causal without a bias and non-causal with
    a trainable (B, H, S, S) one: o and every gradient against
    ``jax.vjp`` of the JAX function on its Pallas kernels; TOL."""
    b, h, s = 1, 2, 40
    q, k, v, do = (_rand((b, h, s, d), seed) for seed in (61, 62, 63, 64))
    bias = _rand((b, h, s, s), 65)
    kw = dict(causal=not with_bias, scale=d ** -0.5)
    arrays = (q, k, v) + ((bias,) if with_bias else ())
    if with_bias:
        fn_j = lambda a, b_, c, e: jax_attn.flash_attention(  # noqa: E731
            a, b_, c, e, bias_grad=True, **kw)
    else:
        fn_j = lambda a, b_, c: jax_attn.flash_attention(  # noqa: E731
            a, b_, c, **kw)
    out_j, vjp = jax.vjp(fn_j, *(jnp.asarray(t) for t in arrays))
    grads_j = vjp(jnp.asarray(do))
    assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    ts = [torch.from_numpy(t).requires_grad_() for t in arrays]
    out = port_attn.flash_attention(*ts, bias_grad=with_bias, **kw)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    for t, want in zip(ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# f32 q/k/v
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [64, 96])
@pytest.mark.parametrize("causal,p", [(True, 0.0), (False, 0.1)])
def test_f32_attention_matches_jax(force_pallas, d, causal, p):
    """f32 q/k/v with a trainable (B, H, S, S) bias, and dropout at the
    same int32 seed: o and every gradient of the port's autograd against
    ``jax.vjp`` of the JAX function, both in f32."""
    b, h, s = 1, 2, 64
    q, k, v, do = (_rand((b, h, s, d), seed) for seed in (11, 12, 13, 14))
    bias = _rand((b, h, s, s), 15)
    scale = d ** -0.5
    kw = dict(causal=causal, scale=scale, dropout_p=p, bias_grad=True)
    # the port takes the int32 seed the JAX dispatcher derives from its key
    jkw = dict(kw)
    if p:
        jkw["dropout_rng"] = jax.random.PRNGKey(0)
    seed_j = jax_attn._derive_dropout_seed(jkw.get("dropout_rng"), p)
    fn_j = lambda a, b_, c, e: jax_attn.flash_attention(  # noqa: E731
        a, b_, c, e, **jkw)
    out_j, vjp = jax.vjp(fn_j, *(jnp.asarray(t) for t in (q, k, v, bias)))
    grads_j = vjp(jnp.asarray(do))
    assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v, bias)]
    dropout_seed = (torch.from_numpy(np.array(seed_j, np.int32)).reshape(1)
                    if p else None)
    out = port_attn.flash_attention(*ts, dropout_seed=dropout_seed, **kw)
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    for t, want in zip(ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the route on the card, with the launch stood in for
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors taken for the card's; each launch recorded as (entry
    point, head-dim argument) instead of run."""
    calls = []
    monkeypatch.setattr(_dispatch, "on_card", lambda *tensors: True)

    def launch(kernel, argtypes, device, *args):
        assert len(args) + 1 == len(argtypes)
        calls.append((kernel, args[argtypes.index(ctypes.c_int) + 3]))

    monkeypatch.setattr(_dispatch, "launch", launch)
    return calls


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, ""),
                                          (torch.float32, "_f32")])
@pytest.mark.parametrize("d,padded", [(32, 32), (48, 64), (96, 128),
                                      (128, 128), (160, 256), (256, 256),
                                      (320, 384), (384, 384)])
def test_wrappers_route_by_dtype_and_pad(fake_card, dtype, suffix, d, padded):
    bh, s = 2, 16
    q = torch.zeros(bh, s, d, dtype=dtype)
    stats = torch.zeros(bh, s)
    bias = torch.zeros(bh, s, s)
    kw = dict(scale=d ** -0.5, causal=False)
    o, *_ = port_attn.flash_fwd(q, q, q, **kw)
    grads = port_attn.flash_bwd(q, q, q, q, stats, stats, stats, **kw)
    port_attn.flash_dbias(q, q, q, q, stats, stats, stats, bias, **kw)
    assert fake_card == [(f"flash_fwd{suffix}", padded),
                         (f"flash_bwd{suffix}", padded),
                         (f"flash_dbias{suffix}", padded)]
    for t in (o, *grads):
        assert t.shape == (bh, s, d) and t.dtype == dtype
        assert t.is_contiguous()


def test_wrappers_refuse_mixed_dtypes_and_wide_heads(fake_card):
    """Mixed dtypes and f16 raise; a head dim above 256, which the card
    refused before the wide instance, now launches it at the next
    multiple of 128, and only D < 1 is refused."""
    a = torch.zeros(2, 16, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        port_attn.flash_fwd(a, a.float(), a, scale=0.125, causal=False)
    with pytest.raises(TypeError, match="one dtype"):
        port_attn.flash_fwd(a.half(), a.half(), a.half(), scale=0.125,
                            causal=False)
    assert fake_card == []
    wide = torch.zeros(2, 16, 320, dtype=torch.bfloat16)
    o, *_ = port_attn.flash_fwd(wide, wide, wide, scale=0.125, causal=False)
    assert fake_card == [("flash_fwd", 384)] and o.shape == wide.shape
    empty = torch.zeros(2, 16, 0, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="positive"):
        port_attn.flash_fwd(empty, empty, empty, scale=0.125, causal=False)


def test_paged_decode_takes_any_head_dim_up_to_128(monkeypatch):
    """K6's wrapper passes any D through unpadded, up to 128 and past it
    (the kernel's wide instance), and refuses an odd D with the
    rotate-half RoPE."""
    from apex_tpu_torch.ops import paged_attention as pa

    calls = []
    monkeypatch.setattr(_dispatch, "on_card", lambda *tensors: True)
    monkeypatch.setattr(pa, "_sms", lambda index: 132)
    monkeypatch.setattr(_dispatch, "launch",
                        lambda kernel, argtypes, device, *args:
                        calls.append(args[12]))
    for d in (40, 96, 128, 160, 256):
        pages = torch.zeros(4, 2, 16, d)
        table = torch.zeros(1, 2, dtype=torch.int32)
        lengths = torch.ones(1, dtype=torch.int32)
        pa.paged_decode_fwd(torch.zeros(1, 2, d), pages, pages, table,
                            lengths, scale=0.125)
    assert calls == [40, 96, 128, 160, 256]
    pages = torch.zeros(4, 2, 16, 33)
    rope = torch.zeros(1, 33)
    with pytest.raises(ValueError, match="even head dim"):
        pa.paged_decode_fwd(torch.zeros(1, 2, 33), pages, pages, table,
                            lengths, scale=0.125, rope_cos=rope,
                            rope_sin=rope)


# ---------------------------------------------------------------------------
# K6 at D 96, 128, 192 and 256
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [96, 128, 192, 256])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_wide_heads_match_jax_kernel(force_pallas, d, int8):
    """K6's twin at D 96, 128, 192 and 256 with the fused RoPE, f32 or
    int8 pages, against the Pallas paged decode; the idle slot exactly
    zero."""
    rs = np.random.RandomState(40 + d)
    b, h, page, pool, np_ = 3, 4, 8, 12, 3
    kp = rs.randn(pool, h, page, d).astype(np.float32)
    vp = rs.randn(pool, h, page, d).astype(np.float32)
    q = rs.randn(b, h, d).astype(np.float32)
    table = (rs.permutation(pool - 1)[: b * np_].reshape(b, np_) + 1).astype(
        np.int32)
    lengths = np.asarray([17, 9, 0], np.int32)
    kw = dict(rope_cos=rs.randn(b, d).astype(np.float32),
              rope_sin=rs.randn(b, d).astype(np.float32))
    if int8:
        kp, ks = (np.array(a) for a in encode_kv(jnp.asarray(kp)))
        vp, vs = (np.array(a) for a in encode_kv(jnp.asarray(vp)))
        kw.update(k_scale=ks, v_scale=vs)
    ref = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(table), jnp.asarray(lengths),
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    assert jax_dispatch.last_paths()["paged_decode_attention"] == "pallas"
    out = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lengths),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PAGED_TOL)
    assert float(out[2].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# K1/K2's launch plan
# ---------------------------------------------------------------------------


def _plan(rows, hidden, elem, ctas_per_sm=lambda vec, per_lane, warps: 1,
          **kw):
    return port_ln.norm_launch_plan(rows, hidden, elem, sms=132,
                                    ctas_per_sm=ctas_per_sm, **kw)


@pytest.mark.parametrize("hidden,elem,vec,per_lane,lanes", [
    (1024, 2, 8, 32, 32),   # GPT / BERT: four 16-byte loads a lane
    (128, 4, 4, 4, 32),     # the evoformer's pair rows: one float4 a lane
    (256, 4, 4, 8, 32),     # its MSA rows
    (64, 2, 8, 8, 8),       # a narrow row: 8 lanes, 4 rows a warp
    (1000, 2, 8, 32, 32),   # 2000 bytes: still whole 16-byte loads
    (1001, 2, 1, 32, 32),   # an odd width: rows start off 16 bytes
    (130, 4, 1, 8, 32),     # 520 bytes: one element a load
    (33, 4, 1, 4, 16),
])
def test_norm_plan_width_and_lanes(hidden, elem, vec, per_lane, lanes):
    plan = _plan(4096, hidden, elem)
    assert (plan.vec, plan.per_lane, plan.lanes) == (vec, per_lane, lanes)
    assert plan.rows_per_warp * plan.lanes == 32
    assert plan.lanes * plan.per_lane >= hidden
    assert plan.per_lane % plan.vec == 0


def test_norm_plan_misaligned_base_takes_one_element_loads():
    assert _plan(64, 1024, 2).vec == 8
    assert _plan(64, 1024, 2, aligned=False).vec == 1
    assert _plan(64, 128, 4, aligned=False).vec == 1


@pytest.mark.parametrize("rows,hidden,elem,bwd,ctas,grid,parts", [
    (16384, 1024, 2, False, 2, 264, 264),   # K1: 64 bytes a lane, 2 CTAs/SM
    (16384, 1024, 2, True, 1, 132, 132),    # K2: 1 CTA/SM, a partial each
    (65536, 128, 4, False, 4, 528, 528),
    (65536, 128, 4, True, 4, 528, 528),
    (32768, 256, 4, True, 2, 264, 264),
    (37, 1024, 2, False, 2, 5, 5),          # fewer rows than the grid
    # wider than the wide-row instance's 8192: streamed, a partial a warp
    (64, 12288, 2, True, 2, 8, 64),
    (64, 12288, 2, False, 4, 8, 64),
])
def test_norm_plan_grid(rows, hidden, elem, bwd, ctas, grid, parts):
    """The grid is the rows' CTAs, at most the resident CTAs per SM (the
    built instance's count, stood in for here) times the SMs; the plan
    asks for the count of the instance it chose."""
    asked = []
    plan = _plan(rows, hidden, elem, bwd=bwd,
                 ctas_per_sm=lambda vec, per_lane, warps: asked.append(
                     (vec, per_lane, warps)) or ctas)
    assert asked == [(plan.vec, plan.per_lane, plan.warps_per_row)]
    assert (plan.ctas_per_sm, plan.grid, plan.parts) == (ctas, grid, parts)
    assert plan.per_lane == (0 if hidden > port_ln.WIDE_MAX_HIDDEN
                             else plan.per_lane)


@pytest.mark.parametrize("rows,hidden,elem,bwd,vec,warps,per_lane,ctas,grid", [
    # bf16: 4 warps x 16 values to 2048, 4 x 32 to 4096, 8 x 32 to 8192
    (16384, 1536, 2, False, 8, 4, 16, 2, 264),
    (16384, 4096, 2, True, 8, 4, 32, 1, 132),
    (16384, 8192, 2, False, 8, 8, 32, 1, 132),
    (16384, 8192, 2, True, 8, 8, 32, 1, 132),
    # f32, float4 loads: 4 x 32 would not fit K2's registers, so 8 x 16
    (16384, 4096, 4, False, 4, 8, 16, 2, 264),
    (16384, 8192, 4, True, 4, 8, 32, 1, 132),
    # an odd width: one element per load, 8 x 16 (as f32)
    (1000, 2049, 2, True, 1, 8, 16, 1, 132),
    # fewer rows than the grid: a CTA per row group (two groups a CTA)
    (37, 1536, 2, True, 8, 4, 16, 2, 19),
    (5, 4096, 2, False, 8, 4, 32, 2, 3),
])
def test_norm_plan_wide_rows(rows, hidden, elem, bwd, vec, warps, per_lane,
                             ctas, grid):
    """Rows of 1025 to 8192 values take the wide-row instance: warps a
    row x 32 lanes x values a lane cover the row, the plan asks for the
    resident CTAs of that instance, a CTA holds 8 / warps row groups per
    pass, and K2 writes one partial row per CTA."""
    asked = []
    plan = _plan(rows, hidden, elem, bwd=bwd,
                 ctas_per_sm=lambda v, p, w: asked.append((v, p, w)) or ctas)
    assert (plan.vec, plan.warps_per_row, plan.per_lane) == (
        vec, warps, per_lane)
    assert asked == [(vec, per_lane, warps)]
    assert plan.lanes == 32 and plan.rows_per_warp == 1
    assert plan.warps_per_row * plan.lanes * plan.per_lane >= hidden
    assert plan.per_lane % plan.vec == 0
    assert plan.per_cta == port_ln.NORM_WARPS // warps
    assert (plan.ctas_per_sm, plan.grid, plan.parts) == (ctas, grid, grid)
    spec = port_ln.kernel_specs(rows, hidden,
                                torch.bfloat16 if elem == 2 else torch.float32,
                                bwd=bwd, ctas_per_sm=ctas,
                                aligned=vec > 1)[0]
    assert spec.full_name == (
        f"ln_{'bwd' if bwd else 'fwd'}_wide_kernel<"
        f"{'__nv_bfloat16' if elem == 2 else 'float'}, {vec}, {per_lane}, "
        f"{warps}>")
    assert spec.grid == grid and spec.smem_bytes == 0


@pytest.mark.parametrize("hidden", [1024, 4096])
@pytest.mark.parametrize("x_is_output", [False, True])
def test_bwd_plan_takes_b_alignment_in_x_is_output_mode(
        monkeypatch, hidden, x_is_output):
    """A bias off a 16-byte boundary (a view one float into a flat
    buffer) sends K2 to one element per load when ``x_is_output`` reads
    it (the wide-row instance loads b 16 bytes at a time), as it sends
    K1 always; the plain mode does not read b and keeps 16-byte loads."""
    from apex_tpu_torch.ops import tune_cache

    monkeypatch.setattr(port_ln.torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": 132}))
    monkeypatch.setattr(port_ln, "_resident_ctas", lambda *instance: 1)
    monkeypatch.setattr(tune_cache, "layer_norm_block_rows",
                        lambda hidden: None)
    x = torch.zeros(64, hidden, dtype=torch.bfloat16)
    g, dx = torch.zeros_like(x), torch.zeros_like(x)
    w = torch.ones(hidden)
    b = torch.zeros(hidden + 1)[1:]
    assert b.is_contiguous() and b.data_ptr() % 16 == 4
    plan = port_ln._bwd_plan(x, w, b, g, dx, x_is_output=x_is_output)
    assert plan.vec == (1 if x_is_output else 8)
    fwd = port_ln._plan(port_ln.KERNEL, x, dx, w, b, bwd=False)
    assert fwd.vec == 1
    aligned = port_ln._bwd_plan(x, w, torch.zeros(hidden), g, dx,
                                x_is_output=x_is_output)
    assert aligned.vec == 8
    assert (plan.warps_per_row, plan.per_lane) == (
        (1, 32) if hidden == 1024 else (8, 16) if x_is_output else (4, 32))


def test_norm_plan_refuses_bad_shapes():
    for args in ((0, 8, 2), (8, 0, 2), (8, 8, 8)):
        with pytest.raises(ValueError):
            _plan(*args)
    with pytest.raises(ValueError):  # an instance that fits no SM
        _plan(64, 1024, 2, ctas_per_sm=lambda vec, per_lane, warps: 0)


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd", "flash_dbias"])
def test_flash_kernels_dispatch_every_instance(name):
    """K3, K4 and K5 pick an instance for each of 32, 64, 128 and 256 and
    the wide one for any multiple of 128 above 256, and their f32
    counterparts in ``flash_f32.cu`` likewise (K3's and K4's through the
    ``APEX_F32_BY_D`` dispatch, which lists every head dim; K5's by the
    head dims its stages hold)."""
    src = _build.source_path(name).read_text()
    entry = src.split(f'extern "C" int {name}(')[1]
    wide = "d >= 256 && d % 128 == 0"
    for d in port_attn.KERNEL_HEAD_DIMS:
        assert f"pick<{d}>" in entry, (name, d)
    for d in port_attn.KERNEL_HEAD_DIMS[:-1]:
        assert f"d != {d}" in entry, (name, d)
    assert wide in entry, name
    assert ("launch_wide<" if name == "flash_fwd" else "pick<0>") in entry
    f32 = _build.source_path("flash_f32").read_text()
    body = f32.split(f'extern "C" int {name}_f32(')[1].split("\n}\n")[0]
    if name == "flash_dbias":
        for chunk in ("32, false", "64, false", "128, false", "64, true"):
            assert f"pick_dbias<{chunk}>" in body, chunk
    else:
        launcher = {"flash_fwd": "launch_fwd", "flash_bwd": "launch_bwd"}[name]
        assert re.search(rf"APEX_F32_BY_D\({launcher}, d,", body), name
        by_d = f32.split("#define APEX_F32_BY_D")[1].split("\n\n")[0]
        for d in port_attn.KERNEL_HEAD_DIMS + (0,):
            assert re.search(rf"APEX_F32_PICK\(FN, {d}, A, B\)", by_d), d
    bad_args = f32.split("bool bad_args(")[1].split("\n}\n")[0]
    for d in port_attn.KERNEL_HEAD_DIMS[:-1]:
        assert f"d != {d}" in bad_args, (name, d)
    assert wide in bad_args, name


def test_build_names_the_f32_kernels():
    assert "flash_f32" in _build.KERNELS
    for entry in ("flash_fwd_f32", "flash_bwd_f32", "flash_dbias_f32"):
        assert _build.library(entry) == "flash_f32"
        src = _build.source_path("flash_f32").read_text()
        args = src.split(f'extern "C" int {entry}(')[1].split(")")[0]
        want = {"flash_fwd_f32": port_attn._FWD_ARGS,
                "flash_bwd_f32": port_attn._BWD_ARGS,
                "flash_dbias_f32": port_attn._DBIAS_ARGS}[entry]
        assert args.count(",") + 1 == len(want), entry
    assert _build.library("flash_fwd") == "flash_fwd"


@pytest.mark.parametrize("name,args", [("layer_norm_fwd", "_FWD_ARGS"),
                                       ("layer_norm_bwd", "_BWD_ARGS")])
def test_norm_c_argument_lists_match_the_wrappers(name, args):
    src = _build.source_path(name).read_text()
    entry = src.split(f'extern "C" int {name}(')[1].split(")")[0]
    assert entry.count(",") + 1 == len(getattr(port_ln, args))


@pytest.mark.parametrize("name", ["layer_norm_fwd", "layer_norm_bwd"])
def test_norm_row_path_has_no_block_barrier(name):
    """K1's and K2's row loops reduce by shuffles only: the one
    ``__syncthreads`` left (K2's) is in the CTA's combine after the
    loop, and every load of a row is 16 bytes wide or one element."""
    src = _build.source_path(name).read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    start = code.index("{", code.index("for (int base = first; base < rows;"))
    depth = 0
    for end in range(start, len(code)):  # the loop body's closing brace
        depth += {"{": 1, "}": -1}.get(code[end], 0)
        if depth == 0:
            break
    row_loop = code[start:end]
    assert "group_sum(" in row_loop and "__syncthreads" not in row_loop
    assert "__shfl_xor_sync" in code and "uint4" in code


@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float16, torch.float16, torch.float16),
])
def test_mixed_and_f16_inputs_match_jax(force_pallas, dtypes):
    """q, k and v of mixed dtypes, or f16, which the reference's kernels
    widen to f32 before their dots: the port widens them exactly and runs
    the f32 path (its f32 kernel instances on the card).  o comes back in
    q's dtype and each gradient in its input's, against ``jax.vjp``.  o
    within TOL when q is f32, else within 1e-2 (one rounding to bf16 or
    f16, 2^-8 or 2^-11 of |o| < 4, on both sides); the gradients within
    5e-2: each is rounded to its input's dtype, and the JAX function
    takes bf16 and f16 products at its default precision."""
    b, h, s, d = 1, 2, 64, 64
    tdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}
    base = [_rand((b, h, s, d), seed) for seed in (31, 32, 33)]
    ts = [torch.from_numpy(a).to(dt).requires_grad_()
          for a, dt in zip(base, dtypes)]
    js = [jnp.asarray(t.detach().float().numpy()).astype(tdt[dt])
          for t, dt in zip(ts, dtypes)]
    do = _rand((b, h, s, d), 34)
    kw = dict(causal=True, scale=0.125)
    out_j, vjp = jax.vjp(lambda a, b_, c: jax_attn.flash_attention(
        a, b_, c, **kw), *js)
    grads_j = vjp(jnp.asarray(do).astype(out_j.dtype))
    out = port_attn.flash_attention(*ts, **kw)
    out.backward(torch.from_numpy(do).to(out.dtype))
    assert out.dtype == dtypes[0] and str(out_j.dtype) == str(
        dtypes[0]).split(".")[1]
    tol = TOL if dtypes[0] == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(out_j, np.float32), **tol)
    for t, dt, want in zip(ts, dtypes, grads_j):
        assert t.grad.dtype == dt
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=5e-2, rtol=5e-2)


def test_mixed_inputs_take_the_f32_kernels(fake_card):
    q = torch.zeros(1, 2, 16, 48, dtype=torch.float32)
    kv = torch.zeros(1, 2, 16, 48, dtype=torch.bfloat16)
    port_attn.flash_attention(q, kv, kv)
    assert fake_card == [("flash_fwd_f32", 64)]

"""The port's public names that are plain PyTorch, vs the JAX package.

- ``softmax_cross_entropy_loss`` / ``SoftmaxCrossEntropyLoss``: loss and
  gradient (``jax.vjp`` under a random cotangent) with smoothing 0 and
  0.1 and ``ignore_idx`` rows, on f32 logits (within 1e-6) and bf16
  logits (the loss within 1e-5, as both reduce in f32; the bf16
  gradient within one bf16 step, 2**-7 relative).
- the four scaled softmaxes and ``FusedScaleMaskSoftmax`` (padding with a
  fully masked row, causal, ``mask_func``, no mask), f32 within 1e-6 and
  bf16 within one bf16 step, with their gradients.
- ``fused_apply_rotary_pos_emb`` (freqs in radians, a partial rotary
  dim) and its gradient, within 1e-6.
- ``fmha_qkvpacked`` causal and with a padding bias, and the gradient of
  the packed input, within 1e-5 (f32 attention summed in other orders).
- ``state_dtype=torch.bfloat16`` on ``fused_adam`` and ``fused_lamb``:
  the first update equal to JAX's within 1e-6 and the moments stored as
  JAX's rounded to bf16; later steps equal to the JAX update fed the
  bf16-stored moments (the storage dtype's intent).  The JAX functions
  hand back f32 moments after the first update (ROADMAP C6): pinned here.
- ``DevicePrefetcher`` with ``device="cpu"``: order, structure, bounded
  look-ahead, the worker's error handed to the consumer, ``close()``.
"""

import importlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.ops import attention as jax_attention
from apex_tpu.ops import rope as jax_rope
from apex_tpu.ops import xentropy as jax_xent
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.optimizers import fused_lamb as jax_fused_lamb
from apex_tpu.transformer import enums as jax_enums
from apex_tpu.transformer.functional.fused_softmax import (
    FusedScaleMaskSoftmax as JaxFusedScaleMaskSoftmax,
)
from apex_tpu_torch import data as port_data
from apex_tpu_torch.ops import (
    SoftmaxCrossEntropyLoss,
    fmha_qkvpacked,
    fused_apply_rotary_pos_emb,
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
    softmax_cross_entropy_loss,
)
from apex_tpu_torch.optimizers import fused_adam, fused_lamb
from apex_tpu_torch.transformer import enums
from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

# the package re-exports the function under the module's name
jax_ss = importlib.import_module("apex_tpu.ops.scaled_softmax")

F32 = dict(atol=1e-6, rtol=1e-6)
BF16 = dict(atol=2 ** -8, rtol=2 ** -7)
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, F32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, BF16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(x, dtype):
    """``x`` as a JAX array and a torch tensor of one dtype, the same
    values (rounded once)."""
    _, jdt, tdt, _ = DTYPES[dtype]
    t = torch.from_numpy(x).to(tdt)
    return jnp.asarray(t.float().numpy()).astype(jdt), t


def _vjp_both(jfn, tfn, xs, ct):
    """Output and input cotangents of the JAX and the port function on
    the same inputs ``xs`` ([(jax array, torch tensor)]) under the
    cotangent ``ct`` (numpy)."""
    jx = [a for a, _ in xs]
    y_j, vjp = jax.vjp(jfn, *jx)
    g_j = vjp(jnp.asarray(ct).astype(y_j.dtype))
    tx = [t.clone().requires_grad_(True) for _, t in xs]
    y = tfn(*tx)
    y.backward(torch.from_numpy(ct).to(y.dtype))
    return (_np(y_j), y.detach().float().numpy(),
            [_np(g) for g in g_j], [t.grad.float().numpy() for t in tx])


def _check(out, tol):
    y_j, y, g_j, g = out
    np.testing.assert_allclose(y, y_j, **tol)
    for a, b in zip(g, g_j):
        np.testing.assert_allclose(a, b, **tol)


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_cross_entropy_matches_jax(dtype, smoothing):
    rs = np.random.RandomState(int(smoothing * 10))
    n, v = 12, 37
    logits = (rs.randn(n, v) * 3).astype(np.float32)
    labels = rs.randint(0, v, n)
    labels[[2, 7]] = -100  # ignored rows
    jl, tl = _both(logits, dtype)
    ct = rs.randn(n).astype(np.float32)
    y_j, vjp = jax.vjp(lambda x: jax_xent.softmax_cross_entropy_loss(
        x, jnp.asarray(labels), smoothing), jl)
    (g_j,) = vjp(jnp.asarray(ct))
    tx = tl.clone().requires_grad_(True)
    y = softmax_cross_entropy_loss(tx, torch.from_numpy(labels), smoothing)
    assert y.dtype == torch.float32 and y.shape == (n,)
    y.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=1e-5, rtol=1e-6)
    assert np.all(y.detach().numpy()[[2, 7]] == 0)
    assert tx.grad.dtype == tl.dtype
    np.testing.assert_allclose(tx.grad.float().numpy(), _np(g_j),
                               **DTYPES[dtype][3])
    assert np.all(tx.grad.float().numpy()[[2, 7]] == 0)


def test_softmax_cross_entropy_loss_module_pads_with_padding_idx():
    rs = np.random.RandomState(1)
    logits = rs.randn(6, 9).astype(np.float32)
    labels = np.array([0, 3, 0, 8, 1, 0])
    want = jax_xent.SoftmaxCrossEntropyLoss.apply(
        jnp.asarray(logits), jnp.asarray(labels), 0.2, 0, True)
    got = SoftmaxCrossEntropyLoss.apply(
        torch.from_numpy(logits), torch.from_numpy(labels), 0.2, 0, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert np.all(got.numpy()[labels == 0] == 0)


# ---------------------------------------------------------------------------
# the scaled softmaxes
# ---------------------------------------------------------------------------


def _scores(seed, shape):
    return (np.random.RandomState(seed).randn(*shape) * 4).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_scaled_softmax_matches_jax(dtype):
    x = _scores(0, (2, 3, 5, 7))
    ct = _scores(1, x.shape)
    _check(_vjp_both(lambda a: jax_ss.scaled_softmax(a, 0.3),
                     lambda a: scaled_softmax(a, 0.3),
                     [_both(x, dtype)], ct), DTYPES[dtype][3])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fn", ["scaled_masked_softmax",
                                "generic_scaled_masked_softmax"])
def test_scaled_masked_softmax_matches_jax(dtype, fn):
    x = _scores(2, (2, 3, 6, 6))
    mask = np.random.RandomState(3).rand(2, 1, 6, 6) < 0.3
    mask[1, 0, 4] = True  # a fully masked row: exact zeros
    ct = _scores(4, x.shape)
    port = {"scaled_masked_softmax": scaled_masked_softmax,
            "generic_scaled_masked_softmax": generic_scaled_masked_softmax}
    out = _vjp_both(
        lambda a: getattr(jax_ss, fn)(a, jnp.asarray(mask), 0.5),
        lambda a: port[fn](a, torch.from_numpy(mask), 0.5),
        [_both(x, dtype)], ct)
    _check(out, DTYPES[dtype][3])
    assert np.all(out[1][1, :, 4] == 0) and np.all(out[3][0][1, :, 4] == 0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_scaled_upper_triang_masked_softmax_matches_jax(dtype):
    x = _scores(5, (4, 8, 8))
    ct = _scores(6, x.shape)
    out = _vjp_both(
        lambda a: jax_ss.scaled_upper_triang_masked_softmax(a, 0.7),
        lambda a: scaled_upper_triang_masked_softmax(a, 0.7),
        [_both(x, dtype)], ct)
    _check(out, DTYPES[dtype][3])
    assert np.allclose(out[1][:, 0, 0], 1.0)  # row 0 sees column 0 only
    with pytest.raises(ValueError, match="square"):
        scaled_upper_triang_masked_softmax(torch.zeros(2, 3, 5), 1.0)


def _additive(x, mask):
    return x + jnp.where(mask, -50.0, 0.0) if isinstance(x, jax.Array) \
        else x + torch.where(mask, -50.0, 0.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["padding", "causal", "mask_func",
                                  "no_mask"])
def test_fused_scale_mask_softmax_matches_jax(dtype, case):
    x = _scores(7, (2, 2, 6, 6))
    mask = np.random.RandomState(8).rand(2, 1, 6, 6) < 0.3
    kw = dict(input_in_bf16=dtype == "bf16", scale=0.25)
    if case == "causal":
        kw["attn_mask_type"] = enums.AttnMaskType.causal
        jkw = dict(kw, attn_mask_type=jax_enums.AttnMaskType.causal)
    else:
        jkw = dict(kw)
    if case == "mask_func":
        kw["mask_func"] = jkw["mask_func"] = _additive
    port, ref = FusedScaleMaskSoftmax(**kw), JaxFusedScaleMaskSoftmax(**jkw)
    m = None if case == "no_mask" else mask
    ct = _scores(9, x.shape)
    out = _vjp_both(
        lambda a: ref(a, None if m is None else jnp.asarray(m)),
        lambda a: port(a, None if m is None else torch.from_numpy(m)),
        [_both(x, dtype)], ct)
    _check(out, DTYPES[dtype][3])
    assert port.is_kernel_available(m, 2, 2, 6, 6)


def test_fused_scale_mask_softmax_flags_and_enums():
    with pytest.raises(RuntimeError, match="both fp16 and bf16"):
        FusedScaleMaskSoftmax(input_in_fp16=True, input_in_bf16=True)
    with pytest.raises(RuntimeError, match="fp32 when scaled"):
        FusedScaleMaskSoftmax(softmax_in_fp32=False, scale=2.0)
    for name in ("ModelType", "AttnType", "AttnMaskType", "LayerType"):
        ours, theirs = getattr(enums, name), getattr(jax_enums, name)
        assert {m.name: m.value for m in ours} == {
            m.name: m.value for m in theirs}


# ---------------------------------------------------------------------------
# RoPE and packed attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rot_dim", [16, 10])
def test_fused_apply_rotary_pos_emb_matches_jax(rot_dim):
    rs = np.random.RandomState(rot_dim)
    s, b, h, d = 12, 2, 3, 16
    t = rs.randn(s, b, h, d).astype(np.float32)
    inv = 1.0 / (10000 ** (np.arange(0, rot_dim, 2) / rot_dim))
    f = np.outer(np.arange(s), inv)
    freqs = np.concatenate([f, f], -1)[:, None, None, :].astype(np.float32)
    ct = rs.randn(*t.shape).astype(np.float32)
    out = _vjp_both(
        lambda a: jax_rope.fused_apply_rotary_pos_emb(a, jnp.asarray(freqs)),
        lambda a: fused_apply_rotary_pos_emb(a, torch.from_numpy(freqs)),
        [_both(t, "f32")], ct)
    _check(out, F32)
    np.testing.assert_array_equal(out[1][..., rot_dim:], t[..., rot_dim:])
    fr = torch.from_numpy(freqs).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    fused_apply_rotary_pos_emb(tt, fr).sum().backward()
    assert fr.grad is None  # the tables get no gradient, as the reference


@pytest.mark.parametrize("causal,with_bias", [(True, False), (False, True)])
def test_fmha_qkvpacked_matches_jax(causal, with_bias):
    rs = np.random.RandomState(int(causal))
    b, s, h, d = 2, 24, 2, 16
    qkv = rs.randn(b, s, 3, h, d).astype(np.float32)
    bias = None
    if with_bias:
        keep = np.arange(s)[None] < np.array([24, 13])[:, None]
        bias = np.where(keep, 0.0, -1e9)[:, None, None, :].astype(np.float32)
    ct = rs.randn(b, s, h, d).astype(np.float32)
    out = _vjp_both(
        lambda a: jax_attention.fmha_qkvpacked(
            a, None if bias is None else jnp.asarray(bias), causal=causal),
        lambda a: fmha_qkvpacked(
            a, None if bias is None else torch.from_numpy(bias),
            causal=causal),
        [_both(qkv, "f32")], ct)
    assert out[1].shape == (b, s, h, d)
    _check(out, dict(atol=1e-5, rtol=1e-5))


# ---------------------------------------------------------------------------
# optimizer state in bf16
# ---------------------------------------------------------------------------


def _problem(seed):
    rs = np.random.RandomState(seed)
    params = {"w": rs.randn(16, 8).astype(np.float32),
              "b": rs.randn(8).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * 0.3).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


def _bf16_round(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16).astype(jnp.float32), tree)


@pytest.mark.parametrize("name", ["adam", "lamb"])
def test_bf16_optimizer_state_matches_jax(name):
    make_j = {"adam": jax_fused_adam, "lamb": jax_fused_lamb}[name]
    make = {"adam": fused_adam, "lamb": fused_lamb}[name]
    params, grads = _problem(3 if name == "adam" else 4)
    tx_j = make_j(1e-2, weight_decay=0.01, state_dtype=jnp.bfloat16)
    tx = make(1e-2, weight_decay=0.01, state_dtype=torch.bfloat16)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    s_j, s = tx_j.init(p_j), tx.init(p)
    assert all(t.dtype == torch.bfloat16 for t in (*s.m.values(),
                                                   *s.v.values()))
    for step, g in enumerate(grads):
        u_j, s_j = tx_j.update({k: jnp.asarray(v) for k, v in g.items()},
                               s_j, p_j)
        # the reference hands back f32 moments (ROADMAP C6); its update
        # with the moments stored in bf16, as the port stores them:
        assert all(x.dtype == jnp.float32 for x in (*s_j.m.values(),
                                                    *s_j.v.values()))
        s_j = s_j._replace(m=_bf16_round(s_j.m), v=_bf16_round(s_j.v))
        u, s = tx.update({k: torch.from_numpy(v) for k, v in g.items()},
                         s, p)
        for k in params:
            assert s.m[k].dtype == s.v[k].dtype == torch.bfloat16
            np.testing.assert_allclose(u[k].numpy(), np.asarray(u_j[k]),
                                       atol=1e-6, rtol=1e-5,
                                       err_msg=f"{name} step {step} {k}")
            np.testing.assert_array_equal(s.m[k].float().numpy(),
                                          np.asarray(s_j.m[k]))
        p_j = optax.apply_updates(p_j, u_j)
        p = {k: p[k] + u[k] for k in p}


# ---------------------------------------------------------------------------
# DevicePrefetcher
# ---------------------------------------------------------------------------


def _batches(n, pulled):
    for i in range(n):
        pulled.append(i)
        yield {"x": np.full((2, 3), i, np.int32),
               "pair": (np.arange(4) + i, np.float32(i))}


def test_prefetcher_order_structure_and_close():
    pulled = []
    with port_data.DevicePrefetcher(_batches(6, pulled), device="cpu",
                                    depth=2) as pre:
        out = list(pre)
        m = pre.metrics()
    assert [int(b["x"][0, 0]) for b in out] == list(range(6))
    first = out[0]
    assert isinstance(first["x"], torch.Tensor) and first["x"].device.type \
        == "cpu"
    assert isinstance(first["pair"], tuple)
    assert torch.equal(first["pair"][0], torch.arange(4))
    assert m["batches"] == 6 and m["depth"] == 2
    assert 0.0 <= m["stall_fraction"] <= 1.0
    assert not pre._worker.is_alive()


def test_prefetcher_backpressure_is_bounded():
    """A consumer that stops pulling stalls the worker: it holds at most
    ``depth`` batches in the queue and one in its hands."""
    pulled = []
    pre = port_data.DevicePrefetcher(_batches(100, pulled), device="cpu",
                                     depth=3)
    try:
        next(pre)
        deadline = time.monotonic() + 5.0
        while len(pulled) < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.3)
        assert len(pulled) <= 1 + 3 + 1
    finally:
        pre.close()
    assert not pre._worker.is_alive()
    with pytest.raises(StopIteration):
        next(pre)


def test_prefetcher_hands_the_worker_error_to_the_consumer():
    def broken():
        yield np.zeros(2)
        raise OSError("disk gone")

    pre = port_data.DevicePrefetcher(broken(), device="cpu")
    next(pre)
    with pytest.raises(OSError, match="disk gone"):
        next(pre)
    pre.close()


def test_prefetcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_data.DevicePrefetcher(iter([]))
    assert threading.active_count() >= 1

"""The trainable bias's gradient as the epilogue of K4's dQ pass.

On the card a bf16 bias at G = BH and RS = Sq (one owner per dbias
element: every trainable bias of the ported models) gets its gradient
from ``flash_bwd_dbias``, K4 with K5's output written by its dQ pass;
other layouts, the wide head dims and f32 keep ``flash_bwd`` and then
``flash_dbias``.  Checked here without a GPU:

- the routing rule ``_fused_dbias`` over the dtype, the bias layout and
  the head dim;
- the fused call's twin ``flash_bwd_dbias_reference`` against the JAX
  package's Pallas ``flash_bwd`` and ``flash_dbias`` in interpret mode,
  on the same seeded numpy inputs (the JAX package's own padding of a
  ragged S applied to its side): causal and not, Sq != Sk both ways,
  dropout at the same int32 seed, S_k % 4 != 0.  Tolerance 2e-5 for dq,
  dk, dv (the Pallas kernels run an online softmax over key blocks and
  recompute p from the lse, the twin from the row max and sum) and 1e-4
  for dbias, as ``test_torch_attention.py`` holds K5's twin;
- ``_Flash.backward``'s route: on the card (stood in for by the twins)
  the fused call where the rule holds and K4 + K5 elsewhere, with the
  same gradients; on the CPU the twins, ``flash_dbias_reference`` looked
  up when the backward runs (a patched twin changes the bias gradient);
- the wrapper's launch and refusals, and its C entry point's arguments.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as jax_attn
from apex_tpu.ops.pallas import flash_attention as pallas
from apex_tpu_torch.ops import _build, _dispatch
from apex_tpu_torch.ops import attention as port_attn

TOL = dict(atol=2e-5, rtol=2e-5)
DBIAS_TOL = dict(atol=1e-4, rtol=1e-4)
B, H, SQ = 2, 3, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the routing rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("groups", [1, B, B * H])
@pytest.mark.parametrize("rows", [1, SQ])
@pytest.mark.parametrize("d", [32, 64, 256, 384])
def test_fused_dbias_rule(dtype, groups, rows, d):
    """Fused exactly for bf16, G = BH, RS = Sq and a kernel head dim of
    at most 256 (D 384 runs the wide instance, which keeps K5)."""
    bias = torch.zeros(groups, rows, 7)
    want = (dtype == torch.bfloat16 and groups == B * H and rows == SQ
            and d <= 256)
    assert port_attn._fused_dbias(bias, B * H, SQ, dtype, d) is want


@pytest.mark.parametrize("d,want", [(1, True), (48, True), (160, True),
                                    (257, False)])
def test_fused_dbias_rule_pads_the_head_dim(d, want):
    bias = torch.zeros(B * H, SQ, 7)
    assert port_attn._fused_dbias(bias, B * H, SQ, torch.bfloat16, d) is want


def test_fused_dbias_rule_needs_a_bias():
    assert port_attn._fused_dbias(None, B * H, SQ, torch.bfloat16, 64) is False
    # one query row: RS = 1 = Sq, each element still has one owner
    one = torch.zeros(B * H, 1, 7)
    assert port_attn._fused_dbias(one, B * H, 1, torch.bfloat16, 64) is True


# ---------------------------------------------------------------------------
# the twin against the Pallas flash_bwd and flash_dbias
# ---------------------------------------------------------------------------


def _pallas_grads(q, k, v, do, bias, seed, *, scale, causal, p):
    """The Pallas flash_fwd, flash_bwd and flash_dbias in interpret mode on
    (BH, S, D) numpy inputs, padded as the JAX package's flash_attention
    pads a ragged S (keys masked at PAD_VALUE, zero rows), sliced back."""
    sq, sk = q.shape[1], k.shape[1]
    pad_q, pad_k = jax_attn._seq_pad(sq), jax_attn._seq_pad(sk)
    qp = np.pad(q, ((0, 0), (0, pad_q), (0, 0)))
    dop = np.pad(do, ((0, 0), (0, pad_q), (0, 0)))
    kp, vp = (np.pad(t, ((0, 0), (0, pad_k), (0, 0))) for t in (k, v))
    bp = np.pad(bias, ((0, 0), (0, 0), (0, pad_k)),
                constant_values=pallas.PAD_VALUE)
    bp = np.pad(bp, ((0, 0), (0, pad_q), (0, 0)))
    kw = dict(scale=scale, causal=causal, causal_offset=sk - sq,
              dropout_p=p, dropout_seed=jnp.asarray(seed) if p else None)
    qj, kj, vj, doj, bj = (jnp.asarray(t) for t in (qp, kp, vp, dop, bp))
    o, lse = pallas.flash_fwd(qj, kj, vj, bj, **kw)
    dq, dk, dv = pallas.flash_bwd(qj, kj, vj, o, lse, doj, bj, **kw)
    dbias = pallas.flash_dbias(qj, kj, vj, o, lse, doj, bj, **kw)
    return (np.asarray(dq)[:, :sq], np.asarray(dk)[:, :sk],
            np.asarray(dv)[:, :sk], np.asarray(dbias)[:, :sq, :sk])


@pytest.mark.parametrize("sq,sk,causal,p,d", [
    (128, 128, False, 0.0, 32),   # the triangle's layout, non-causal
    (128, 128, True, 0.0, 64),
    (64, 128, True, 0.0, 32),     # Sq < Sk, bottom-right causal
    (128, 64, True, 0.0, 32),     # Sq > Sk: rows 0..63 fully masked
    (128, 64, False, 0.0, 64),
    (128, 128, False, 0.1, 32),   # dropout at the same int32 seed
    (100, 37, False, 0.0, 32),    # S_k % 4 != 0 (ragged both ways)
    (37, 101, True, 0.1, 64),     # ragged, causal, dropout
])
def test_fused_twin_matches_jax_pallas(sq, sk, causal, p, d):
    """``flash_bwd_dbias_reference`` at G = BH, RS = Sq (BH 4) against
    the Pallas flash_bwd + flash_dbias, on the port's own forward
    statistics: dq, dk, dv within TOL, dbias within DBIAS_TOL."""
    bh = 4
    rs = np.random.RandomState(90 + sq + sk)
    q = rs.randn(bh, sq, d).astype(np.float32)
    k, v = (rs.randn(bh, sk, d).astype(np.float32) for _ in range(2))
    do = rs.randn(bh, sq, d).astype(np.float32)
    bias = (2.0 * rs.randn(bh, sq, sk)).astype(np.float32)
    seed = np.array([rs.randint(-2 ** 31, 2 ** 31 - 1)], np.int32)
    scale = d ** -0.5
    want = _pallas_grads(q, k, v, do, bias, seed[0], scale=scale,
                         causal=causal, p=p)
    qt, kt, vt, dot, bt = (torch.from_numpy(t) for t in (q, k, v, do, bias))
    st = torch.from_numpy(seed) if p else None
    kw = dict(scale=scale, causal=causal, dropout_p=p, seed=st)
    o, _, m, l = port_attn.flash_fwd_reference(qt, kt, vt, bt, **kw)
    delta = (dot * o).sum(-1)
    got = port_attn.flash_bwd_dbias_reference(qt, kt, vt, dot, m, l, delta,
                                              bt, **kw)
    assert got[3].shape == bt.shape and got[3].dtype == torch.float32
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    np.testing.assert_allclose(got[3].numpy(), want[3], **DBIAS_TOL)
    assert np.abs(want[3]).max() > 1e-2
    if causal:  # the masked pairs' dbias is exactly 0 on both sides
        masked = ~np.tril(np.ones((sq, sk), bool), k=sk - sq)
        assert (got[3].numpy()[:, masked] == 0).all()


def test_fused_twin_is_the_two_twins():
    """The fused twin returns what flash_bwd_reference and then
    flash_dbias_reference return, bit for bit."""
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(6, 9, 16, generator=g) for _ in range(4))
    bias = torch.randn(6, 9, 9, generator=g)
    kw = dict(scale=0.25, causal=True)
    o, _, m, l = port_attn.flash_fwd_reference(q, k, v, bias, **kw)
    args = (q, k, v, do, m, l, (do * o).sum(-1), bias)
    got = port_attn.flash_bwd_dbias_reference(*args, **kw)
    want = (*port_attn.flash_bwd_reference(*args, **kw),
            port_attn.flash_dbias_reference(*args, **kw))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# _Flash.backward's route
# ---------------------------------------------------------------------------


def _twins_on_a_fake_card(monkeypatch):
    """On the card, with each kernel wrapper stood in for by its twin and
    recorded."""
    monkeypatch.setattr(_dispatch, "on_card", lambda *tensors: True)
    calls = []
    for name in ("flash_fwd", "flash_bwd", "flash_dbias", "flash_bwd_dbias"):
        twin = getattr(port_attn, name + "_reference")

        def wrapper(*args, _name=name, _twin=twin, **kwargs):
            calls.append(_name)
            return _twin(*args, **kwargs)

        monkeypatch.setattr(port_attn, name, wrapper)
    return calls


def _bias_grad(bias_shape, dtype=torch.bfloat16, d=32, causal=False):
    """(o, q.grad, bias.grad) of flash_attention with a trainable bias."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 3, 16, d, generator=g).to(dtype)
               .requires_grad_() for _ in range(3))
    bias = torch.randn(*bias_shape, generator=g).requires_grad_()
    out = port_attn.flash_attention(q, k, v, bias, causal=causal,
                                    bias_grad=True)
    out.float().square().sum().backward()
    return out.detach(), q.grad, bias.grad


@pytest.mark.parametrize("bias_shape,dtype,d,fused", [
    ((1, 3, 16, 16), torch.bfloat16, 32, True),   # the evoformer's (1, H, N, N)
    ((2, 3, 16, 16), torch.bfloat16, 64, True),
    ((2, 1, 1, 16), torch.bfloat16, 32, False),   # G = B, RS = 1
    ((1, 1, 16, 16), torch.bfloat16, 32, False),  # G = 1
    ((1, 3, 16, 16), torch.float32, 32, False),   # the f32 instances
    ((1, 3, 16, 16), torch.bfloat16, 384, False),  # the wide instance
])
def test_backward_route_on_the_card(monkeypatch, bias_shape, dtype, d, fused):
    """The fused call where ``_fused_dbias`` holds, K4 then K5 elsewhere;
    either way the gradients are the CPU route's."""
    want = _bias_grad(bias_shape, dtype, d)
    calls = _twins_on_a_fake_card(monkeypatch)
    got = _bias_grad(bias_shape, dtype, d)
    assert calls == (["flash_fwd", "flash_bwd_dbias"] if fused
                     else ["flash_fwd", "flash_bwd", "flash_dbias"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_mask_only_bias_takes_plain_k4(monkeypatch):
    calls = _twins_on_a_fake_card(monkeypatch)
    q = torch.randn(1, 3, 16, 32).to(torch.bfloat16).requires_grad_()
    bias = torch.randn(1, 3, 16, 16)
    port_attn.flash_attention(q, q, q, bias).float().sum().backward()
    assert calls == ["flash_fwd", "flash_bwd"]


def test_cpu_route_reads_the_dbias_twin_when_called(monkeypatch):
    """On the CPU a fused-eligible call (bf16, G = BH, RS = Sq) still runs
    flash_bwd_reference and flash_dbias_reference, looked up in the
    module when the backward runs: a twin patched after the forward
    halves the bias gradient and leaves the rest."""
    _, q_grad, bias_grad = _bias_grad((1, 3, 16, 16))
    twin = port_attn.flash_dbias_reference
    monkeypatch.setattr(port_attn, "flash_dbias_reference",
                        lambda *a, **kw: 0.5 * twin(*a, **kw))
    _, q_half, bias_half = _bias_grad((1, 3, 16, 16))
    assert torch.equal(q_half, q_grad)
    torch.testing.assert_close(bias_half, 0.5 * bias_grad)
    assert float(bias_grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# the wrapper and its C entry point
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(_dispatch, "on_card", lambda *tensors: True)

    def launch(kernel, argtypes, device, *args):
        assert len(args) + 1 == len(argtypes)
        ints = argtypes.index(ctypes.c_int)
        calls.append((kernel, args[ints:ints + 6]))

    monkeypatch.setattr(_dispatch, "launch", launch)
    return calls


@pytest.mark.parametrize("d,padded", [(32, 32), (48, 64), (128, 128),
                                      (160, 256)])
def test_wrapper_launches_the_fused_entry(fake_launch, d, padded):
    bh, sq, sk = 6, 16, 24
    q = torch.zeros(bh, sq, d, dtype=torch.bfloat16)
    kv = torch.zeros(bh, sk, d, dtype=torch.bfloat16)
    stats = torch.zeros(bh, sq)
    bias = torch.zeros(bh, sq, sk)
    dq, dk, dv, dbias = port_attn.flash_bwd_dbias(
        q, kv, kv, q, stats, stats, stats, bias, scale=0.125, causal=True)
    # bh, sq, sk, the padded head dim, G = BH, RS = Sq
    assert fake_launch == [("flash_bwd_dbias", (bh, sq, sk, padded, bh, sq))]
    assert dq.shape == q.shape and dk.shape == dv.shape == kv.shape
    assert dbias.shape == bias.shape and dbias.dtype == torch.float32


@pytest.mark.parametrize("what", ["f32", "G=1", "RS=1", "D=384"])
def test_wrapper_refuses_what_is_not_fused(fake_launch, what):
    bh, s = 6, 16
    d = 384 if what == "D=384" else 64
    dtype = torch.float32 if what == "f32" else torch.bfloat16
    q = torch.zeros(bh, s, d, dtype=dtype)
    stats = torch.zeros(bh, s)
    bias = torch.zeros(1 if what == "G=1" else bh, 1 if what == "RS=1" else s,
                       s)
    with pytest.raises(ValueError, match="flash_bwd_dbias takes"):
        port_attn.flash_bwd_dbias(q, q, q, q, stats, stats, stats, bias,
                                  scale=0.125, causal=False)
    assert fake_launch == []


def test_wrapper_refuses_cpu_tensors():
    q = torch.zeros(2, 16, 32, dtype=torch.bfloat16)
    stats = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        port_attn.flash_bwd_dbias(q, q, q, q, stats, stats, stats,
                                  torch.zeros(2, 16, 16), scale=0.125,
                                  causal=False)


def test_entry_point_lives_in_k4_and_takes_the_wrapper_arguments():
    assert _build.library("flash_bwd_dbias") == "flash_bwd"
    src = _build.source_path("flash_bwd").read_text()
    entry = src.split('extern "C" int flash_bwd_dbias(')[1]
    args = entry.split(")")[0]
    assert args.count(",") + 1 == len(port_attn._BWD_DBIAS_ARGS)
    body = entry.split("\n}\n")[0]
    for d in port_attn.KERNEL_HEAD_DIMS:
        assert f"pick_dbias<{d}>" in body, d
    assert "groups != bh" in body and "bias_rows != sq" in body
    # the fused pass is a kernel of its own name over the dQ pass's body
    assert "flash_bwd_dq_dbias_kernel" in src
    assert "dq_pass<D, kBias, kDropout, true>" in src

"""apex_tpu_torch's focal, index_mul_2d and transducer ops against the
JAX package.

The same seeded numpy inputs go through the reference's function and
the port's; the values and the gradients (``jax.grad``/``jax.vjp``
against ``torch.autograd``) must agree within ``TOL`` in f32:

- ``focal_loss`` with ignored anchors (t = -1), all-negative anchors (t
  = 0), label smoothing, ``num_real_classes`` below C and a
  ``num_positives_sum`` under 1, on f32 and bf16 logits (the math f32
  in both packages); ``sigmoid_focal_loss`` elementwise;
- ``index_mul_2d``'s value and both gradients with repeated indices
  (the gradient of ``in1`` accumulates over them), and its row check;
- ``transducer_loss`` and ``TransducerLoss`` (values and gradients)
  with ragged f_len and y_len, a label equal to the blank, y_len 0 and
  f_len 1, and against a brute-force lattice sum at tiny T and U (the
  JAX test's); in f64 the port's gradient against a central difference;
- ``transducer_joint`` (ReLU) at p = 0 exactly the reference's; its
  dropout's keep rate and ``1 / (1 - p)`` scale (the bits come from a
  ``torch.Generator``, not JAX's threefry: a kept divergence), the
  same generator state giving the same mask; the reference's
  refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import focal_loss as jfl
from apex_tpu.contrib import index_mul_2d as jim
from apex_tpu.contrib import transducer as jtr
from apex_tpu_torch.contrib import focal_loss as pfl
from apex_tpu_torch.contrib import index_mul_2d as pim
from apex_tpu_torch.contrib import transducer as ptr

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=0, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# focal loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("smoothing,real,npos", [(0.0, None, 7.0),
                                                 (0.1, 5, 7.0),
                                                 (0.0, 6, 0.5)])
def test_focal_loss_matches_jax(smoothing, real, npos, dtype):
    logits = _x((3, 40, 8), scale=2.0)
    targets = np.random.RandomState(1).randint(-1, 9, (3, 40))
    targets[0, :4] = (-1, 0, 1, 8)
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    tl.requires_grad_(True)

    def jfn(lg):
        return jfl.focal_loss(lg, jnp.asarray(targets), jnp.asarray(npos),
                              num_real_classes=real,
                              label_smoothing=smoothing)

    want, gj = jax.value_and_grad(jfn)(jl)
    got = pfl.focal_loss(tl, torch.from_numpy(targets), torch.tensor(npos),
                         num_real_classes=real, label_smoothing=smoothing)
    got.backward()
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got.detach(), want)
    assert tl.grad.dtype == tl.dtype
    tol = TOL if dtype == "float32" else dict(atol=1e-6, rtol=1e-2)
    _close(tl.grad.float(), np.asarray(gj, np.float32), tol)
    # ignored anchors and masked classes get no gradient
    g = tl.grad.float().numpy()
    assert not g[targets < 0].any()
    if real is not None:
        assert not g[..., real:].any()


def test_sigmoid_focal_loss_elementwise():
    lg, t = _x((6, 5), scale=3.0), (np.random.RandomState(2).rand(6, 5)
                                    > 0.7).astype(np.float32)
    want = jfl.sigmoid_focal_loss(jnp.asarray(lg), jnp.asarray(t), 0.3, 1.5,
                                  0.05)
    got = pfl.sigmoid_focal_loss(torch.from_numpy(lg), torch.from_numpy(t),
                                 0.3, 1.5, 0.05)
    _close(got, want)


# ---------------------------------------------------------------------------
# index_mul_2d
# ---------------------------------------------------------------------------


def test_index_mul_2d_accumulates_over_repeated_indices():
    in1, in2 = _x((7, 5)), _x((9, 5), seed=1)
    idx = np.array([0, 2, 2, 6, 2, 1, 0, 6, 3])
    g = _x((9, 5), seed=2)
    out, vjp = jax.vjp(lambda a, b: jim.index_mul_2d(a, b, jnp.asarray(idx)),
                       jnp.asarray(in1), jnp.asarray(in2))
    d1, d2 = vjp(jnp.asarray(g))
    a = torch.from_numpy(in1).requires_grad_(True)
    b = torch.from_numpy(in2).requires_grad_(True)
    y = pim.index_mul_2d(a, b, torch.from_numpy(idx))
    y.backward(torch.from_numpy(g))
    _close(y.detach(), out)
    _close(a.grad, d1)
    _close(b.grad, d2)
    # row 2 is gathered three times: its gradient is the sum of three
    _close(a.grad[2], (g * in2)[[1, 2, 4]].sum(axis=0))
    assert not a.grad[[4, 5]].any()


def test_index_mul_2d_checks_rows():
    with pytest.raises(ValueError, match="must match idx1"):
        pim.index_mul_2d(torch.ones(4, 2), torch.ones(3, 2),
                         torch.zeros(2, dtype=torch.long))


# ---------------------------------------------------------------------------
# transducer
# ---------------------------------------------------------------------------


def _brute_force_rnnt(log_probs, labels, t_len, u_len, blank):
    """The O(T U) lattice sum in numpy, one batch element."""
    alpha = np.full((t_len, u_len + 1), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(t_len):
        for u in range(u_len + 1):
            cands = []
            if t > 0:
                cands.append(alpha[t - 1, u] + log_probs[t - 1, u, blank])
            if u > 0:
                cands.append(alpha[t, u - 1]
                             + log_probs[t, u - 1, labels[u - 1]])
            if cands:
                alpha[t, u] = np.logaddexp.reduce(cands)
    return -(alpha[t_len - 1, u_len] + log_probs[t_len - 1, u_len, blank])


def _rnnt_inputs(b=4, t=7, u=5, v=9, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, t, u + 1, v).astype(np.float32)
    labels = rs.randint(0, v, (b, u))  # 0 (the blank) among them
    f_len = np.array([t, 4, 1, t - 2][:b])
    y_len = np.array([u, 2, 0, u - 1][:b])
    return x, labels, f_len, y_len


@pytest.mark.parametrize("blank", [0, 3])
def test_transducer_loss_matches_jax(blank):
    x, labels, f_len, y_len = _rnnt_inputs()
    w = np.arange(1.0, 5.0, dtype=np.float32)  # a different weight each

    def jfn(x):
        nll = jtr.TransducerLoss()(x, jnp.asarray(labels),
                                   jnp.asarray(f_len), jnp.asarray(y_len),
                                   blank_idx=blank)
        return jnp.sum(nll * w), nll

    (_, want), gj = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    nll = ptr.TransducerLoss()(xt, torch.from_numpy(labels),
                               torch.from_numpy(f_len),
                               torch.from_numpy(y_len), blank_idx=blank)
    (nll * torch.from_numpy(w)).sum().backward()
    _close(nll.detach(), want)
    _close(xt.grad, gj)


def test_transducer_loss_is_the_lattice_sum():
    x, labels, f_len, y_len = _rnnt_inputs(b=3, t=6, u=4, v=7, seed=1)
    lp = torch.log_softmax(torch.from_numpy(x), dim=-1)
    nll = ptr.transducer_loss(lp, torch.from_numpy(labels),
                              torch.from_numpy(f_len), torch.from_numpy(y_len))
    for b in range(3):
        want = _brute_force_rnnt(lp[b].numpy().astype(np.float64), labels[b],
                                 f_len[b], y_len[b], 0)
        np.testing.assert_allclose(float(nll[b]), want, rtol=1e-5, atol=1e-5)


def test_transducer_gradient_in_f64_is_the_difference_quotient():
    x, labels, f_len, y_len = _rnnt_inputs(b=2, t=4, u=3, v=5, seed=2)
    lp = torch.from_numpy(x).double()
    args = (torch.from_numpy(labels), torch.from_numpy(f_len[:2]),
            torch.from_numpy(y_len[:2]))
    assert torch.autograd.gradcheck(
        lambda a: ptr.transducer_loss(a, *args, blank_idx=2),
        (lp.requires_grad_(True),), eps=1e-6, atol=1e-6)
    assert ptr.transducer_loss(lp, *args).dtype == torch.float64


def test_transducer_joint_without_dropout_is_the_references():
    f, g = _x((2, 5, 8)), _x((2, 3, 8), seed=1)
    want = jtr.transducer_joint(jnp.asarray(f), jnp.asarray(g), relu=True)
    joint = ptr.TransducerJoint(relu=True)
    got = joint(torch.from_numpy(f), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_transducer_joint_dropout_rate_and_scale():
    p = 0.25
    f, g = _x((4, 64, 32)) ** 2 + 1.0, _x((4, 48, 32), seed=1) ** 2
    dense = ptr.transducer_joint(torch.from_numpy(f), torch.from_numpy(g))
    joint = ptr.TransducerJoint(dropout=True, dropout_prob=p)
    out = joint(torch.from_numpy(f), torch.from_numpy(g),
                dropout_rng=torch.Generator().manual_seed(3))
    kept = out != 0
    n = kept.numel()
    # the keep rate within 5 binomial standard deviations of 1 - p
    assert abs(kept.float().mean().item() - (1 - p)) < 5 * np.sqrt(
        p * (1 - p) / n)
    _close(out[kept], dense[kept] / (1 - p))
    again = joint(torch.from_numpy(f), torch.from_numpy(g),
                  dropout_rng=torch.Generator().manual_seed(3))
    assert torch.equal(again, out)
    # the reference's keep rate and scale, on its own bits
    jout = np.asarray(jtr.transducer_joint(
        jnp.asarray(f), jnp.asarray(g), dropout_p=p,
        dropout_rng=jax.random.PRNGKey(0)))
    assert abs((jout != 0).mean() - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)


def test_transducer_refusals():
    with pytest.raises(NotImplementedError, match="pack_output"):
        ptr.TransducerJoint(pack_output=True)
    with pytest.raises(NotImplementedError, match="packed_input"):
        ptr.TransducerLoss(packed_input=True)
    with pytest.raises(ValueError, match="dropout_rng"):
        ptr.transducer_joint(torch.ones(1, 2, 4), torch.ones(1, 3, 4),
                             dropout_p=0.1)
    with pytest.raises(NotImplementedError):
        jtr.TransducerJoint(pack_output=True)

"""apex_tpu_torch's normalization modules vs the JAX package.

``FusedLayerNorm`` and ``FusedRMSNorm`` (with and without
``elementwise_affine``, ``memory_efficient`` both ways, a 2-d
``normalized_shape``, bf16 rows under f32 parameters) give the flax
modules' outputs and ``jax.vjp``'s gradients on the same seeded numpy
inputs and parameters; ``instance_norm`` and ``InstanceNorm3d`` (both
layouts, affine or not, the running statistics over three training calls
and the evaluation from them) give the JAX module's outputs and
``batch_stats``.  f32 within ``TOL`` (the two sum rows in different
orders); bf16 within ``BF16_TOL`` (one bf16 rounding of each side's f32
result).  The aliases and the contrib re-exports are the same objects.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import normalization as jnorm
from apex_tpu_torch import normalization as pnorm

TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(shape, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape) * 2.0 + 0.5).astype(np.float32)


def _params(shape, rms, seed=1):
    rs = np.random.RandomState(seed)
    p = {"weight": (1.0 + 0.1 * rs.randn(*shape)).astype(np.float32)}
    if not rms:
        p["bias"] = (0.1 * rs.randn(*shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("memory_efficient", [False, True])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
@pytest.mark.parametrize("shape", [(64,), (4, 24)], ids=["1d", "2d"])
def test_fused_norm_modules_match_jax(shape, rms, affine, memory_efficient):
    x = _rows((3, 5) + shape)
    g = _rows((3, 5) + shape, seed=2)
    jcls, pcls = ((jnorm.FusedRMSNorm, pnorm.FusedRMSNorm) if rms
                  else (jnorm.FusedLayerNorm, pnorm.FusedLayerNorm))
    kw = dict(elementwise_affine=affine, memory_efficient=memory_efficient)
    jm = jcls(shape, **kw)
    params = {"params": _params(shape, rms)} if affine else {}
    y_j, vjp = jax.vjp(lambda p, a: jm.apply(p, a), params, jnp.asarray(x))
    dp_j, dx_j = vjp(jnp.asarray(g))
    pm = pcls(shape, device="cpu", **kw)
    if affine:
        pnorm.from_jax_params(pm, params)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = pm(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)
    for name, p in pm.named_parameters():
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(dp_j["params"][name]), **TOL)
    if not affine:
        assert not list(pm.parameters())


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
def test_bf16_rows_f32_params(rms):
    x = _rows((6, 128))
    jcls, pcls = ((jnorm.FusedRMSNorm, pnorm.FusedRMSNorm) if rms
                  else (jnorm.FusedLayerNorm, pnorm.FusedLayerNorm))
    params = {"params": _params((128,), rms)}
    y_j = jcls(128).apply(params, jnp.asarray(x, jnp.bfloat16))
    pm = pnorm.from_jax_params(pcls(128, device="cpu"), params)
    y = pm(torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y_j.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(y_j, np.float32), **BF16_TOL)


def test_aliases_and_reexports():
    from apex_tpu_torch.contrib import layer_norm, xentropy
    from apex_tpu_torch.ops import xentropy as ops_xentropy

    assert pnorm.MixedFusedLayerNorm is pnorm.FusedLayerNorm
    assert pnorm.MixedFusedRMSNorm is pnorm.FusedRMSNorm
    assert pnorm.InstanceNorm3dNVFuser is pnorm.InstanceNorm3d
    assert layer_norm.FastLayerNorm is pnorm.FusedLayerNorm
    assert xentropy.SoftmaxCrossEntropyLoss is \
        ops_xentropy.SoftmaxCrossEntropyLoss
    assert xentropy.softmax_cross_entropy_loss is \
        ops_xentropy.softmax_cross_entropy_loss


@pytest.mark.parametrize("stats", [None, "per_sample", "per_channel"])
@pytest.mark.parametrize("affine", [True, False])
def test_instance_norm_function(affine, stats):
    x = _rows((2, 3, 4, 5, 6))
    rs = np.random.RandomState(3)
    w = (1 + 0.1 * rs.randn(6)).astype(np.float32) if affine else None
    b = (0.1 * rs.randn(6)).astype(np.float32) if affine else None
    mv = {}
    if stats:
        shape = (2, 6) if stats == "per_sample" else (6,)
        mv = dict(mean=rs.randn(*shape).astype(np.float32),
                  var=(1 + rs.rand(*shape)).astype(np.float32))
    y_j = jnorm.instance_norm(
        jnp.asarray(x), None if w is None else jnp.asarray(w),
        None if b is None else jnp.asarray(b),
        **{k: jnp.asarray(v) for k, v in mv.items()})
    y = pnorm.instance_norm(
        torch.from_numpy(x), None if w is None else torch.from_numpy(w),
        None if b is None else torch.from_numpy(b),
        **{k: torch.from_numpy(v) for k, v in mv.items()})
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    yb = pnorm.instance_norm(torch.from_numpy(x).to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("affine", [True, False])
def test_instance_norm3d_running_stats(affine, channels_first):
    """Three training calls update the running statistics with the
    PyTorch momentum convention (unbiased variance) as the JAX module's
    ``batch_stats``; evaluation normalizes with them."""
    kw = dict(num_features=6, momentum=0.2, affine=affine,
              track_running_stats=True, channels_first=channels_first)
    jm = jnorm.InstanceNorm3d(**kw)
    shape = (2, 6, 3, 4, 5) if channels_first else (2, 3, 4, 5, 6)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros(shape))
    if affine:
        rs = np.random.RandomState(4)
        v = {"params": {"scale": (1 + 0.1 * rs.randn(6)).astype(np.float32),
                        "bias": (0.1 * rs.randn(6)).astype(np.float32)},
             "batch_stats": v["batch_stats"]}
    pm = pnorm.from_jax_params(pnorm.InstanceNorm3d(**kw, device="cpu"),
                               jax.tree.map(np.asarray, v))
    for i in range(3):
        x = _rows(shape, seed=10 + i)
        y_j, upd = jm.apply(v, jnp.asarray(x), use_running_average=False,
                            mutable=["batch_stats"])
        v = {**v, "batch_stats": upd["batch_stats"]}
        y = pm(torch.from_numpy(x))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(pm.running_mean.numpy(),
                               np.asarray(v["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(pm.running_var.numpy(),
                               np.asarray(v["batch_stats"]["var"]), **TOL)
    x = _rows(shape, seed=20)
    y_j = jm.apply(v, jnp.asarray(x), use_running_average=True)
    pm.eval()
    np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(y_j), **TOL)
    with pytest.raises(ValueError, match="expected 6 channels"):
        pm(torch.zeros((2, 3, 4, 5, 7) if not channels_first
                       else (2, 7, 3, 4, 5)))

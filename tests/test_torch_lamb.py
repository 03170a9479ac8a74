"""apex_tpu_torch's FusedLAMB and cross-tensor reductions vs the JAX
package.

- ``global_norm``, ``per_tensor_norm``, ``scale_with_overflow_check`` and
  ``axpby`` over f32 and bf16 tensors;
- ``fused_lamb`` over three steps against the JAX ``fused_lamb`` from
  the same parameters and gradients: the global-norm clip active and
  inactive, weight decay 0 (trust ratio 1) with and without
  ``use_nvlamb``, ``adam_w_mode=False``, ``grad_averaging=False``, no
  bias correction, a scheduled learning rate, and a parameter of zeros
  (its trust ratio falls back to 1);
- the stateful ``FusedLAMB`` against the JAX ``FusedLAMB`` wrapper.

Tolerances are stated per test.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.optimizers import fused_lamb as jax_fused_lamb
from apex_tpu.optimizers import multi_tensor as jax_mt
from apex_tpu_torch.optimizers import (
    FusedLAMB,
    axpby,
    fused_lamb,
    global_norm,
    per_tensor_norm,
    scale_with_overflow_check,
)

#: f32 elementwise arithmetic and f32 norms summed in other orders
TOL = dict(atol=1e-6, rtol=1e-5)


def _tensors(seed):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(8, 5).astype(np.float32),
            "b": (0.1 * rs.randn(5)).astype(np.float32),
            "z": np.zeros((3, 4), np.float32)}


def _problem(seed, grad_scale):
    params = _tensors(seed)
    rs = np.random.RandomState(seed + 100)
    grads = [{k: (grad_scale * rs.randn(*v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


def _sched(count):
    return 1e-2 / (1.0 + count)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norms_match_jax(dtype):
    """The global and per-tensor norms, f32 accumulation of f32 or bf16
    tensors, TOL."""
    t = _tensors(1)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tj = {k: jnp.asarray(v).astype(jdt) for k, v in t.items()}
    tt = {k: torch.from_numpy(v).to(tdt) for k, v in t.items()}
    np.testing.assert_allclose(float(global_norm(tt)),
                               float(jax_mt.global_norm(tj)), **TOL)
    np.testing.assert_allclose(float(global_norm(list(tt.values()))),
                               float(jax_mt.global_norm(tj)), **TOL)
    per_j = jax_mt.per_tensor_norm(tj)
    per = per_tensor_norm(tt)
    assert set(per) == set(per_j)
    for k in per:
        assert per[k].dtype == torch.float32
        np.testing.assert_allclose(float(per[k]), float(per_j[k]), **TOL)


def test_scale_and_axpby_match_jax():
    """Scaling with the inf/nan flag and a*x + b*y, TOL."""
    t = _tensors(2)
    u = _tensors(3)
    tj = {k: jnp.asarray(v) for k, v in t.items()}
    tt = {k: torch.from_numpy(v) for k, v in t.items()}
    out_j, inf_j = jax_mt.scale_with_overflow_check(tj, 0.5, jnp.bfloat16)
    out, inf = scale_with_overflow_check(tt, 0.5, torch.bfloat16)
    assert float(inf) == float(inf_j) == 0.0
    for k in t:
        assert out[k].dtype == torch.bfloat16
        np.testing.assert_allclose(out[k].float().numpy(),
                                   np.asarray(out_j[k], np.float32), **TOL)
    bad = dict(tt, w=tt["w"].clone())
    bad["w"][1, 2] = float("nan")
    assert float(scale_with_overflow_check(bad, 2.0)[1]) == 1.0
    ax_j = jax_mt.axpby(0.3, tj, -2.0, {k: jnp.asarray(v) for k, v in u.items()})
    ax = axpby(0.3, {k: torch.from_numpy(v) for k, v in t.items()}, -2.0,
               [torch.from_numpy(v) for v in u.values()])
    for k in t:
        np.testing.assert_allclose(ax[k].numpy(), np.asarray(ax_j[k]), **TOL)


CASES = {
    "clip_active": dict(grad_scale=3.0, kw=dict(weight_decay=0.01)),
    "clip_inactive": dict(grad_scale=0.01, kw=dict(weight_decay=0.01)),
    "no_clip": dict(grad_scale=3.0, kw=dict(max_grad_norm=0.0)),
    "wd0": dict(grad_scale=1.0, kw=dict(weight_decay=0.0)),
    "wd0_nvlamb": dict(grad_scale=1.0, kw=dict(weight_decay=0.0,
                                               use_nvlamb=True)),
    "l2_mode": dict(grad_scale=1.0, kw=dict(adam_w_mode=False,
                                            weight_decay=0.1)),
    "no_averaging_no_bias_correction": dict(
        grad_scale=1.0, kw=dict(grad_averaging=False, bias_correction=False)),
    "schedule": dict(grad_scale=1.0, kw=dict(learning_rate=_sched,
                                             beta1=0.8, beta2=0.95)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_lamb_three_steps_match_jax(case):
    """Functional form: the parameters and moments after each of three
    steps, TOL (updates are ~1e-3)."""
    spec = CASES[case]
    params, grads = _problem(seed=len(case), grad_scale=spec["grad_scale"])
    kw = dict(spec["kw"])
    kw.setdefault("learning_rate", 1e-2)
    tx_j, tx = jax_fused_lamb(**kw), fused_lamb(**kw)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    s_j, s = tx_j.init(p_j), tx.init(p)
    for g in grads:
        u_j, s_j = tx_j.update({k: jnp.asarray(v) for k, v in g.items()},
                               s_j, p_j)
        p_j = optax.apply_updates(p_j, u_j)
        u, s = tx.update({k: torch.from_numpy(v) for k, v in g.items()}, s, p)
        p = {k: p[k] + u[k] for k in p}
        for k in params:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(p_j[k]), **TOL)
            np.testing.assert_allclose(s.m[k].numpy(), np.asarray(s_j.m[k]),
                                       **TOL)
            np.testing.assert_allclose(s.v[k].numpy(), np.asarray(s_j.v[k]),
                                       **TOL)
    assert s.count == int(s_j.count) == 3


@pytest.mark.parametrize("grad_scale", [0.01, 3.0])
def test_fused_lamb_optimizer_matches_jax_wrapper(grad_scale):
    """``FusedLAMB(params).step()`` on ``.grad`` against the JAX
    ``FusedLAMB(params).step(grads, params)``, three steps, TOL; the
    parameters sit in two groups, and the clip takes the norm over
    both."""
    params, grads = _problem(seed=20, grad_scale=grad_scale)
    kw = dict(lr=3e-3, betas=(0.8, 0.95), eps=1e-6, weight_decay=0.05)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    opt_j = JaxFusedLAMB(p_j, **kw)
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = FusedLAMB([{"params": [ps["w"]]}, {"params": [ps["b"], ps["z"]]}],
                    **kw)
    for g in grads:
        p_j = opt_j.step({k: jnp.asarray(v) for k, v in g.items()}, p_j)
        for k, v in g.items():
            ps[k].grad = torch.from_numpy(v)
        opt.step()
    for k in params:
        np.testing.assert_allclose(ps[k].detach().numpy(), np.asarray(p_j[k]),
                                   **TOL)


def test_fused_lamb_leaves_the_gradients_alone():
    """A clipped step reads the f32 gradients without writing them."""
    params, grads = _problem(seed=30, grad_scale=3.0)
    ps = [torch.nn.Parameter(torch.from_numpy(v.copy()))
          for v in params.values()]
    for p, g in zip(ps, grads[0].values()):
        p.grad = torch.from_numpy(g.copy())
    FusedLAMB(ps).step()
    for p, g in zip(ps, grads[0].values()):
        np.testing.assert_array_equal(p.grad.numpy(), g)


def test_fused_lamb_refuses_amsgrad():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB([torch.nn.Parameter(torch.zeros(2))], amsgrad=True)

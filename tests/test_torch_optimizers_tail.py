"""apex_tpu_torch's remaining optimizers vs the JAX package.

Every factory of ``apex_tpu_torch.optimizers`` not held elsewhere
(``fused_sgd``, ``fused_adagrad``, ``fused_novograd``,
``fused_mixed_precision_lamb``, ``larc`` in front of ``fused_sgd``) runs 3
steps on the same seeded numpy parameters and gradients as its JAX
counterpart (an optax ``GradientTransformation``), under several
settings each; the parameters and the optimizer state after every step
agree within ``TOL`` (f32 arithmetic in a different order: the port's
``torch._foreach_*`` against XLA's fusions) and ``BF16_TOL`` for bf16
parameters (one bf16 rounding).  Also: SGD's first step stores the
gradient as the buffer, LARC passes a zero-norm parameter or gradient
through untouched, the step count on the device (the amp update's)
gives the host count's result, ``clip_grad_norm`` and ``clip_grad_norm_``
for norms 2, inf and 1.5, ``multi_tensor_apply``'s flatten and
unflatten, the stateful wrappers, and the ImageNet example's
``fused_sgd(lr, momentum=0.9)`` against ``optax.sgd``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu import multi_tensor_apply as jmta
from apex_tpu import optimizers as jopt
from apex_tpu_torch import multi_tensor_apply as pmta
from apex_tpu_torch import optimizers as popt
from apex_tpu_torch.amp.scaler import _as_device_count

TOL = dict(atol=1e-6, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
SHAPES = {"w": (8, 6), "b": (6,), "conv": (3, 3, 4, 5), "s": ()}
STEPS = 3


def _params(seed=0, zero=()):
    rs = np.random.RandomState(seed)
    out = {k: np.asarray(rs.randn(*s), np.float32) for k, s in SHAPES.items()}
    for k in zero:
        out[k] = np.zeros_like(out[k])
    return out


def _grads(step, zero=()):
    rs = np.random.RandomState(100 + step)
    out = {k: np.asarray(rs.randn(*s) * 0.5, np.float32)
           for k, s in SHAPES.items()}
    for k in zero:
        out[k] = np.zeros_like(out[k])
    return out


def _np(tree):
    """A JAX or port state as nested lists of numpy arrays (in key
    order for dicts)."""
    if isinstance(tree, dict):
        return [_np(tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [_np(t) for t in tree]
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.asarray(tree, dtype=np.float32)


def _close(a, b, tol):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_allclose(a, b, **tol)


def _run_jax(tx, params, dtype, steps=STEPS, zero_grads=()):
    p = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    state = tx.init(p)
    out = []
    for i in range(steps):
        g = {k: jnp.asarray(v, dtype) for k, v in _grads(i, zero_grads).items()}
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
        out.append(({k: np.asarray(v, np.float32) for k, v in p.items()},
                    state))
    return out


def _run_port(tx, params, dtype, steps=STEPS, zero_grads=()):
    p = {k: torch.from_numpy(v).to(dtype) for k, v in params.items()}
    state = tx.init(p)
    out = []
    for i in range(steps):
        g = {k: torch.from_numpy(v).to(dtype)
             for k, v in _grads(i, zero_grads).items()}
        updates, state = tx.update(g, state, p)
        p = {k: v + updates[k].to(v.dtype) for k, v in p.items()}
        out.append(({k: v.float().numpy() for k, v in p.items()}, state))
    return out


def _state_parts(name, js, ps):
    """The comparable parts of a JAX and a port state."""
    if name == "sgd":
        return [js.momentum_buf], [ps.momentum_buf]
    if name == "adagrad":
        return [js.sum], [ps.sum]
    if name == "novograd":
        return [js.m, js.v], [ps.m, ps.v]
    if name == "mp_lamb":
        return ([js.masters, js.inner.m, js.inner.v],
                [ps.masters, ps.inner.m, ps.inner.v])
    if name == "larc_sgd":
        return [js[1].momentum_buf], [ps[1].momentum_buf]
    raise KeyError(name)


CASES = [
    ("sgd", dict(learning_rate=0.1)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("sgd", dict(learning_rate=0.05, momentum=0.9, dampening=0.1,
                 weight_decay=1e-2)),
    ("sgd", dict(learning_rate=0.05, momentum=0.8, nesterov=True,
                 weight_decay=1e-3)),
    ("adagrad", dict(learning_rate=0.1)),
    ("adagrad", dict(learning_rate=0.1, weight_decay=1e-2)),
    ("adagrad", dict(learning_rate=0.1, weight_decay=1e-2,
                     adagrad_w_mode=True)),
    ("novograd", dict(learning_rate=0.01)),
    ("novograd", dict(learning_rate=0.01, weight_decay=1e-2,
                      grad_averaging=False)),
    ("novograd", dict(learning_rate=0.01, weight_decay=1e-2, init_zero=True,
                      reg_inside_moment=True)),
    ("mp_lamb", dict(learning_rate=1e-2)),
    ("mp_lamb", dict(learning_rate=1e-2, weight_decay=0.0, max_grad_norm=0.5,
                     use_nvlamb=True)),
    ("larc_sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("larc_sgd", dict(learning_rate=0.1, momentum=0.9, clip=False,
                      weight_decay=1e-3)),
]


def _factories(name, kw, lib):
    kw = dict(kw)
    if name == "larc_sgd":
        lr, mom = kw.pop("learning_rate"), kw.pop("momentum")
        return lib.LARC(lib.fused_sgd(lr, momentum=mom), lr, **kw)
    return {"sgd": lib.fused_sgd, "adagrad": lib.fused_adagrad,
            "novograd": lib.fused_novograd,
            "mp_lamb": lib.fused_mixed_precision_lamb}[name](**kw)


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_three_steps_match_the_reference(name, kw):
    params = _params()
    ref = _run_jax(_factories(name, kw, jopt), params, jnp.float32)
    got = _run_port(_factories(name, kw, popt), params, torch.float32)
    for (pj, sj), (pp, sp) in zip(ref, got):
        _close(_np(pp), _np(pj), TOL)
        a, b = _state_parts(name, sj, sp)
        _close(_np(b), _np(a), TOL)


@pytest.mark.parametrize("name,kw", [CASES[1], CASES[5], CASES[8],
                                     CASES[10]],
                         ids=["sgd", "adagrad", "novograd", "mp_lamb"])
def test_bf16_params_match_the_reference(name, kw):
    """bf16 parameters and gradients: f32 arithmetic, updates in bf16
    (the mixed-precision LAMB's masters stay f32)."""
    params = _params(seed=3)
    ref = _run_jax(_factories(name, kw, jopt), params, jnp.bfloat16)
    got = _run_port(_factories(name, kw, popt), params, torch.bfloat16)
    for (pj, sj), (pp, sp) in zip(ref, got):
        _close(_np(pp), _np(pj), BF16_TOL)
        a, b = _state_parts(name, sj, sp)
        _close(_np(b), _np(a), BF16_TOL)
    if name == "mp_lamb":
        assert all(t.dtype == torch.float32
                   for t in got[-1][1].masters.values())


def test_sgd_first_step_buffer_is_the_gradient():
    params = _params()
    g0 = _grads(0)
    for wd in (0.0, 1e-2):
        tx = popt.fused_sgd(0.1, momentum=0.9, dampening=0.5,
                            weight_decay=wd)
        p = {k: torch.from_numpy(v) for k, v in params.items()}
        _, state = tx.update({k: torch.from_numpy(v) for k, v in g0.items()},
                             tx.init(p), p)
        for k in SHAPES:
            want = torch.from_numpy(g0[k]).add(torch.from_numpy(params[k]),
                                               alpha=wd)
            np.testing.assert_array_equal(state.momentum_buf[k].numpy(),
                                          want.numpy())


def test_sgd_nesterov_guard_raises():
    for lib in (jopt, popt):
        with pytest.raises(ValueError, match="Nesterov"):
            lib.fused_sgd(0.1, momentum=0.0, nesterov=True)
        with pytest.raises(ValueError, match="Nesterov"):
            lib.fused_sgd(0.1, momentum=0.9, dampening=0.1, nesterov=True)


def test_larc_zero_norm_passes_through():
    """A zero parameter ("b") and a zero gradient ("w") leave LARC as
    they came, also with weight decay (which is folded in only where
    both norms are non-zero)."""
    params = _params(zero=("b",))
    grads = _grads(0, zero=("w",))
    for clip in (True, False):
        kw = dict(learning_rate=0.1, clip=clip, weight_decay=1e-2)
        pj = {k: jnp.asarray(v) for k, v in params.items()}
        gj = {k: jnp.asarray(v) for k, v in grads.items()}
        jtx = jopt.larc(**kw)
        out_j, _ = jtx.update(gj, jtx.init(pj), pj)
        ptx = popt.larc(**kw)
        pt = {k: torch.from_numpy(v) for k, v in params.items()}
        gt = {k: torch.from_numpy(v) for k, v in grads.items()}
        out, state = ptx.update(gt, ptx.init(pt), pt)
        assert state.count == 1
        for k in ("b", "w"):
            np.testing.assert_array_equal(out[k].numpy(), grads[k])
        for k in SHAPES:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(out_j[k]),
                                       **TOL)
        assert not np.array_equal(out["conv"].numpy(), grads["conv"])


@pytest.mark.parametrize("name,kw", [CASES[2], CASES[3], CASES[9]],
                         ids=["sgd", "sgd-nesterov", "novograd"])
def test_device_count_matches_host_count(name, kw):
    """The amp update keeps the count as a 0-d tensor on the device:
    the first-step rule is then a select, with the host count's result
    bit for bit."""
    params = _params()
    tx = _factories(name, kw, popt)
    runs = []
    for on_device in (False, True):
        p = {k: torch.from_numpy(v) for k, v in params.items()}
        state = tx.init(p)
        if on_device:
            state = _as_device_count(state, torch.device("cpu"))
            assert isinstance(state.count, torch.Tensor)
        for i in range(STEPS):
            g = {k: torch.from_numpy(v) for k, v in _grads(i).items()}
            updates, state = tx.update(g, state, p)
            p = {k: v + updates[k] for k, v in p.items()}
        runs.append(p)
    for k in SHAPES:
        np.testing.assert_array_equal(runs[0][k].numpy(), runs[1][k].numpy())


def test_example_sgd_equals_optax_sgd():
    """The ImageNet example's optimizer: the JAX package's
    ``fused_sgd(lr, momentum=0.9)`` is ``optax.sgd(lr, momentum=0.9)``
    (the reference example's) over 3 steps, and the port's equals both."""
    params = _params(seed=7)
    ref = _run_jax(optax.sgd(0.02, momentum=0.9), params, jnp.float32)
    jax_fused = _run_jax(jopt.fused_sgd(0.02, momentum=0.9), params,
                         jnp.float32)
    got = _run_port(popt.fused_sgd(0.02, momentum=0.9), params,
                    torch.float32)
    for (pr, _), (pj, _), (pp, _) in zip(ref, jax_fused, got):
        _close(_np(pj), _np(pr), TOL)
        _close(_np(pp), _np(pr), TOL)


@pytest.mark.parametrize("norm_type", [2.0, float("inf"), 1.5])
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_grad_norm(norm_type, max_norm):
    grads = _grads(0)
    cj, tj = jopt.clip_grad_norm({k: jnp.asarray(v) for k, v in grads.items()},
                                 max_norm, norm_type)
    ct, tt = popt.clip_grad_norm({k: torch.from_numpy(v)
                                  for k, v in grads.items()},
                                 max_norm, norm_type)
    np.testing.assert_allclose(float(tt), float(tj), **TOL)
    for k in SHAPES:
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), **TOL)
    # in place: the .grad of parameters (apex's clip_grad_norm_), and a
    # dict of gradients
    ps = [torch.nn.Parameter(torch.zeros(SHAPES[k])) for k in SHAPES]
    for p, k in zip(ps, SHAPES):
        p.grad = torch.from_numpy(grads[k].copy())
    extra = torch.nn.Parameter(torch.zeros(3))  # no gradient: left alone
    total = popt.clip_grad_norm_(ps + [extra], max_norm, norm_type)
    from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_

    gd = {k: torch.from_numpy(grads[k].copy()) for k in SHAPES}
    total_d = clip_grad_norm_(gd, max_norm, norm_type)
    np.testing.assert_allclose(float(total), float(tj), **TOL)
    np.testing.assert_allclose(float(total_d), float(tj), **TOL)
    assert extra.grad is None
    for p, k in zip(ps, SHAPES):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(cj[k]), **TOL)
        np.testing.assert_allclose(gd[k].numpy(), np.asarray(cj[k]), **TOL)


def test_multi_tensor_apply():
    arrays = [np.asarray(np.random.RandomState(i).randn(*s), np.float32)
              for i, s in enumerate(SHAPES.values())]
    flat_j = jmta.flatten([jnp.asarray(a) for a in arrays])
    flat = pmta.flatten([torch.from_numpy(a) for a in arrays])
    np.testing.assert_array_equal(flat.numpy(), np.asarray(flat_j))
    back = pmta.unflatten(flat * 2, [torch.from_numpy(a) for a in arrays])
    back_j = jmta.unflatten(flat_j * 2, [jnp.asarray(a) for a in arrays])
    for a, b in zip(back, back_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="uniform dtype"):
        pmta.flatten([torch.zeros(2), torch.zeros(2, dtype=torch.int32)])
    with pytest.raises(ValueError, match="elements"):
        pmta.unflatten(torch.zeros(5), [torch.zeros(2, 2)])
    # the applier calls op(*lists, *args)
    xs = [torch.from_numpy(a) for a in arrays]
    xj = [jnp.asarray(a) for a in arrays]
    out = pmta.multi_tensor_applier(
        lambda x, y, a, b: pmta.axpby(a, x, b, y), None, [xs, xs], 2.0, 3.0)
    out_j = jmta.multi_tensor_applier(
        lambda x, y, a, b: jmta.axpby(a, x, b, y), None, [xj, xj], 2.0, 3.0)
    for a, b in zip(out, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert pmta.MultiTensorApply(1024).chunk_size == 1024


@pytest.mark.parametrize("cls,kw", [
    ("FusedSGD", dict(lr=0.1, momentum=0.9, nesterov=True)),
    ("FusedAdagrad", dict(lr=0.1, weight_decay=1e-2)),
    ("FusedNovoGrad", dict(lr=0.01, betas=(0.9, 0.99), weight_decay=1e-3)),
    ("FusedMixedPrecisionLamb", dict(lr=1e-2)),
])
def test_stateful_wrappers(cls, kw):
    params = _params(seed=5)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: torch.from_numpy(v) for k, v in params.items()}
    kw_j = dict(kw)
    if cls == "FusedMixedPrecisionLamb":
        kw_j = {"learning_rate": kw["lr"]}
        kw = kw_j
    oj = getattr(jopt, cls)(pj, **kw_j)
    ot = getattr(popt, cls)(pt, **kw)
    for i in range(STEPS):
        g = _grads(i)
        pj = oj.step({k: jnp.asarray(v) for k, v in g.items()}, pj)
        pt = ot.step({k: torch.from_numpy(v) for k, v in g.items()}, pt)
        for k in SHAPES:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       **TOL)


def test_registry_names_resolve():
    for name in jopt.FACTORIES:
        assert popt.by_name(name) is popt.FACTORIES[name]
        assert popt.by_name(name).__name__ == jopt.by_name(name).__name__

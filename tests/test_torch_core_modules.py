"""apex_tpu_torch's mlp, fused_dense, RNN and reparameterization against
the JAX package.

Each module gets the JAX module's own initialized parameters (carried
across by its ``from_jax_params``, the ``(in, out)`` kernels transposed)
and the same seeded numpy inputs; its outputs and ``torch.autograd``'s
input gradients are held to the JAX module's outputs and ``jax.vjp``'s
within ``TOL`` in f32: ``MLP`` (relu and sigmoid, bias on and off, the
activation between layers only), ``FusedDense``, ``FusedDenseGeluDense``
(the tanh GELU), the five RNNs (one and two layers, with and without an
``initial_state``; the final states too), ``WeightNorm`` around a fused
dense layer, and the state-dict transforms ``apply_weight_norm`` /
``remove_weight_norm`` / ``to_wrapper_params`` against the reference's
tree transforms (``remove(apply(p))`` gives ``p`` back within one ulp,
on a state dict and on a module).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import RNN as jrnn
from apex_tpu import fused_dense as jfd
from apex_tpu import mlp as jmlp
from apex_tpu import reparameterization as jrep
from apex_tpu_torch import RNN as prnn
from apex_tpu_torch import fused_dense as pfd
from apex_tpu_torch import mlp as pmlp
from apex_tpu_torch import reparameterization as prep

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=0):
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_run(module, params, x, g):
    y, vjp = jax.vjp(lambda a: module.apply(params, a), jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(dx)


def _port_run(module, x, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = module(xt)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), xt.grad.numpy()


def _check(port, ref):
    for a, r in zip(port, ref):
        np.testing.assert_allclose(a, r, **TOL)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("activation", ["relu", "sigmoid"])
def test_mlp_matches_jax(activation, bias):
    sizes = [12, 16, 8, 3]
    jm = jmlp.MLP(sizes, bias=bias, activation=activation)
    x, g = _x((5, 12)), _x((5, 3), seed=1)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if bias:  # the JAX biases start at 0: give them values
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: v + 0.1 if "bias" in str(p) else v, params)
    pm = pmlp.from_jax_params(
        pmlp.MLP(sizes, bias=bias, activation=activation, device="cpu"),
        _np_tree(params))
    _check(_port_run(pm, x, g), _jax_run(jm, params, x, g))


def test_mlp_activation_between_layers_only():
    w = [torch.eye(2), -torch.eye(2)]
    x = torch.tensor([[1.0, -1.0]])
    # relu after the first layer only: the last layer's negatives stay
    out = pmlp.mlp_function(x, w, [], "relu")
    np.testing.assert_array_equal(out.numpy(), [[-1.0, 0.0]])


@pytest.mark.parametrize("gelu", [False, True], ids=["dense", "gelu_dense"])
def test_fused_dense_matches_jax(gelu):
    x, g = _x((2, 3, 16)), _x((2, 3, 8), seed=1)
    if gelu:
        jm = jfd.FusedDenseGeluDense(16, 32, 8)
        pm = pfd.FusedDenseGeluDense(16, 32, 8, device="cpu")
    else:
        jm = jfd.FusedDense(16, 8)
        pm = pfd.FusedDense(16, 8, device="cpu")
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v - 0.2 if "bias" in str(p) else v, params)
    pfd.from_jax_params(pm, _np_tree(params))
    _check(_port_run(pm, x, g), _jax_run(jm, params, x, g))


def test_fused_dense_gelu_is_the_tanh_form():
    h = torch.linspace(-4, 4, 33)
    eye = torch.eye(33)
    out = pfd.fused_dense_gelu_dense_function(h[None], eye, None, eye, None)
    np.testing.assert_allclose(
        out[0].numpy(), np.asarray(jax.nn.gelu(jnp.asarray(h.numpy()),
                                               approximate=True)), **TOL)


RNNS = ("RNNTanh", "RNNReLU", "LSTM", "GRU", "mLSTM")


def _rnn_state(name, layers, batch, hidden, seed):
    h = _x((layers, batch, hidden), seed) * 0.5
    if name in ("LSTM", "mLSTM"):
        return (h, _x((layers, batch, hidden), seed + 1) * 0.5)
    return h


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("name", RNNS)
def test_rnn_matches_jax(name, layers, with_state):
    t, b, din, hid = 6, 3, 5, 7
    x, g = _x((t, b, din)), _x((t, b, hid), seed=1)
    jm = getattr(jrnn, name)(din, hid, num_layers=layers)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.05 if "b_ih" in str(p) else v, params)
    state = _rnn_state(name, layers, b, hid, 3) if with_state else None
    jstate = jax.tree_util.tree_map(jnp.asarray, state)

    def f(a):
        return jm.apply(params, a, jstate)

    (y_j, fin_j), vjp = jax.vjp(f, jnp.asarray(x))
    zero_fin = jax.tree_util.tree_map(jnp.zeros_like, fin_j)
    (dx_j,) = vjp((jnp.asarray(g), zero_fin))

    pm = prnn.from_jax_params(getattr(prnn, name)(
        din, hid, num_layers=layers, device="cpu"), _np_tree(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    pstate = (None if state is None else
              tuple(map(torch.from_numpy, state)) if isinstance(state, tuple)
              else torch.from_numpy(state))
    y, fin = pm(xt, pstate)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)
    fins = fin if isinstance(fin, tuple) else (fin,)
    fins_j = fin_j if isinstance(fin_j, tuple) else (fin_j,)
    assert len(fins) == len(fins_j)
    for a, r in zip(fins, fins_j):
        assert a.shape == (layers, b, hid)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("dim", [0, None], ids=["per_unit", "whole"])
def test_weight_norm_wrapper_matches_jax(dim):
    x, g = _x((4, 6)), _x((4, 5), seed=1)
    jm = jrep.WeightNorm(jfd.FusedDense(6, 5),
                         dim=-1 if dim == 0 else None)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    key = "layer/kernel/scale"
    scale = _x(np.shape(params["params"]["WeightNorm_0"][key]), 4)
    params["params"]["WeightNorm_0"][key] = jnp.asarray(1.0 + 0.3 * scale)
    pm = prep.WeightNorm(pfd.FusedDense(6, 5, device="cpu"), dim=dim)
    p = _np_tree(params)["params"]
    pfd.from_jax_params(pm.layer, p["layer"])
    with torch.no_grad():
        pm.WeightNorm_0["layer/weight/scale"].copy_(
            torch.tensor(np.asarray(p["WeightNorm_0"][key])))
    _check(_port_run(pm, x, g), _jax_run(jm, params, x, g))
    assert set(pm.state_dict()) == {"layer.weight", "layer.bias",
                                    "WeightNorm_0.layer/weight/scale"}


def _plain_state(seed=5):
    rs = np.random.RandomState(seed)
    return {"fc1.weight": rs.randn(6, 4).astype(np.float32),
            "fc1.bias": rs.randn(6).astype(np.float32),
            "fc2.weight": rs.randn(3, 6).astype(np.float32)}


def _jax_tree(state):
    """The same weights as a JAX tree of (in, out) kernels."""
    tree = {}
    for key, v in state.items():
        mod, leaf = key.split(".")
        tree.setdefault(mod, {})["kernel" if leaf == "weight" else leaf] = (
            v.T if leaf == "weight" else v)
    return tree


def test_apply_weight_norm_matches_jax_tree_transform():
    state = _plain_state()
    got = prep.apply_weight_norm(
        {k: torch.from_numpy(v) for k, v in state.items()})
    ref = jrep.apply_weight_norm(_jax_tree(state))
    assert sorted(got) == ["fc1.bias", "fc1.weight_g", "fc1.weight_v",
                           "fc2.weight_g", "fc2.weight_v"]
    for mod in ("fc1", "fc2"):
        np.testing.assert_allclose(got[f"{mod}.weight_g"].numpy().T,
                                   np.asarray(ref[mod]["kernel_g"]), **TOL)
        np.testing.assert_array_equal(got[f"{mod}.weight_v"].numpy().T,
                                      np.asarray(ref[mod]["kernel_v"]))
    back = prep.remove_weight_norm(got)
    ref_back = jrep.remove_weight_norm(ref)
    for key, v in state.items():
        mod, leaf = key.split(".")
        # remove(apply(p)) is p within one ulp, as the reference's is
        np.testing.assert_array_max_ulp(back[key].numpy(), v, maxulp=1)
        r = np.asarray(ref_back[mod]["kernel" if leaf == "weight" else leaf])
        np.testing.assert_array_max_ulp(
            back[key].numpy(), r.T if leaf == "weight" else r, maxulp=1)


def test_weight_norm_module_round_trip_and_forward():
    torch.manual_seed(0)
    model = torch.nn.Sequential(pfd.FusedDense(4, 6, device="cpu"),
                                torch.nn.Tanh(),
                                pfd.FusedDense(6, 3, device="cpu"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.randn(5, 4)
    y0 = model(x)
    prep.apply_weight_norm(model)
    names = sorted(n for n, _ in model.named_parameters())
    assert names == ["0.bias", "0.weight_g", "0.weight_v", "2.bias",
                     "2.weight_g", "2.weight_v"]
    np.testing.assert_allclose(model(x).detach().numpy(),
                               y0.detach().numpy(), **TOL)
    # the hook recomputes the weight from g and v before every forward
    with torch.no_grad():
        model[0].weight_g.mul_(2.0)
    assert not torch.allclose(model(x), y0)
    with torch.no_grad():
        model[0].weight_g.div_(2.0)
    prep.remove_weight_norm(model)
    after = model.state_dict()
    assert sorted(after) == sorted(before)
    for k, v in before.items():
        np.testing.assert_array_max_ulp(after[k].numpy(), v.numpy(),
                                        maxulp=1)


def test_to_wrapper_params_matches_jax_and_starts_at_w():
    rs = np.random.RandomState(6)
    w, b = rs.randn(5, 6).astype(np.float32), rs.randn(5).astype(np.float32)
    got = prep.to_wrapper_params({"weight": torch.from_numpy(w),
                                  "bias": torch.from_numpy(b)})
    ref = jrep.to_wrapper_params({"params": {"kernel": w.T, "bias": b}})
    np.testing.assert_allclose(
        got["WeightNorm_0.layer/weight/scale"].numpy(),
        np.asarray(ref["params"]["WeightNorm_0"]["layer/kernel/scale"]),
        **TOL)
    pm = prep.WeightNorm(pfd.FusedDense(6, 5, device="cpu"))
    pm.load_state_dict(got)
    x = torch.from_numpy(_x((3, 6)))
    np.testing.assert_allclose(pm(x).detach().numpy(),
                               (x @ torch.from_numpy(w).T
                                + torch.from_numpy(b)).numpy(), **TOL)
    np.testing.assert_allclose(
        prep.compute_weight(got["WeightNorm_0.layer/weight/scale"],
                            torch.from_numpy(w)).numpy(), w, **TOL)

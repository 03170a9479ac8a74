"""apex_tpu_torch.contrib.openfold vs apex_tpu.contrib.openfold.

Every ported module, from the JAX module's parameters (seeded numpy
values, 0.1 · N(0, 1), so that no zero-initialised projection hides a
path) carried across by ``evoformer_from_jax_params``, on the same
seeded inputs, small (n <= 16, widths <= 16, 2 heads), f32: the forward
and the gradient of every parameter and input (``jax.value_and_grad``
against torch autograd of ``sum(out * cotangent)``).  JAX runs its
attention on its jnp path here (short sequences), the port on the plain
twins of K3/K4/K5; once more with JAX forced onto its Pallas kernels in
interpret mode, so that the Pallas ``flash_dbias`` computes the
triangle bias's gradient.  Tolerance ``TOL``: f32 sums in other orders
through a few LayerNorms and products.

Also: one EvoformerBlock step with FusedAdam against the JAX
``FusedAdam``, the converter round trip, the zero output at init, and
the DAP axis of size 1 (no process group) running the unsharded math.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.contrib.openfold as jof
from apex_tpu.ops import _dispatch as jax_dispatch
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.contrib import openfold as pof
from apex_tpu_torch.models import (
    evoformer_from_jax_params,
    evoformer_to_jax_params,
)
from apex_tpu_torch.ops import flash_attention, fused_layer_norm_affine
from apex_tpu_torch.optimizers import FusedAdam

TOL = dict(atol=1e-4, rtol=1e-4)
PORT = dict(dtype=torch.float32, device="cpu")
N, S, D, DZ, H = 12, 6, 16, 8, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for shape in shapes]


# (JAX module, port module, input shapes, extra call args): each module
# at the widths above; GatedAttention takes a trainable (B, H, S, S) bias
MODULES = {
    "GatedAttention": (
        lambda: jof.GatedAttention(heads=H),
        lambda: pof.GatedAttention(D, H, **PORT),
        [(3, N, D), (3, H, N, N)], ()),
    "TriangleAttention": (
        lambda: jof.TriangleAttention(heads=H),
        lambda: pof.TriangleAttention(DZ, H, **PORT),
        [(N, N, DZ)], ()),
    "TriangleMultiplicativeUpdate-outgoing": (
        lambda: jof.TriangleMultiplicativeUpdate(mode="outgoing", hidden=12),
        lambda: pof.TriangleMultiplicativeUpdate(DZ, "outgoing", 12,
                                                 device="cpu"),
        [(N, N, DZ)], ()),
    "TriangleMultiplicativeUpdate-incoming": (
        lambda: jof.TriangleMultiplicativeUpdate(mode="incoming"),
        lambda: pof.TriangleMultiplicativeUpdate(DZ, "incoming",
                                                 device="cpu"),
        [(N, N, DZ)], ()),
    "PairTransition": (
        lambda: jof.PairTransition(ratio=2),
        lambda: pof.PairTransition(DZ, 2, device="cpu"),
        [(N, N, DZ)], ()),
    "EvoformerPairBlock": (
        lambda: jof.EvoformerPairBlock(dim=DZ, heads=H),
        lambda: pof.EvoformerPairBlock(DZ, H, **PORT),
        [(N, N, DZ)], ()),
    "MSARowAttentionWithPairBias": (
        lambda: jof.MSARowAttentionWithPairBias(heads=H),
        lambda: pof.MSARowAttentionWithPairBias(D, DZ, H, **PORT),
        [(S, N, D), (N, N, DZ)], ()),
    "MSAColumnAttention": (
        lambda: jof.MSAColumnAttention(heads=H),
        lambda: pof.MSAColumnAttention(D, H, **PORT),
        [(N, S, D)], ()),
    "OuterProductMean": (
        lambda: jof.OuterProductMean(hidden=4),
        lambda: pof.OuterProductMean(D, DZ, 4, device="cpu"),
        [(S, N, D)], (DZ,)),
    "EvoformerBlock": (
        lambda: jof.EvoformerBlock(msa_dim=D, pair_dim=DZ, heads=H,
                                   opm_hidden=4),
        lambda: pof.EvoformerBlock(D, DZ, H, opm_hidden=4, **PORT),
        [(S, N, D), (N, N, DZ)], ()),
    "DAPAxialBlock": (
        lambda: jof.DAPAxialBlock(dim=D, heads=H),
        lambda: pof.DAPAxialBlock(D, H, **PORT),
        [(N, 10, D)], ()),
}


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _modules(name, seed=0):
    """(JAX module, its randomized numpy params, the port module holding
    them, the inputs, the extra call args)."""
    make_j, make_p, shapes, extra = MODULES[name]
    inputs = _arrays(seed, *shapes)
    jmod = make_j()
    params = jax.eval_shape(
        lambda *xs: jmod.init(jax.random.PRNGKey(0), *xs, *extra),
        *map(jnp.asarray, inputs))
    leaves, treedef = jax.tree.flatten(params)
    rs = np.random.RandomState(seed + 1)
    params = jax.tree.unflatten(treedef, [
        (0.1 * rs.randn(*leaf.shape)).astype(np.float32) for leaf in leaves])
    port = evoformer_from_jax_params(params, make_p())
    return jmod, params, port, inputs, extra


def _jax_value_and_grads(jmod, params, inputs, extra, cots):
    def loss(p, *xs):
        outs = _outputs(jmod.apply(p, *xs, *extra))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(inputs) + 1)), has_aux=True))(
        jax.tree.map(jnp.asarray, params), *map(jnp.asarray, inputs))
    return outs, grads[0], grads[1:]


def _port_value_and_grads(port, inputs, cots):
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    outs = _outputs(port(*xs))
    loss = sum((o * torch.from_numpy(np.asarray(c))).sum()
               for o, c in zip(outs, cots))
    loss.backward()
    grads = evoformer_to_jax_params(
        port, {k: p.grad for k, p in port.named_parameters()})
    return outs, grads, [x.grad for x in xs]


def _assert_trees_close(port_tree, jax_tree, **tol):
    port = dict(jax.tree_util.tree_leaves_with_path(port_tree))
    ref = jax.tree_util.tree_leaves_with_path(jax_tree)
    assert len(port) == len(ref)
    for path, leaf in ref:
        np.testing.assert_allclose(
            port[path], np.asarray(leaf), err_msg=jax.tree_util.keystr(path),
            **tol)


def _check_module(name, seed=0, tol=TOL):
    jmod, params, port, inputs, extra = _modules(name, seed)
    shapes = [o.shape for o in _outputs(jax.eval_shape(
        lambda p, *xs: jmod.apply(p, *xs, *extra), params,
        *map(jnp.asarray, inputs)))]
    cots = _arrays(seed + 2, *shapes)
    outs_j, grads_j, dx_j = _jax_value_and_grads(jmod, params, inputs, extra,
                                                 cots)
    outs, grads, dx = _port_value_and_grads(port, inputs, cots)
    for o, o_j in zip(outs, outs_j):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), **tol)
    _assert_trees_close(grads["params"], grads_j["params"], **tol)
    for g, g_j in zip(dx, dx_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), **tol)
    return grads, grads_j


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name):
    """Forward, every parameter gradient and every input gradient,
    TOL."""
    grads, _ = _check_module(name)
    assert all(np.abs(g).max() > 0 for g in jax.tree.leaves(grads))


def test_triangle_attention_matches_jax_pallas_dbias():
    """TriangleAttention with JAX forced onto its Pallas kernels in
    interpret mode, so that ``flash_dbias`` computes the triangle bias's
    gradient: the port (K5's twin) matches it, 2e-4 (the Pallas kernels
    sum over key blocks)."""
    jax_dispatch.set_use_pallas(True)
    try:
        grads, grads_j = _check_module("TriangleAttention", seed=5,
                                       tol=dict(atol=2e-4, rtol=2e-4))
        assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    finally:
        jax_dispatch.set_use_pallas(None)
    assert np.abs(grads["params"]["tri_bias"]["kernel"]).max() > 0


def test_evoformer_block_adam_step_matches_jax():
    """One EvoformerBlock step: the loss (mean squared outputs), then
    FusedAdam (lr 1e-3) on the gradients; the weights after the step
    match the JAX FusedAdam's, 1e-6 (Adam's first step moves each weight
    by about ±lr whatever the gradient's size)."""
    jmod, params, port, inputs, extra = _modules("EvoformerBlock", seed=7)

    def loss_j(p):
        m, z = jmod.apply(p, *map(jnp.asarray, inputs))
        return jnp.mean(m ** 2) + jnp.mean(z ** 2)

    p_j = jax.tree.map(jnp.asarray, params)
    l_j, g_j = jax.jit(jax.value_and_grad(loss_j))(p_j)
    p_j = JaxFusedAdam(p_j, lr=1e-3).step(g_j, p_j)
    m, z = port(*map(torch.from_numpy, inputs))
    loss = m.pow(2).mean() + z.pow(2).mean()
    loss.backward()
    FusedAdam(port.parameters(), lr=1e-3).step()
    np.testing.assert_allclose(float(loss), float(l_j), rtol=1e-5)
    _assert_trees_close(evoformer_to_jax_params(port)["params"],
                        p_j["params"], atol=1e-6, rtol=1e-6)


def test_converter_round_trip_is_exact():
    _, params, port, _, _ = _modules("EvoformerBlock", seed=9)
    back = evoformer_to_jax_params(port)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        evoformer_from_jax_params(
            {"params": {**params["params"], "extra": np.zeros(1)}},
            pof.EvoformerBlock(D, DZ, H, opm_hidden=4, **PORT))


@pytest.mark.parametrize("name", sorted(MODULES))
def test_init_matches_jax_rules(name):
    """The port's own init follows the JAX module's: every module that
    returns an update returns exactly zero at init (zero out/down
    kernels, zero-kernel gates); the blocks return their inputs; and
    each parameter's shape, zero/one pattern and scale match the JAX
    ``init`` tree's."""
    make_j, make_p, shapes, extra = MODULES[name]
    inputs = _arrays(3, *shapes)
    port = make_p()
    outs = _outputs(port(*map(torch.from_numpy, inputs)))
    if name in ("EvoformerBlock", "EvoformerPairBlock"):
        for o, x in zip(outs, inputs):
            assert torch.equal(o, torch.from_numpy(x))
    elif name != "DAPAxialBlock":
        assert all(bool((o == 0).all()) for o in outs)
    ref = jax.jit(lambda *xs: make_j().init(jax.random.PRNGKey(0), *xs,
                                            *extra))(*map(jnp.asarray, inputs))
    mine = evoformer_to_jax_params(port)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        got = dict(jax.tree_util.tree_leaves_with_path(mine))[path]
        leaf = np.asarray(leaf)
        assert got.shape == leaf.shape, jax.tree_util.keystr(path)
        if np.all(leaf == leaf.flat[0]):
            np.testing.assert_array_equal(got, leaf)
        else:
            assert 0.5 < got.std() / leaf.std() < 2.0, jax.tree_util.keystr(path)


def test_dap_is_not_ported():
    """DAP is ported (tests/test_torch_dap.py holds it to the JAX
    shard_map run); without a process group every DAP axis has size 1,
    so the collectives are the identity and a module with an axis_name
    runs the unsharded math."""
    x = torch.randn(4, 4, 2)
    assert pof.row_to_col(x, "dp") is x
    assert pof.gather(x, "dp", 0) is x
    assert torch.equal(pof.scatter(x, "dp", 0), x)
    m, z = (torch.from_numpy(a) for a in _arrays(5, (S, N, D), (N, N, DZ)))
    plain = pof.EvoformerBlock(D, DZ, H, **PORT)
    dap = pof.EvoformerBlock(D, DZ, H, axis_name="dp", **PORT)
    dap.load_state_dict(plain.state_dict())
    for a, b in zip(dap(m, z), plain(m, z)):
        assert torch.equal(a, b)
    assert pof.mha is flash_attention
    assert pof.layer_norm is fused_layer_norm_affine

"""apex_tpu_torch's dynamic axial parallelism (the OpenFold DAP) vs the
JAX package.

The port runs in spawned gloo processes (one spawn per world, 2 and 4;
``torch_dist_workers.dap_case``), the JAX package under ``shard_map``
over a dp mesh of the same size, on the same seeded inputs
(s, r, cm, cz, h = 8, 8, 8, 8, 2; parameters 0.1 · N(0, 1) from numpy,
carried across by ``evoformer_from_jax_params``):

- the six collectives (``scatter``, ``gather``, ``row_to_col``,
  ``col_to_row``, ``scatter_rows_gather_cols``,
  ``scatter_cols_gather_rows``) and ``psum_scatter``: the output and the
  input gradient for the cotangent ``y * 3 + rank`` against ``jax.vjp``
  under ``shard_map``;
- ``TriangleMultiplicativeUpdate`` (both modes), ``EvoformerPairBlock``,
  ``EvoformerBlock`` and ``DAPAxialBlock``: the sharded forward and the
  parameter gradients of ``sum(out ** 2)`` summed over the group (the
  JAX tests' ``psum``) against JAX's sharded run and against the
  unsharded run;
- the collectives each module issues (the call log) and a planted
  fault: a ``gather`` whose backward only slices must fail the gradient
  check.

Tolerance: ``TOL`` (rtol 2e-5, atol 2e-5 of the largest |value| of the
output, or of the module's gradients): f32 on the CPU, sums in other
orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import apex_tpu.contrib.openfold as jof
import torch_dist_workers as workers
from apex_tpu import parallel_state as jps

S, R, CM, CZ, H = 8, 8, 8, 8, 2
DIMS = (S, R, CM, CZ, H)
TOL = 2e-5
WORLDS = (2, 4)

#: name -> (port kind, JAX module factory (axis_name), input shapes)
MODULES = {
    "tmu_outgoing": ("tmu_outgoing", lambda ax: jof.TriangleMultiplicativeUpdate(
        mode="outgoing", hidden=CZ, axis_name=ax), [(R, R, CZ)]),
    "tmu_incoming": ("tmu_incoming", lambda ax: jof.TriangleMultiplicativeUpdate(
        mode="incoming", hidden=CZ, axis_name=ax), [(R, R, CZ)]),
    "pair_block": ("pair_block", lambda ax: jof.EvoformerPairBlock(
        dim=CZ, heads=H, axis_name=ax), [(R, R, CZ)]),
    "evo_block": ("evo_block", lambda ax: jof.EvoformerBlock(
        msa_dim=CM, pair_dim=CZ, heads=H, axis_name=ax),
        [(S, R, CM), (R, R, CZ)]),
    "dap_axial": ("dap_axial", lambda ax: jof.DAPAxialBlock(
        dim=CZ, heads=H, axis_name=ax), [(R, R, CZ)]),
}

#: name -> (function, input shape, kwargs): the collectives
COLLECTIVES = {
    "scatter": ("scatter", (R, R, 4), dict(dim=0)),
    "gather": ("gather", (2, R, 4), dict(dim=0)),
    "gather_dim1": ("gather", (R, 2, 4), dict(dim=1)),
    "row_to_col": ("row_to_col", (2, R, 4), {}),
    "col_to_row": ("col_to_row", (R, 2, 4), {}),
    "scatter_rows_gather_cols": ("scatter_rows_gather_cols", (2, R, 4), {}),
    "scatter_cols_gather_rows": ("scatter_cols_gather_rows", (R, 2, 4), {}),
    "psum_scatter": ("psum_scatter", (R, R, 4), dict(dim=0)),
}


def _inputs(name):
    rs = np.random.RandomState(sorted(MODULES).index(name))
    return [rs.randn(*s).astype(np.float32) for s in MODULES[name][2]]


def _params(name):
    """The JAX module's parameters, every leaf 0.1 · N(0, 1) (numpy)."""
    mod = MODULES[name][1](None)
    tree = mod.init(jax.random.PRNGKey(0), *map(jnp.asarray, _inputs(name)))
    rs = np.random.RandomState(100 + sorted(MODULES).index(name))
    return jax.tree.map(
        lambda a: (0.1 * rs.randn(*a.shape)).astype(np.float32), tree)


def _coll_input(name, world):
    rs = np.random.RandomState(50 + sorted(COLLECTIVES).index(name))
    return rs.randn(*COLLECTIVES[name][1]).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dap_runs")
    out = {}
    for world in WORLDS:
        modules = [(n, MODULES[n][0], _params(n), _inputs(n))
                   for n in MODULES]
        colls = [(n, COLLECTIVES[n][0], _coll_input(n, world),
                  COLLECTIVES[n][2]) for n in COLLECTIVES]
        out[world] = workers.spawn(world, [("dap", "dap_case", dict(
            modules=modules, collectives=colls, dims=DIMS,
            fault_module="pair_block"))], tmp)
    return out


def _mesh(world):
    jps.destroy_model_parallel()
    return jps.initialize_model_parallel(devices=jax.devices()[:world])


def _close(got, want, what="", scale=None):
    got, want = np.asarray(got), np.asarray(want)
    if scale is None:
        scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _jax_sharded(name, world):
    """JAX's sharded outputs and group-summed parameter gradients."""
    params, inputs = _params(name), [jnp.asarray(x) for x in _inputs(name)]
    mod = MODULES[name][1]("dp")
    mesh = _mesh(world)

    def loss(p, *xs):
        outs = mod.apply(p, *xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o ** 2) for o in outs), outs

    def f(p, *xs):
        (_, outs), g = jax.value_and_grad(loss, has_aux=True)(p, *xs)
        return outs, jax.tree.map(lambda t: jax.lax.psum(t, "dp"), g)

    n_out = 2 if name == "evo_block" else 1
    try:
        outs, grads = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P(),) + (P("dp"),) * len(inputs),
            out_specs=((P("dp"),) * n_out, P()), check_vma=False,
        ))(params, *inputs)
    finally:
        jps.destroy_model_parallel()
    return outs, grads


def _jax_unsharded(name):
    params, inputs = _params(name), [jnp.asarray(x) for x in _inputs(name)]
    mod = MODULES[name][1](None)

    def loss(p):
        outs = mod.apply(p, *inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o ** 2) for o in outs), outs

    (_, outs), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return outs, grads


def _rows(full, rank, world):
    n = full.shape[0] // world
    return np.asarray(full)[rank * n:(rank + 1) * n]


def _check_grads(got, want, what):
    """Every leaf within TOL of the module's largest gradient (a leaf
    whose exact gradient is 0 — the pair bias LayerNorm's bias, which
    the softmax cancels — reads rounding noise on both sides)."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    scale = max(float(np.abs(np.asarray(leaf)).max()) for _, leaf in flat)
    for path, leaf in flat:
        g = got
        for k in path:
            g = g[k.key]
        _close(g, leaf, f"{what} {jax.tree_util.keystr(path)}", scale)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax_shard_map(world, name, runs):
    """Forward rows and group-summed gradients equal JAX's sharded run."""
    outs, grads = _jax_sharded(name, world)
    for rank in range(world):
        got_outs, got_grads, _ = runs[world][rank]["dap"][name]
        for i, (a, b) in enumerate(zip(got_outs, outs)):
            _close(a, _rows(b, rank, world), f"{name} out {i} rank {rank}")
        _check_grads(got_grads, grads, f"{name} rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_unsharded(world, name, runs):
    """... and the unsharded run (the DAP equivalence contract)."""
    outs, grads = _jax_unsharded(name)
    for rank in range(world):
        got_outs, got_grads, _ = runs[world][rank]["dap"][name]
        for i, (a, b) in enumerate(zip(got_outs, outs)):
            _close(a, _rows(b, rank, world), f"{name} out {i} rank {rank}")
        _check_grads(got_grads, grads, f"{name} rank {rank}")


#: the collectives each module's forward and backward issue over dp
#: (kind -> count): the pair bias gathers forward and reduce-scatters
#: backward, the triangle updates gather or reduce-scatter one operand,
#: every layout change is an all-to-all each way
WANT_CALLS = {
    "tmu_outgoing": {"all-gather": 1, "reduce-scatter": 1},
    "tmu_incoming": {"reduce-scatter": 1, "all-gather": 1},
    "pair_block": {"all-gather": 4, "reduce-scatter": 4, "all-to-all": 4},
    "evo_block": {"all-gather": 6, "reduce-scatter": 6, "all-to-all": 8},
    "dap_axial": {"all-to-all": 4},
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_call_log(name, runs):
    """Every collective a module issues goes through the comm wrappers
    over the dp axis, as many as its DAP form has."""
    log = runs[2][0]["dap"][name][2]
    assert {r["axis"] for r in log} == {"dp"}
    counts = {}
    for r in log:
        counts[r["kind"]] = counts.get(r["kind"], 0) + 1
    assert counts == WANT_CALLS[name]


def _jax_collective(name, world):
    fn, _, kw = COLLECTIVES[name]
    x = _coll_input(name, world)
    mesh = _mesh(world)

    def f(xs):
        rank = jax.lax.axis_index("dp")
        inp = xs * (rank + 1).astype(jnp.float32)
        jf = getattr(jof, fn) if fn != "psum_scatter" else (
            lambda t, ax, dim: jax.lax.psum_scatter(
                t, ax, scatter_dimension=dim, tiled=True))
        y, vjp = jax.vjp(lambda t: jf(t, "dp", **kw), inp)
        (g,) = vjp(y * 3 + rank.astype(jnp.float32))
        # the gradient w.r.t. the rank's input (x * (rank + 1))
        return y[None], g[None]

    try:
        y, g = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P(),), out_specs=(P("dp"), P("dp")),
            check_vma=False))(jnp.asarray(x))
    finally:
        jps.destroy_model_parallel()
    return np.asarray(y), np.asarray(g)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_matches_jax(world, name, runs):
    y, g = _jax_collective(name, world)
    for rank in range(world):
        got_y, got_g = runs[world][rank]["dap"][name]
        _close(got_y, y[rank], f"{name} out rank {rank}")
        _close(got_g, g[rank], f"{name} grad rank {rank}")


def test_planted_gather_fault_fails_the_gradient_check(runs):
    """A gather whose backward only slices (dropping the other ranks'
    share of the shared pair bias's gradient) keeps the forward exact;
    the gradient comparison catches it."""
    outs, grads = _jax_sharded("pair_block", 2)
    for rank in range(2):
        got_outs, got_grads, _ = runs[2][rank]["dap"]["pair_block_fault"]
        for i, (a, b) in enumerate(zip(got_outs, outs)):
            _close(a, _rows(b, rank, 2), f"fault out {i} rank {rank}")
        with pytest.raises(AssertionError, match="fault"):
            _check_grads(got_grads, grads, "fault")

"""apex_tpu_torch's halo exchange, spatial bottleneck and group batch norm
at world 2 against the JAX package's ``shard_map`` at the same world.

One spawn (two gloo processes, ``torch_dist_workers.contrib_halo_case``)
runs every world-2 case; the reference runs the same functions under
``shard_map`` over two of the eight CPU devices on the same seeded
numpy inputs, each rank's slice the same.  Within ``TOL`` in f32 (the
halo rows exactly):

- ``halo_exchange_1d`` at halo 1 and 3, values and input gradients (a
  halo's cotangent goes back to the rank that sent it; rank 0's upper
  and the last rank's lower halo are zeros), ``PeerHaloExchanger1d``
  and ``nccl_p2p.left_right_halo_exchange``;
- ``SpatialBottleneck`` (the JAX block's variables carried across) on
  each rank's H strip, in evaluation and in training (each strip's own
  statistics), outputs and input gradients; in evaluation also the
  unsplit ``Bottleneck``'s rows;
- ``BatchNorm2d_NHWC(bn_group=2, fuse_relu=True)`` on each rank's rows:
  the output, the input gradient, each rank's parameter gradients and
  the running statistics, which are one process's over the whole batch.

And in one process: at world 1 the halos are zeros, the N/A stubs
(``nccl_allocator``'s no-ops, ``gpu_direct_storage``'s and
``PeerMemoryPool``'s refusals in the port's own words).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_workers as workers
from apex_tpu import parallel_state as jps
from apex_tpu.contrib import bottleneck as jbn
from apex_tpu.contrib import groupbn as jgbn
from apex_tpu.contrib import nccl_p2p as jp2p
from apex_tpu.contrib import peer_memory as jpm

TOL = dict(atol=2e-5, rtol=2e-5)
WORLD = 2
BLOCK = (8, 4, 8)  # in, bottleneck, out channels (stride 1)

port_state_guard = pytest.fixture(autouse=True)(workers.port_state_guard)


def _x(shape, seed=0, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _block_variables(x):
    jm = jbn.Bottleneck(*BLOCK, dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    rs = np.random.RandomState(4)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (jnp.asarray(rs.rand(*a.shape) + 0.5, jnp.float32)
                      if "var" in jax.tree_util.keystr(p)
                      else a + jnp.asarray(rs.randn(*a.shape) * 0.2,
                                           jnp.float32)), v)


def _bn_variables(c):
    rs = np.random.RandomState(6)
    return {"params": {"weight": rs.randn(c).astype(np.float32),
                       "bias": rs.randn(c).astype(np.float32)},
            "batch_stats": {"mean": rs.randn(c).astype(np.float32),
                            "var": (rs.rand(c) + 0.5).astype(np.float32)}}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the reference's results and the two ranks' results."""
    tmp = tmp_path_factory.mktemp("contrib_halo")
    x = _x((2, 8, 3, 4))  # H 8: a strip of 4 rows a rank
    gx = {h: _x((2, 2 * (4 + 2 * h), 3, 4), seed=10 + h) for h in (1, 3)}
    left, right = _x((WORLD, 5), seed=2), _x((WORLD, 5), seed=3)
    xb, gb = _x((2, 8, 6, BLOCK[0]), seed=5), _x((2, 8, 6, BLOCK[2]), seed=7)
    bn_x, bn_g = _x((6, 3, 3, 5), seed=8, scale=2.0) + 0.5, _x((6, 3, 3, 5),
                                                               seed=9)
    block_v = _block_variables(xb)
    bn_v = _bn_variables(5)
    block_path, bn_path = tmp / "block.pkl", tmp / "bn.pkl"
    block_path.write_bytes(pickle.dumps(_np_tree(block_v)))
    bn_path.write_bytes(pickle.dumps(bn_v))
    inputs = dict(x=x, gx=gx, left=left, right=right, xb=xb, gb=gb,
                  bn_x=bn_x, bn_g=bn_g)
    ranks = workers.spawn(WORLD, [("run", "contrib_halo_case", dict(
        inputs, block_args=BLOCK, block_path=str(block_path),
        bn_path=str(bn_path)))], tmp)
    return dict(inputs, block_v=block_v, bn_v=bn_v,
                ranks=[r["run"] for r in ranks], ref=_reference(
                    inputs, block_v, bn_v))


def _reference(inp, block_v, bn_v):
    """The JAX package's results under shard_map at world 2."""
    out = {}
    strip = P(None, "dp")
    mesh = jps.initialize_model_parallel(devices=jax.devices()[:WORLD])
    try:
        def run(fn, in_specs, out_specs, *args):
            return jax.jit(jax.shard_map(
                fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                check_vma=False))(*args)

        for h in (1, 3):
            def halo(x, g, h=h):
                y, vjp = jax.vjp(lambda a: jpm.halo_exchange_1d(a, h), x)
                return y, vjp(g)[0]

            out[f"halo{h}"] = run(halo, (strip, strip), (strip, strip),
                                  inp["x"], inp["gx"][h])
        out["exchanger"] = run(
            lambda x: jpm.PeerHaloExchanger1d(half_halo=2)(x), (strip,),
            strip, inp["x"])
        out["left_right"] = run(
            lambda l, r: tuple(a[None] for a in jp2p.left_right_halo_exchange(
                l[0], r[0])), (P("dp"), P("dp")), (P("dp"), P("dp")),
            inp["left"], inp["right"])
        spatial = jbn.SpatialBottleneck(*BLOCK, dtype=jnp.float32)
        for train in (False, True):
            def block(v, x, g, train=train):
                def f(a):
                    if train:
                        return spatial.apply(v, a, train=True,
                                             mutable=["batch_stats"])[0]
                    return spatial.apply(v, a, train=False)

                y, vjp = jax.vjp(f, x)
                return y, vjp(g)[0]

            out[f"block_train{train}"] = run(
                block, (P(), strip, strip), (strip, strip), block_v,
                inp["xb"], inp["gb"])
        bn = jgbn.BatchNorm2d_NHWC(5, bn_group=WORLD, fuse_relu=True)

        def batchnorm(v, x, g):
            def f(p, a):
                return bn.apply({"params": p,
                                 "batch_stats": v["batch_stats"]}, a,
                                use_running_average=False,
                                mutable=["batch_stats"])

            y, vjp, upd = jax.vjp(f, v["params"], x, has_aux=True)
            dp, dx = vjp(g)
            stats = upd["batch_stats"]
            return y, dx, jax.tree_util.tree_map(lambda a: a[None], (
                dp["weight"], dp["bias"], stats["mean"], stats["var"]))

        out["bn"] = run(batchnorm, (P(), P("dp"), P("dp")),
                        (P("dp"), P("dp"), P("dp")), bn_v, inp["bn_x"],
                        inp["bn_g"])
    finally:
        jps.destroy_model_parallel()
    return jax.tree_util.tree_map(np.asarray, out)


def _rank_strip(a, rank, axis=1):
    n = a.shape[axis] // WORLD
    return np.take(a, range(rank * n, (rank + 1) * n), axis=axis)


@pytest.mark.parametrize("halo", [1, 3])
def test_halo_exchange_matches_the_reference(case, halo):
    y_ref, dx_ref = case["ref"][f"halo{halo}"]
    x = case["x"]
    for rank, got in enumerate(case["ranks"]):
        y, dx = got[f"halo{halo}"]
        np.testing.assert_array_equal(y, _rank_strip(y_ref, rank))
        _close(dx, _rank_strip(dx_ref, rank))
        # the rows themselves: the neighbours' edges, zeros at the ends
        own = _rank_strip(x, rank)
        np.testing.assert_array_equal(y[:, halo:-halo], own)
        above = (np.zeros_like(own[:, :halo]) if rank == 0
                 else _rank_strip(x, rank - 1)[:, -halo:])
        below = (np.zeros_like(own[:, :halo]) if rank == WORLD - 1
                 else _rank_strip(x, rank + 1)[:, :halo])
        np.testing.assert_array_equal(y[:, :halo], above)
        np.testing.assert_array_equal(y[:, -halo:], below)


def test_exchanger_and_left_right_match_the_reference(case):
    li_ref, ri_ref = case["ref"]["left_right"]
    for rank, got in enumerate(case["ranks"]):
        np.testing.assert_array_equal(
            got["exchanger"], _rank_strip(case["ref"]["exchanger"], rank))
        li, ri = got["left_right"]
        np.testing.assert_array_equal(li, li_ref[rank])
        np.testing.assert_array_equal(ri, ri_ref[rank])
        # left input = the left neighbour's right halo, zeros at rank 0
        want_l = (np.zeros(5, np.float32) if rank == 0
                  else case["right"][rank - 1])
        np.testing.assert_array_equal(li, want_l)


@pytest.mark.parametrize("train", [False, True])
def test_spatial_bottleneck_matches_the_reference(case, train):
    y_ref, dx_ref = case["ref"][f"block_train{train}"]
    for rank, got in enumerate(case["ranks"]):
        y, dx = got[f"block_train{train}"]
        _close(y, _rank_strip(y_ref, rank))
        _close(dx, _rank_strip(dx_ref, rank))
    if not train:  # the strips are the unsplit block's rows
        full = jbn.Bottleneck(*BLOCK, dtype=jnp.float32).apply(
            case["block_v"], jnp.asarray(case["xb"]), train=False)
        y = np.concatenate([r["block_trainFalse"][0] for r in case["ranks"]],
                           axis=1)
        _close(y, full, dict(atol=1e-4, rtol=1e-4))


def test_bn_group_matches_the_reference_and_one_process(case):
    y_ref, dx_ref, (dw, db, mean, var) = case["ref"]["bn"]
    for rank, got in enumerate(case["ranks"]):
        y, dx = got["bn"]
        _close(y, y_ref[rank * 3:(rank + 1) * 3])
        _close(dx, dx_ref[rank * 3:(rank + 1) * 3])
        for a, r in zip(got["bn_params"], (dw[rank], db[rank], mean[rank],
                                           var[rank])):
            _close(a, r)
    # the statistics are the whole batch's: one process, all the rows
    from apex_tpu_torch.contrib import groupbn

    one = groupbn.from_jax_variables(
        groupbn.BatchNorm2d_NHWC(5, fuse_relu=True, device="cpu"),
        case["bn_v"])
    y = one(torch.from_numpy(case["bn_x"]), use_running_average=False)
    _close(np.concatenate([r["bn"][0] for r in case["ranks"]]),
           y.detach().numpy())
    _close(case["ranks"][0]["bn_params"][2], one.running_mean)
    _close(case["ranks"][0]["bn_params"][3], one.running_var)


def test_world_one_halos_are_zeros():
    from apex_tpu_torch.contrib import nccl_p2p, peer_memory

    x = torch.arange(24.0).reshape(1, 4, 3, 2)
    y = peer_memory.halo_exchange_1d(x, 1)
    assert y.shape == (1, 6, 3, 2)
    assert not y[:, 0].any() and not y[:, -1].any()
    assert torch.equal(y[:, 1:-1], x)
    li, ri = nccl_p2p.left_right_halo_exchange(torch.ones(3), torch.ones(3))
    assert not li.any() and not ri.any()


def test_not_applicable_stubs():
    from apex_tpu_torch.contrib import gpu_direct_storage, nccl_allocator
    from apex_tpu_torch.contrib.peer_memory import PeerMemoryPool

    nccl_allocator.init()
    with nccl_allocator.nccl_mem():
        pass
    for fn in (gpu_direct_storage.load_data, gpu_direct_storage.save_data):
        with pytest.raises(NotImplementedError, match="goodput") as err:
            fn("unused")
        assert "TPU" not in str(err.value) and "orbax" not in str(err.value)
    pool = PeerMemoryPool(64, 0)
    with pytest.raises(NotImplementedError, match="halo_exchange_1d"):
        pool.allocate_peer_tensors([4], torch.float32, False, True)

"""apex_tpu_torch's SyncBatchNorm vs the JAX package and an unsplit
BatchNorm.

A (N, C, H, W) batch split over 2 and 4 spawned gloo ranks
(``torch_dist_workers.syncbn_case``) gives, within the stated limits:

- the unsplit ``torch.nn.functional.batch_norm``'s output and input
  gradient on each rank's rows, and its parameter gradients as the sum
  of the ranks' partials;
- the JAX ``SyncBatchNorm`` under ``shard_map`` over a dp mesh of the
  same size (channels-last there: the reference's layout), output and
  running statistics;
- the running statistics (PyTorch's momentum convention, unbiased
  variance) and the eval-mode output from them.

f32: ``TOL``; bf16 inputs: ``BF16_TOL`` (one bf16 rounding of the
output, normalized values of order 1).  ``convert_syncbn_model`` is
checked in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

import torch_dist_workers as workers
from apex_tpu import parallel_state as jps
from apex_tpu.parallel import SyncBatchNorm as JaxSyncBN
from apex_tpu_torch.parallel import SyncBatchNorm, convert_syncbn_model

TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
N, C, H, W = 8, 6, 5, 4
CASES = [("f32", False), ("f32", True), ("bf16", False)]


def _inputs():
    rs = np.random.RandomState(0)
    x = (rs.randn(N, C, H, W) * 2 + 0.5).astype(np.float32)
    cot = rs.randn(N, C, H, W).astype(np.float32)
    w = (1 + 0.1 * rs.randn(C)).astype(np.float32)
    b = (0.1 * rs.randn(C)).astype(np.float32)
    return x, cot, w, b


def _layout(a, channel_last):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1)) if channel_last else a


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("syncbn_runs")
    x, cot, w, b = _inputs()
    out = {}
    for world in (2, 4):
        cases = [(f"{dt}_{cl}", "syncbn_case", dict(
            x=_layout(x, cl), cot=_layout(cot, cl), weight=w, bias=b,
            channel_last=cl,
            dtype=torch.bfloat16 if dt == "bf16" else torch.float32))
            for dt, cl in CASES]
        out[world] = workers.spawn(world, cases, tmp)
    return out


def _unsplit(dtype):
    """The unsplit BatchNorm: output, input gradient, parameter
    gradients, running statistics after one step."""
    x, cot, w, b = _inputs()
    xt = torch.from_numpy(x).to(dtype).float().requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    rm, rv = torch.zeros(C), torch.ones(C)
    y = F.batch_norm(xt, rm, rv, wt, bt, training=True, momentum=0.1,
                     eps=1e-5)
    y.backward(torch.from_numpy(cot).to(dtype).float())
    return (y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy(),
            bt.grad.numpy(), rm.numpy(), rv.numpy())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dt,channel_last", CASES)
def test_split_batch_is_the_unsplit_batchnorm(world, dt, channel_last, runs):
    y, dx, dw, db, rm, rv = _unsplit(torch.bfloat16 if dt == "bf16"
                                     else torch.float32)
    tol = BF16_TOL if dt == "bf16" else TOL
    got = [runs[world][r][f"{dt}_{channel_last}"] for r in range(world)]
    n = N // world

    def back(a):
        return a.transpose(0, 3, 1, 2) if channel_last else a

    for r in range(world):
        np.testing.assert_allclose(back(got[r]["y"]), y[r * n:(r + 1) * n],
                                   **tol)
        np.testing.assert_allclose(back(got[r]["dx"]), dx[r * n:(r + 1) * n],
                                   **tol)
        np.testing.assert_allclose(got[r]["mean"], rm, **TOL)
        np.testing.assert_allclose(got[r]["var"], rv, **tol)
    np.testing.assert_allclose(sum(g["dw"] for g in got), dw,
                               **(dict(atol=0.5, rtol=2e-2) if dt == "bf16"
                                  else dict(atol=1e-4, rtol=1e-4)))
    np.testing.assert_allclose(sum(g["db"] for g in got), db,
                               **(dict(atol=0.5, rtol=2e-2) if dt == "bf16"
                                  else dict(atol=1e-4, rtol=1e-4)))
    # eval mode normalizes with the running statistics
    x = _inputs()[0]
    w, b = _inputs()[2:]
    xt = torch.from_numpy(x).to(torch.bfloat16 if dt == "bf16"
                                else torch.float32).float()
    want_eval = F.batch_norm(xt, torch.from_numpy(rm), torch.from_numpy(rv),
                             torch.from_numpy(w), torch.from_numpy(b),
                             training=False, eps=1e-5).numpy()
    for r in range(world):
        np.testing.assert_allclose(back(got[r]["y_eval"]),
                                   want_eval[r * n:(r + 1) * n], **tol)


@pytest.mark.parametrize("world", [2, 4])
def test_matches_jax_sync_batchnorm(world, runs):
    x, cot, w, b = _inputs()
    xl = _layout(x, True)
    model = JaxSyncBN(features=C)
    variables = model.init(jax.random.PRNGKey(0), xl[:1],
                           use_running_average=False)
    variables = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                 "batch_stats": variables["batch_stats"]}
    mesh = jps.initialize_model_parallel(devices=jax.devices()[:world])
    try:
        def f(v, xs):
            y, upd = model.apply(v, xs, use_running_average=False,
                                 mutable=["batch_stats"])
            return y, upd["batch_stats"]["mean"][None], \
                upd["batch_stats"]["var"][None]

        y_j, mean_j, var_j = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P(), P("dp")),
            out_specs=(P("dp"), P("dp"), P("dp")), check_vma=False,
        ))(variables, xl)
    finally:
        jps.destroy_model_parallel()
    n = N // world
    for r in range(world):
        got = runs[world][r]["f32_True"]
        np.testing.assert_allclose(got["y"], np.asarray(y_j)[r * n:(r + 1) * n],
                                   **TOL)
        np.testing.assert_allclose(got["mean"], np.asarray(mean_j)[r], **TOL)
        np.testing.assert_allclose(got["var"], np.asarray(var_j)[r], **TOL)


def test_one_process_is_plain_batchnorm_and_converts():
    x, cot, w, b = _inputs()
    net = torch.nn.Sequential(torch.nn.Conv2d(C, C, 1),
                              torch.nn.BatchNorm2d(C))
    with torch.no_grad():
        net[1].weight.copy_(torch.from_numpy(w))
        net[1].bias.copy_(torch.from_numpy(b))
    ref = torch.nn.Sequential(torch.nn.Conv2d(C, C, 1),
                              torch.nn.BatchNorm2d(C))
    ref.load_state_dict(net.state_dict())
    conv = convert_syncbn_model(net)
    assert isinstance(conv[1], SyncBatchNorm)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(conv(xt).detach().numpy(),
                               ref(xt).detach().numpy(), **TOL)
    np.testing.assert_allclose(conv[1].running_var.numpy(),
                               ref[1].running_var.numpy(), **TOL)
    with pytest.raises(ValueError, match="channels"):
        SyncBatchNorm(C + 1)(xt)

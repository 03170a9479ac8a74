"""apex_tpu_torch.parallel_state vs the JAX package's mesh.

Spawned gloo processes (``torch_dist_workers.parallel_state_case``) at
world 4 and 8 under several (tp, pp, cp) layouts: global rank ``r``
must hold the coordinates of device ``r`` of the JAX mesh (axis order
``(dp, pp, cp, tp)``, tp fastest), its groups the ranks of the devices
that share its other coordinates, and an all-reduce over each group
must sum exactly those ranks.  Also the pipeline helpers, the tp
source rank, ``data_parallel_shard``, ``broadcast_data``, and the
one-process behaviour (every axis of size 1, no group) without any
process group.
"""

import jax
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from apex_tpu import parallel_state as jps
from apex_tpu_torch import parallel_state as ps

LAYOUTS = {4: [(1, 1, 1), (2, 1, 1), (2, 2, 1), (1, 4, 1), (2, 1, 2),
               (4, 1, 1)],
           8: [(2, 2, 2), (2, 1, 1)]}
AXES = ("dp", "pp", "cp", "tp")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ps_runs")
    out = {}
    for world, layouts in LAYOUTS.items():
        cases = [(f"{tp}_{pp}_{cp}", "parallel_state_case",
                  dict(tp=tp, pp=pp, cp=cp)) for tp, pp, cp in layouts]
        if world == 4:
            cases.append(("broadcast", "broadcast_data_case", {}))
        out[world] = workers.spawn(world, cases, tmp)
    return out


@pytest.mark.parametrize("world,layout", [
    (w, lay) for w, lays in LAYOUTS.items() for lay in lays])
def test_rank_r_is_device_r_of_the_jax_mesh(world, layout, runs):
    tp, pp, cp = layout
    devices = jax.devices()[:world]
    mesh = jps.initialize_model_parallel(
        tensor_model_parallel_size=tp, pipeline_model_parallel_size=pp,
        context_parallel_size=cp, devices=devices)
    try:
        grid = np.vectorize(lambda d: d.id)(mesh.devices)
        assert mesh.axis_names == AXES
    finally:
        jps.destroy_model_parallel()
    for r in range(world):
        got = runs[world][r][f"{tp}_{pp}_{cp}"]
        where = np.argwhere(grid == devices[r].id)[0]
        assert got["shape"] == dict(zip(AXES, grid.shape))
        assert got["coords"] == dict(zip(AXES, (int(i) for i in where)))
        for a, axis in enumerate(AXES):
            idx = list(where)
            idx[a] = slice(None)
            members = [int(np.argwhere(np.vectorize(lambda d: d.id)(
                np.asarray(devices)) == i)[0][0]) for i in grid[tuple(idx)]]
            assert got["ranks"][axis] == members, (r, axis)
            assert got["sums"][axis] == float(sum(members)), (r, axis)
        assert got["tp_src"] == got["ranks"]["tp"][0]
        pp_rank = got["coords"]["pp"]
        assert got["first"] == (pp_rank == 0)
        assert got["last"] == (pp_rank == pp - 1)
        assert got["next"] == (pp_rank + 1) % pp
        assert got["prev"] == (pp_rank - 1) % pp
        dp, dp_rank = got["shape"]["dp"], got["coords"]["dp"]
        np.testing.assert_array_equal(
            got["dp_shard"], np.arange(8.0).reshape(dp, -1)[dp_rank])


def test_broadcast_data_sends_tp_rank0s_batch(runs):
    # world 4 at tp 2: ranks 0,1 and 2,3 form the tp groups
    got = [runs[4][r]["broadcast"] for r in range(4)]
    for r in range(4):
        np.testing.assert_array_equal(got[r], np.full(3, float(r - r % 2)))


@pytest.fixture
def destroyed():
    """A one-process test starts from a destroyed ``parallel_state``,
    whatever ran before it in this worker, and leaves none behind."""
    ps.destroy_model_parallel()
    yield
    ps.destroy_model_parallel()


@pytest.mark.usefixtures("destroyed")
def test_one_process_has_no_groups():
    assert not ps.model_parallel_is_initialized()
    assert ps.axis_size("tp") == 1 and ps.axis_rank("dp") == 0
    assert ps.get_group("tp") is None and not ps.axis_is_bound("tp")
    mesh = ps.initialize_model_parallel()
    try:
        assert mesh.shape == dict(dp=1, pp=1, cp=1, tp=1)
        assert all(g is None for g in mesh.groups.values())
        assert ps.get_tensor_model_parallel_world_size() == 1
        assert ps.axis_is_bound("tp") and ps.bound_axis_size("tp") == 1
        with pytest.raises(RuntimeError, match="already initialized"):
            ps.initialize_model_parallel()
    finally:
        ps.destroy_model_parallel()
    with pytest.raises(RuntimeError, match="not initialized"):
        ps.get_tensor_model_parallel_rank()


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.usefixtures("destroyed")
def test_failed_join_raises_never_falls_back(strict):
    from apex_tpu_torch.parallel import multihost

    with pytest.raises(RuntimeError, match="process group join failed"):
        multihost.initialize_distributed(
            init_method="bogus://store", num_processes=1, process_id=0,
            strict=strict, backend="gloo", device="cpu", timeout_s=5)
    assert not multihost.distributed_is_initialized()


@pytest.mark.usefixtures("destroyed")
def test_layout_errors_are_the_references():
    with pytest.raises(RuntimeError, match="not divisible"):
        ps.initialize_model_parallel(2)
    with pytest.raises(ValueError, match=">= 1"):
        ps.initialize_model_parallel(0)
    with pytest.raises(RuntimeError, match="interleaved"):
        ps.initialize_model_parallel(1, 1, 2)
    with pytest.warns(RuntimeWarning, match="single-slice"):
        ps.initialize_model_parallel(dcn_data_parallel=True)
    ps.destroy_model_parallel()
    with pytest.raises(ValueError, match="not divisible"):
        ps.divide(5, 2)
    assert ps.divide(6, 3) == jps.divide(6, 3) == 2


@pytest.mark.usefixtures("destroyed")
def test_virtual_pipeline_setters():
    ps.initialize_model_parallel()
    try:
        assert ps.get_virtual_pipeline_model_parallel_rank() is None
        ps.set_virtual_pipeline_model_parallel_world_size(2)
        assert ps.get_virtual_pipeline_model_parallel_rank() == 0
        assert ps.is_pipeline_first_stage()
        assert not ps.is_pipeline_last_stage()
        assert ps.is_pipeline_last_stage(ignore_virtual=True)
        ps.set_virtual_pipeline_model_parallel_rank(1)
        assert ps.is_pipeline_last_stage() and not ps.is_pipeline_first_stage()
        ps.set_virtual_pipeline_model_parallel_world_size(None)
        assert ps.get_virtual_pipeline_model_parallel_rank() is None
    finally:
        ps.destroy_model_parallel()


@pytest.mark.usefixtures("destroyed")
def test_sequence_parallel_registry_is_per_epoch():
    from apex_tpu_torch.models.gpt import GptConfig, GptModel

    cfg = GptConfig(vocab_size=32, hidden_size=16, num_layers=1,
                    num_heads=2, intermediate_size=32, max_seq_len=8,
                    dtype=torch.float32, sequence_parallel=True)
    ps.initialize_model_parallel()
    try:
        model = GptModel(cfg, device="cpu")
        # the 3 LayerNorms' affines and the 2 row-parallel biases
        names = ps.sequence_parallel_param_paths(model)
        assert names == {"layers.0.ln_attn.scale", "layers.0.ln_attn.bias",
                         "layers.0.ln_mlp.scale", "layers.0.ln_mlp.bias",
                         "layers.0.out.bias", "layers.0.fc2.bias",
                         "ln_f.scale", "ln_f.bias"}
        assert all(getattr(p, "sequence_parallel", False)
                   for p in ps.sequence_parallel_params())
    finally:
        ps.destroy_model_parallel()
    assert ps.sequence_parallel_params() == []
    # a stale registry raises instead of under-syncing
    from apex_tpu_torch.transformer.tensor_parallel import (
        allreduce_sequence_parallel_gradients,
    )

    model = GptModel(cfg, device="cpu")
    other = GptModel(cfg, device="cpu")
    with pytest.raises(ValueError, match="stale"):
        allreduce_sequence_parallel_gradients(other.layers[0])
    assert allreduce_sequence_parallel_gradients(
        other.layers[0], strict=False) == 0
    ps.clear_sequence_parallel_params()
    del model

"""apex_tpu_torch's gradient-sync engine, DDP and ZeRO vs the JAX package.

The port runs in spawned gloo processes (one spawn per world size, 2
and 4, every case in it; ``torch_dist_workers.comm_case``), the JAX
package under ``shard_map`` over a dp mesh of the same size, on the
same seeded numpy inputs:

- ``reduce_scatter_flat`` / ``all_gather_flat`` and ``sync_gradients``
  on the three wires (f32, bf16, int8) at 1 and 3 chunks;
- the call log of every sync against ``sync_plan`` (count and exact
  bytes), and ``sync_plan`` / ``zero_plan`` equal to the reference's
  dicts exactly;
- ``quantized_all_reduce_gradients`` within the codec's bound of the
  exact sum (``tests/test_quantized_allreduce.py``'s statement);
- DDP's synced gradients on each wire, ``no_sync`` (local gradients,
  then one sum), gradient accumulation over 4 microbatches equal to one
  step over their rows (the math ``tests/test_comm.py``'s accumulation
  tests state), and the int8 boundary sync training the toy;
- ZeRO Adam and LAMB (``DistributedFusedAdam`` / ``LAMB``) on the f32
  and int8 wires against the reference's ``make_train_step``, the f32
  runs also against ``FusedAdam`` at dp = 1 on the same global batch,
  and one step's call log against ``zero_plan``.

Limits are stated per test (f32: ``TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_workers as workers
from apex_tpu import parallel_state as jps
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.parallel import DistributedDataParallel as JaxDDP
from apex_tpu.parallel import DistributedFusedAdam as JaxZeroAdam
from apex_tpu.parallel import DistributedFusedLAMB as JaxZeroLamb
from apex_tpu.parallel import comm as jcomm
from apex_tpu.parallel.quantized import (
    quantized_all_reduce_gradients as jax_quantized,
)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import comm

TOL = dict(atol=2e-6, rtol=2e-5)
WIRES = ("f32", "bf16", "int8")
CHUNKS = (1, 3)
N_FLAT = 4 * 1000 + 8  # not a multiple of the int8 block
STEPS = 3
GRAD_SHAPES = {"a_big": (40, 25), "b_small": (7,), "c_mid": (300,)}


@pytest.fixture(autouse=True)
def _destroy_port_parallel_state():
    """Leave no port ``parallel_state`` behind (an example's ``main``
    leaves it initialized) for the next test or the next file in this
    worker."""
    yield from workers.port_state_guard()


def _toy():
    rng = np.random.RandomState(0)
    return dict(w1=(rng.randn(8, 16) * 0.3).astype(np.float32),
                w2=(rng.randn(16, 4) * 0.3).astype(np.float32),
                x=rng.randn(64, 8).astype(np.float32),
                y=rng.randn(64, 4).astype(np.float32))


def _flats(world):
    rs = np.random.RandomState(10 + world)
    return [(rs.randn(N_FLAT) * (1 + r)).astype(np.float32)
            for r in range(world)]


def _grads(world):
    rs = np.random.RandomState(20 + world)
    return [{k: (rs.randn(*s) * (r + 1)).astype(np.float32)
             for k, s in GRAD_SHAPES.items()} for r in range(world)]


#: the example trainers at world 2 (tiny, f32, the CPU): name -> (module,
#: argv)
EXAMPLES = {
    "gpt_tp2_sp": ("train_gpt", ["--tp", "2", "--sequence-parallel"]),
    "gpt_zero": ("train_gpt", ["--zero"]),
    "gpt_ddp": ("train_gpt", []),
    "bert_dp2": ("pretrain_bert", []),
    "ddp_example": ("distributed_data_parallel", []),
}


def _example_argv(name, corpus_dir, world_args=()):
    module, extra = EXAMPLES[name]
    if module == "distributed_data_parallel":
        return ["--device", "cpu", "--steps", "6", *world_args]
    seq = "32" if module == "train_gpt" else "16"
    return ["--tiny", "--device", "cpu", "--steps", "3", "--batch", "4",
            "--seq-len", seq, "--lr", "1e-2",
            "--data", str(corpus_dir / f"{module}.bin"), *extra,
            *world_args]


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    from apex_tpu_torch.data import synthetic_token_corpus

    tmp = tmp_path_factory.mktemp("corpora")
    synthetic_token_corpus(tmp / "train_gpt.bin", vocab_size=1024,
                           num_tokens=20_000)
    synthetic_token_corpus(tmp / "pretrain_bert.bin", vocab_size=2048,
                           num_tokens=20_000, floor=1000)
    return tmp


@pytest.fixture(scope="module")
def runs(tmp_path_factory, corpus_dir):
    tmp = tmp_path_factory.mktemp("comm_runs")
    out = {}
    for world in (2, 4):
        cases = [("comm", "comm_case", dict(
            flats=_flats(world), grads=_grads(world), wires=WIRES,
            chunk_counts=CHUNKS, toy=_toy(), steps=STEPS))]
        if world == 2:
            cases += [(name, "example_case", dict(
                module=EXAMPLES[name][0],
                argv=_example_argv(name, corpus_dir, ["--backend", "gloo"])))
                for name in EXAMPLES]
        res = workers.spawn(world, cases, tmp)
        out[world] = [r["comm"] for r in res]
        if world == 2:
            out["examples"] = [{k: r[k] for k in EXAMPLES} for r in res]
    return out


def _mesh(world):
    jps.destroy_model_parallel()
    return jps.initialize_model_parallel(devices=jax.devices()[:world])


def _smap(mesh, f, in_specs, out_specs, **kw):
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, **kw))


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **tol)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("wire", WIRES)
def test_flat_collectives_and_sync_match_jax(world, wire, runs):
    mesh = _mesh(world)
    try:
        flats = np.stack(_flats(world))
        grads = {k: np.stack([g[k] for g in _grads(world)])
                 for k in GRAD_SHAPES}
        for k in CHUNKS:
            def f(flat, g):
                shard = jcomm.reduce_scatter_flat(flat[0], wire=wire, chunks=k)
                full = jcomm.all_gather_flat(shard, wire=wire, chunks=k)
                synced = jcomm.sync_gradients(
                    jax.tree.map(lambda a: a[0], g), wire=wire, chunks=k,
                    min_size=64)
                return (shard[None], full[None],
                        jax.tree.map(lambda a: a[None], synced))

            shard_j, full_j, sync_j = _smap(
                mesh, f, (P("dp"), P("dp")), (P("dp"), P("dp"), P("dp")),
                check_vma=False)(flats, grads)
            for r in range(world):
                shard, full = runs[world][r][f"flat_{wire}_{k}"]
                scale = np.abs(flats).max() * world
                tol = dict(atol=TOL["rtol"] * scale, rtol=0)
                _close(shard, shard_j[r], tol, f"shard {wire} {k}")
                _close(full, full_j[r], tol, f"full {wire} {k}")
                synced, _ = runs[world][r][f"sync_{wire}_{k}"]
                for name in GRAD_SHAPES:
                    _close(synced[name], sync_j[name][r], TOL,
                           f"sync {wire} {k} {name}")
    finally:
        jps.destroy_model_parallel()


def _exact_bytes(plan_entry, world, n_big, wire, k, block=comm.DEFAULT_BLOCK):
    """The exact byte count a plan entry bounds (the plan writes
    ``[0, hi]`` around it)."""
    shard = (n_big + (-n_big) % world) // world
    bounds = comm._chunk_bounds(shard, min(k, shard),
                                1 if wire == "f32" else block)
    if plan_entry["kind"] == "reduce-scatter":
        return shard * 4
    return sum(world * comm.wire_payload_bytes(hi - lo, wire, block)
               for lo, hi in bounds)


@pytest.mark.parametrize("world", [2, 4])
def test_sync_call_log_equals_plan(world, runs):
    """Each sync's collectives equal ``sync_plan`` in count and bytes."""
    sizes = [int(np.prod(s)) for s in GRAD_SHAPES.values()]
    n_big = sum(s for s in sizes if s >= 64)
    small = sum(s for s in sizes if s < 64)
    for wire in WIRES:
        for k in CHUNKS:
            plan = comm.sync_plan(sizes, world, wire=wire, chunks=k,
                                  min_size=64)
            _, log = runs[world][0][f"sync_{wire}_{k}"]
            summary = comm.collective_summary(log)
            assert {r["axis"] for r in log} == {"dp"}
            for entry in plan:
                got = summary.get(entry["kind"], {"count": 0, "bytes": 0})
                if entry["kind"] == "all-reduce":
                    assert got["bytes"] in (small * 4, sum(sizes) * 4)
                    assert got["bytes"] <= entry["bytes"][1]
                    continue
                assert got["count"] == entry["count"], (wire, k, entry)
                assert got["bytes"] == _exact_bytes(
                    entry, world, n_big, wire, k), (wire, k, entry)
                assert {r["dtype"] for r in log
                        if r["kind"] == entry["kind"]} == set(entry["dtypes"])
            assert set(summary) == {e["kind"] for e in plan}


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("chunks", [None, 1, 3])
def test_plans_equal_the_references(world, wire, chunks):
    sizes = [int(np.prod(s)) for s in GRAD_SHAPES.values()] + [5000, 17]
    leaves = {f"l{i}": np.zeros(s, np.float32) for i, s in enumerate(sizes)}
    for min_size in (1, 64, 1024):
        assert comm.sync_plan(sizes, world, wire=wire, chunks=chunks,
                              min_size=min_size) == jcomm.sync_plan(
            leaves, world, wire=wire, chunks=chunks, min_size=min_size)
    for n in (1, 1000, 12345, 9 << 20):
        for pw in (None, "bf16"):
            assert comm.zero_plan(n, world, wire=wire, param_wire=pw,
                                  chunks=chunks) == jcomm.zero_plan(
                n, world, wire=wire, param_wire=pw, chunks=chunks)
    for n in (0, 1, 255, 256, 257, 10 ** 6):
        assert comm.wire_payload_bytes(n, wire) == \
            jcomm.wire_payload_bytes(n, wire)
        assert comm.resolve_chunks(n, chunks) == jcomm.resolve_chunks(n, chunks)
    assert comm.wire_bytes_per_element(wire) == \
        jcomm.wire_bytes_per_element(wire)


def test_chunk_env_overrides(monkeypatch):
    monkeypatch.setenv(comm.ENV_CHUNKS, "5")
    assert comm.resolve_chunks(10, 2) == 5 == jcomm.resolve_chunks(10, 2)
    assert comm.chunks_requested(None)
    with pytest.raises(ValueError):
        comm.check_wire("fp4")


@pytest.mark.parametrize("world", [2, 4])
def test_quantized_sum_within_the_codec_bound(world, runs):
    """SUM semantics: each rank adds its own half-code, so the bound is
    (0.5 (world + 1) + 0.5) / 127 of the largest gradient before the
    sum; and the port's codes and sums are the JAX package's."""
    grads = _grads(world)
    mesh = _mesh(world)
    try:
        stacked = {k: np.stack([g[k] for g in grads]) for k in GRAD_SHAPES}
        want_j = _smap(
            mesh, lambda g: jax.tree.map(lambda a: a[None], jax_quantized(
                jax.tree.map(lambda a: a[0], g), gradient_average=False,
                min_size=1)), (P("dp"),), P("dp"), check_vma=False)(stacked)
    finally:
        jps.destroy_model_parallel()
    gmax = max(np.abs(g[k]).max() for g in grads for k in GRAD_SHAPES)
    bound = (0.5 * (world + 1) + 0.5) / 127.0 * gmax
    for r in range(world):
        got = runs[world][r]["quantized_sum"]
        for k in GRAD_SHAPES:
            exact = sum(g[k] for g in grads)
            assert np.abs(got[k] - exact).max() <= bound, k
            _close(got[k], want_j[k][r], dict(atol=1e-5 * gmax, rtol=0), k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("wire", WIRES)
def test_ddp_grads_match_jax(world, wire, runs):
    toy = _toy()
    params = {"w1": toy["w1"], "w2": toy["w2"]}
    batch = {"x": toy["x"], "y": toy["y"]}

    def loss(p, b):
        pred = jnp.tanh(b["x"] @ p["w1"]) @ p["w2"]
        return jnp.mean((pred - b["y"]) ** 2)

    mesh = _mesh(world)
    try:
        ddp = JaxDDP(loss, wire=wire, min_size=1)
        if wire == "f32":
            l_j, g_j = _smap(mesh, ddp.value_and_grad, (P(), P("dp")),
                             (P(), P()))(params, batch)
        else:
            # the quantized sync's result is replicated by construction,
            # which shard_map cannot infer: take device 0's
            def f(p, b):
                lv, g = ddp.value_and_grad(p, b)
                return lv, jax.tree.map(lambda a: a[None], g)

            l_j, g_j = _smap(mesh, f, (P(), P("dp")), (P(), P("dp")),
                             check_vma=False)(params, batch)
            g_j = jax.tree.map(lambda a: a[0], g_j)
    finally:
        jps.destroy_model_parallel()
    tol = TOL if wire == "f32" else dict(atol=2e-5, rtol=0)
    for r in range(world):
        l, g = runs[world][r][f"ddp_{wire}"]
        _close(l, l_j, TOL)
        for k in params:
            _close(g[k], g_j[k], tol, f"{wire} {k}")


def _local_grads(toy, rank, world):
    n = 64 // world
    x = jnp.asarray(toy["x"][rank * n:(rank + 1) * n])
    y = jnp.asarray(toy["y"][rank * n:(rank + 1) * n])
    return jax.grad(lambda p: jnp.mean(
        (jnp.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2))(
        {"w1": toy["w1"], "w2": toy["w2"]})


@pytest.mark.parametrize("world", [2, 4])
def test_no_sync_keeps_local_grads_then_one_sum(world, runs):
    toy = _toy()
    locals_j = [_local_grads(toy, r, world) for r in range(world)]
    for r in range(world):
        local, synced = runs[world][r]["no_sync"]
        for k in ("w1", "w2"):
            _close(local[k], locals_j[r][k], TOL, k)
            _close(synced[k], sum(np.asarray(g[k]) for g in locals_j), TOL, k)
    spread = np.abs(runs[world][0]["no_sync"][0]["w1"]
                    - runs[world][1]["no_sync"][0]["w1"]).max()
    assert spread > 1e-6  # the gradients really were local


@pytest.mark.parametrize("world", [2, 4])
def test_accumulation_matches_one_big_batch(world, runs):
    """K = 4 microbatches accumulated and synced once equal one step over
    their rows (mean of equal means): losses and params, 3 Adam steps;
    and the one-step run equals the JAX ``make_step``."""
    l1, p1 = runs[world][0]["accum1"]
    l4, p4 = runs[world][0]["accum4"]
    np.testing.assert_allclose(l1, l4, rtol=1e-5)
    for k in p1:
        _close(p4[k], p1[k], dict(rtol=1e-5, atol=1e-6), k)
    toy = _toy()
    params = {"w1": toy["w1"], "w2": toy["w2"]}

    def loss(p, b):
        pred = jnp.tanh(b["x"] @ p["w1"]) @ p["w2"]
        return jnp.mean((pred - b["y"]) ** 2)

    mesh = _mesh(world)
    try:
        tx = jax_fused_adam(5e-2)
        step = JaxDDP(loss).make_step(tx, mesh)
        p, o = params, tx.init(params)
        losses = []
        for _ in range(STEPS):
            p, o, lj = step(p, o, {"x": toy["x"], "y": toy["y"]})
            losses.append(float(lj))
    finally:
        jps.destroy_model_parallel()
    np.testing.assert_allclose(l1, losses, rtol=1e-5)
    for k in p1:
        _close(p1[k], p[k], dict(rtol=1e-5, atol=1e-6), k)


@pytest.mark.parametrize("world", [2, 4])
def test_accum_with_int8_boundary_sync_trains(world, runs):
    losses = runs[world][0]["accum_int8"]
    assert losses[-1] < 0.6 * losses[0], losses


def _jax_zero(world, cls, wire):
    toy = _toy()
    params = {"w1": jnp.asarray(toy["w1"]), "w2": jnp.asarray(toy["w2"])}

    def loss(p, b):
        pred = jnp.tanh(b["x"] @ p["w1"]) @ p["w2"]
        return jnp.mean((pred - b["y"]) ** 2)

    mesh = _mesh(world)
    try:
        opt = cls(lr=1e-2, weight_decay=0.01, wire=wire, chunks=2)
        state = opt.init(params, world=world)
        step = opt.make_train_step(loss, mesh)
        losses = []
        for _ in range(STEPS):
            params, state, lj = step(params, state,
                                     {"x": toy["x"], "y": toy["y"]})
            losses.append(float(lj))
    finally:
        jps.destroy_model_parallel()
    return losses, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["adam", "lamb"])
@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_zero_matches_jax(world, name, wire, runs):
    cls = JaxZeroAdam if name == "adam" else JaxZeroLamb
    losses_j, params_j = _jax_zero(world, cls, wire)
    tol = TOL if wire == "f32" else dict(atol=1e-5, rtol=1e-4)
    for r in range(world):
        losses, params, *_ = runs[world][r][f"zero_{name}_{wire}"]
        np.testing.assert_allclose(losses, losses_j, **tol)
        for k in params:
            _close(params[k], params_j[k], tol, f"{name} {wire} {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_zero_adam_equals_fused_adam_at_dp1(world, runs):
    """ZeRO Adam over ``world`` ranks = FusedAdam in one process on the
    same global batch (the gradients are equal means of equal rows)."""
    toy = _toy()
    model = workers.Toy(toy["w1"], toy["w2"])
    opt = FusedAdam(model.parameters(), lr=1e-2, weight_decay=0.01)
    x, y = torch.from_numpy(toy["x"]), torch.from_numpy(toy["y"])
    losses = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = model(x, y)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    got_losses, got, *_ = runs[world][0]["zero_adam_f32"]
    np.testing.assert_allclose(got_losses, losses, **TOL)
    for k, p in model.named_parameters():
        _close(got[k], p.detach().numpy(), TOL, k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["adam", "lamb"])
@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_zero_call_log_equals_plan(world, name, wire, runs):
    _, _, summary, plan, padded, shard = runs[world][0][f"zero_{name}_{wire}"]
    assert plan["mesh"] == {"dp": world}
    assert plan["collectives"] == jcomm.zero_plan(
        (16 * 8 + 16 * 4), world, wire=wire, chunks=2)
    assert padded == shard * world and padded - 192 < world
    for entry in plan["collectives"]:
        got = summary[entry["kind"]]
        if entry["kind"] == "all-reduce":
            assert got["bytes"] <= entry["bytes"][1]
            continue
        assert got["count"] == entry["count"], entry
        bounds = comm._chunk_bounds(shard, min(2, shard),
                                    1 if wire == "f32" else comm.DEFAULT_BLOCK)
        exact = (shard * 4 if entry["kind"] == "reduce-scatter" else
                 sum(world * comm.wire_payload_bytes(hi - lo, wire)
                     for lo, hi in bounds))
        assert got["bytes"] == exact, entry


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_at_world_2_match_world_1(name, runs, corpus_dir):
    """The example trainers over 2 gloo ranks against the same command in
    one process: the tp = 2 and ZeRO runs and DDP are the world-1 run
    (the same global batch; f32); BERT's dp = 2 objective is the mean of
    its two halves' losses (each normalized by its own predictions, as
    the reference's pmean), so its first loss is that mean computed here;
    the plain DDP script trains."""
    from apex_tpu_torch import parallel_state as ps

    got = [r[name] for r in runs["examples"]]
    assert got[0] == got[1]  # every rank reports the dp-mean loss
    module, _ = EXAMPLES[name]
    if module == "distributed_data_parallel":
        assert got[0][-1] < got[0][0]
        return
    argv = _example_argv(name, corpus_dir)
    if name == "gpt_tp2_sp":
        argv = [a for a in argv if a not in ("--tp", "2")]
    import importlib

    mod = importlib.import_module(f"apex_tpu_torch.examples.{module}")
    try:
        if module == "train_gpt":
            want = mod.main(argv)
            np.testing.assert_allclose(got[0], want, rtol=1e-4)
            return
        args = mod.parse_args(argv)
        _, model, _, batches, _ = mod.build(args)
        try:
            b = next(batches)
        finally:
            batches.close()
    finally:
        ps.destroy_model_parallel()
    from apex_tpu_torch.models.bert import bert_pretrain_loss

    halves = []
    for r in range(2):
        part = {}
        for k, v in b.items():
            axis = mod._BATCH_AXIS.get(k, 1)
            per = v.shape[axis] // 2
            part[k] = v.narrow(axis, r * per, per)
        halves.append(float(bert_pretrain_loss(model, part)))
    np.testing.assert_allclose(got[0][0], np.mean(halves), rtol=1e-5)
    assert np.isfinite(got[0]).all()

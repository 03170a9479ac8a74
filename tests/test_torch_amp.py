"""apex_tpu_torch.amp, the guards and the guarded trainer vs the JAX
package.

- ``DynamicLossScaler.update`` over seeded overflow sequences (growth,
  backoff, hysteresis 1 and 3, the min/max clamps) state for state
  against ``apex_tpu.amp``; ``StaticLossScaler``; ``unscale``'s
  ``found_inf``; ``amp_update`` over a sequence with overflows: params,
  the step count a skip keeps, the scaler;
- ``GradGuard`` / ``guarded_amp_update`` over NaN and spike sequences:
  every verdict, guard state and scaler state, and ``guard_metrics``;
- the opt-level table and ``Policy``'s casts;
- ``GradScaler``'s found_inf synced over tp (two gloo ranks, only one
  of which overflows) against the JAX ``GradScaler`` under
  ``shard_map``;
- ``build_guarded`` at dp 2 with accum 1 and 4 (gloo ranks against
  JAX's ``build_guarded`` on the conftest's CPU devices; accum 4 against
  one step over the merged microbatches, see ``_jax_guarded``): per-step
  losses, verdicts, scaler states and the final params, with a NaN step
  and a spike step planted between the two programs; its plan check;
  its refusals.

f32 on the CPU: ``TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_dist_workers as workers
from apex_tpu import amp as jamp
from apex_tpu import parallel_state as jps
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.resilience import guards as jguards
from apex_tpu.train import TrainConfig as JaxTrainConfig
from apex_tpu.train import Trainer as JaxTrainer
from apex_tpu.transformer.amp import GradScaler as JaxGradScaler
from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.resilience import (
    GradGuard,
    guard_metrics,
    guarded_amp_update,
)

TOL = dict(rtol=2e-5, atol=1e-6)


def _state_np(s):
    return tuple(np.asarray(x).astype(np.float64) for x in s)


@pytest.mark.parametrize("kw", [
    dict(growth_interval=3, hysteresis=1),
    dict(growth_interval=2, hysteresis=3),
    dict(init_scale=4.0, growth_interval=1, min_loss_scale=2.0,
         max_loss_scale=16.0),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_dynamic_scaler_sequence_equals_the_reference(kw, seed):
    rs = np.random.RandomState(seed)
    flags = (rs.rand(40) < 0.3).astype(np.float32)
    port, ref = amp.DynamicLossScaler(**kw), jamp.DynamicLossScaler(**kw)
    ps_, js = port.init("cpu"), ref.init()
    for i, f in enumerate(flags):
        ps_ = port.update(ps_, torch.tensor(f))
        js = ref.update(js, jnp.float32(f))
        assert _state_np(ps_) == _state_np(js), i
        assert ps_.growth_tracker.dtype == torch.int32
    static = amp.StaticLossScaler(8.0)
    st = static.init("cpu")
    assert static.update(st, torch.tensor(1.0)) is st
    assert float(static.scale(torch.tensor(2.0), st)) == 16.0


def test_unscale_found_inf_and_metrics():
    scaler = amp.DynamicLossScaler(init_scale=4.0)
    st = scaler.init("cpu")
    grads, found = scaler.unscale({"a": torch.full((3,), 8.0),
                                   "b": torch.ones(2, dtype=torch.bfloat16)},
                                  st)
    assert float(found) == 0.0 and grads["b"].dtype == torch.float32
    assert torch.equal(grads["a"], torch.full((3,), 2.0))
    _, found = scaler.unscale({"a": torch.tensor([1.0, float("nan")])}, st)
    assert float(found) == 1.0
    assert set(amp.DynamicLossScaler.metrics(st)) == set(
        jamp.DynamicLossScaler.metrics(jamp.DynamicLossScaler().init()))


def _sequence(n, seed, poison):
    """n gradient dicts (numpy), with NaN / spike factors planted."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        g = {"w": rs.randn(6, 4).astype(np.float32),
             "b": rs.randn(4).astype(np.float32)}
        p = poison.get(i)
        if p == "nan":
            g["w"][1, 2] = np.nan
        elif p is not None:
            g = {k: v * p for k, v in g.items()}
        out.append(g)
    return out


def test_amp_update_sequence_equals_the_reference():
    params = {"w": np.ones((6, 4), np.float32), "b": np.zeros(4, np.float32)}
    grads = _sequence(10, 3, {2: "nan", 3: "nan", 7: "nan"})
    scaler_kw = dict(init_scale=2.0 ** 8, growth_interval=3)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jt = {k: jnp.asarray(v) for k, v in params.items()}
    ptx, jtx = fused_adam(1e-2), jax_fused_adam(1e-2)
    psc, jsc = (amp.DynamicLossScaler(**scaler_kw),
                jamp.DynamicLossScaler(**scaler_kw))
    po, jo = ptx.init(pt), jtx.init(jt)
    pss, jss = psc.init("cpu"), jsc.init()
    for i, g in enumerate(grads):
        scale = float(pss.loss_scale)
        pg = {k: torch.from_numpy(v) * scale for k, v in g.items()}
        jg = {k: jnp.asarray(v) * scale for k, v in g.items()}
        pt, po, pss, pf = amp.amp_update(ptx, psc, pg, po, pt, pss)
        jt, jo, jss, jf = jamp.amp_update(jtx, jsc, jg, jo, jt, jss)
        assert float(pf) == float(jf), i
        assert _state_np(pss) == _state_np(jss), i
        assert int(po.count) == int(jo.count), i
        for k in pt:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(jt[k]),
                                       err_msg=f"{k} step {i}", **TOL)


@pytest.mark.parametrize("poison", [
    {3: "nan"},
    {4: 1000.0},
    {3: 1000.0, 4: "nan", 5: 1000.0},
    {i: "nan" for i in range(2, 6)},
], ids=["nan", "spike", "mixed", "nan-streak"])
def test_guarded_update_verdicts_equal_the_reference(poison):
    guard_kw = dict(spike_factor=20.0, warmup_steps=2,
                    max_consecutive_skips=3)
    params = {"w": np.ones((6, 4), np.float32), "b": np.zeros(4, np.float32)}
    grads = _sequence(9, 4, poison)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jt = {k: jnp.asarray(v) for k, v in params.items()}
    ptx, jtx = fused_adam(1e-2), jax_fused_adam(1e-2)
    psc = amp.DynamicLossScaler(init_scale=2.0 ** 8, growth_interval=4)
    jsc = jamp.DynamicLossScaler(init_scale=2.0 ** 8, growth_interval=4)
    pgd, jgd = GradGuard(**guard_kw), jguards.GradGuard(**guard_kw)
    po, jo = ptx.init(pt), jtx.init(jt)
    pss, jss = psc.init("cpu"), jsc.init()
    pgs, jgs = pgd.init("cpu"), jgd.init()
    for i, g in enumerate(grads):
        scale = float(pss.loss_scale)
        pg = {k: torch.from_numpy(v) * scale for k, v in g.items()}
        jg = {k: jnp.asarray(v) * scale for k, v in g.items()}
        pt, po, pss, pgs, pv = guarded_amp_update(
            ptx, psc, pgd, pg, po, pt, pss, pgs)
        jt, jo, jss, jgs, jv = jguards.guarded_amp_update(
            jtx, jsc, jgd, jg, jo, jt, jss, jgs)
        for name in ("skipped", "found_inf", "spike"):
            assert float(getattr(pv, name)) == float(getattr(jv, name)), (
                name, i)
        np.testing.assert_allclose(float(pv.grad_norm), float(jv.grad_norm),
                                   **TOL)
        assert _state_np(pss) == _state_np(jss), i
        np.testing.assert_allclose(_state_np(pgs), _state_np(jgs),
                                   err_msg=str(i), **TOL)
        assert bool(pgd.budget_exhausted(pgs)) == bool(
            jgd.budget_exhausted(jgs))
        for k in pt:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(jt[k]),
                                       err_msg=f"{k} step {i}", **TOL)
    pm = guard_metrics(pv, pgs, pgd)
    jm = jguards.guard_metrics(jv, jgs, jgd)
    assert set(pm) == set(jm)
    for k in pm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), err_msg=k,
                                   **TOL)


def test_guard_refuses_bad_settings():
    with pytest.raises(ValueError, match="spike_factor"):
        GradGuard(spike_factor=1.0)
    with pytest.raises(ValueError, match="ema_beta"):
        GradGuard(ema_beta=1.0)


def test_opt_levels_and_policy():
    port, ref = amp.opt_levels(), jamp.opt_levels()
    assert sorted(port) == sorted(ref)
    for k in port:
        p, r = port[k], ref[k]
        assert (p.opt_level, p.keep_batchnorm_fp32, p.master_weights,
                p.loss_scale) == (r.opt_level, r.keep_batchnorm_fp32,
                                  r.master_weights, r.loss_scale)
        assert str(p.compute_dtype).split(".")[-1] == jnp.dtype(
            r.compute_dtype).name
    fp16 = amp.opt_levels(torch.float16)
    assert fp16["O1"].loss_scale == "dynamic" == fp16["O2"].loss_scale
    pol = port["O2"].policy()
    tree = {"x": torch.ones(2), "ids": torch.ones(2, dtype=torch.int64),
            "n": 3}
    cast = pol.cast_to_compute(tree)
    assert cast["x"].dtype == torch.bfloat16
    assert cast["ids"].dtype == torch.int64 and cast["n"] == 3
    assert pol.cast_to_output(cast)["x"].dtype == torch.float32


# ---------------------------------------------------------------------------
# across processes: GradScaler over tp, build_guarded at dp 2
# ---------------------------------------------------------------------------

ROWS, FEAT, OUT = 16, 8, 4
GUARDED_STEPS = 8
#: the NaN step and the spike step planted between the programs
POISON = {3: "nan", 5: 1000.0}


def _guarded_inputs(accum):
    rs = np.random.RandomState(10 + accum)
    w = (0.3 * rs.randn(FEAT, OUT)).astype(np.float32)
    batches = [(rs.randn(accum, ROWS, FEAT).astype(np.float32),
                rs.randn(accum, ROWS, OUT).astype(np.float32))
               for _ in range(GUARDED_STEPS)]
    return w, batches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("amp_runs")
    cases = [(f"guarded_{a}", "guarded_case", dict(
        params_np=_guarded_inputs(a)[0], batches_np=_guarded_inputs(a)[1],
        accum=a, poison=POISON)) for a in (1, 4)]
    cases.append(("scaler", "grad_scaler_case", dict(tp=2)))
    return workers.spawn(2, cases, tmp, timeout=300)


def _jax_guarded(accum):
    """JAX's guarded run.  Its accumulation path fails under jax 0.9.0
    (a scan carry's varying axes: the ``test_comm`` accumulation failures
    of ROADMAP C3), so accum > 1 is held to the math those tests state:
    one step over the microbatches' rows, JAX's accum 1 on the merged
    batch (every microbatch the same size, so the means agree)."""
    from apex_tpu.resilience import GradGuard as JaxGradGuard

    w, batches = _guarded_inputs(accum)
    if accum > 1:
        batches = [tuple(x.reshape(1, -1, x.shape[-1]) for x in b)
                   for b in batches]
    jps.destroy_model_parallel()
    try:
        g = JaxTrainer(JaxTrainConfig(
            mesh={"dp": 2}, rules=[(r".*", JP())],
            update_sharding="replicate",
            devices=jax.devices()[:2])).build_guarded(
            lambda p, b: jnp.mean((b[0] @ p["w"] - b[1]) ** 2),
            {"w": jnp.asarray(w)}, tx=jax_fused_adam(1e-2),
            scaler=jamp.DynamicLossScaler(init_scale=2.0 ** 10),
            guard=JaxGradGuard(warmup_steps=2), accum=1)
        state, rows = g.state, []
        for i, b in enumerate(batches):
            loss, scaled = g.compute_grads(
                state["params"], state["scaler"],
                tuple(jnp.asarray(x) for x in b))
            p = POISON.get(i)
            if p == "nan":
                scaled = jax.tree.map(lambda v: jnp.full_like(v, jnp.nan),
                                      scaled)
            elif p is not None:
                scaled = jax.tree.map(lambda v: v * p, scaled)
            state, v = g.apply_update(scaled, state, loss)
            rows.append(dict(
                loss=float(loss), skipped=float(v.skipped),
                found_inf=float(v.found_inf), spike=bool(v.spike),
                grad_norm=float(v.grad_norm),
                scale=float(state["scaler"].loss_scale),
                tracker=int(state["scaler"].growth_tracker),
                count=int(state["opt"].count)))
        return rows, np.asarray(state["params"]["w"])
    finally:
        jps.destroy_model_parallel()


@pytest.mark.parametrize("accum", [1, 4])
def test_build_guarded_at_dp2_equals_the_reference(accum, runs,
                                                   eight_devices):
    rows, w = _jax_guarded(accum)
    assert [r["skipped"] for r in rows] == [
        1.0 if i in POISON else 0.0 for i in range(GUARDED_STEPS)]
    for rank in range(2):
        got = runs[rank][f"guarded_{accum}"]
        for i, (a, b) in enumerate(zip(got["rows"], rows)):
            for k in ("skipped", "found_inf", "spike", "scale", "tracker",
                      "count"):
                assert a[k] == b[k], (k, i)
            np.testing.assert_allclose(a["loss"], b["loss"], **TOL)
            if i not in POISON:
                np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                           **TOL)
        np.testing.assert_allclose(got["w"], w, **TOL)


@pytest.mark.parametrize("accum", [1, 4])
def test_build_guarded_plan_and_refusals(accum, runs):
    for r in (runs[0][f"guarded_{accum}"], runs[1][f"guarded_{accum}"]):
        assert r["findings"] == []
        assert set(r["plan"]) == {"all-reduce"}  # the sync and the loss
        tp, shard = r["refusals"]
        assert "tp=2" in tp and "Trainer.build" in tp
        assert "cannot shard" in shard


def test_grad_scaler_syncs_found_inf_over_tp(runs, eight_devices):
    jps.destroy_model_parallel()
    try:
        mesh = jps.initialize_model_parallel(
            tensor_model_parallel_size=2, devices=jax.devices()[:2])
        scaler = JaxGradScaler(init_scale=4.0)

        def f(g):
            rank = jax.lax.axis_index("tp")
            g = jnp.where(rank == 1, jnp.inf, g[0])
            _, found = scaler.unscale({"w": g}, scaler.init())
            return found[None]

        want = np.asarray(jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(JP("tp"),), out_specs=JP("tp"),
            check_vma=False))(jnp.ones((2, 4))))
    finally:
        jps.destroy_model_parallel()
    for rank in range(2):
        got = runs[rank]["scaler"]
        assert got["synced"] == want[rank] == 1.0
        assert got["plain"] == (1.0 if rank == 1 else 0.0)
        assert [(r["kind"], r["axis"]) for r in got["log"]] == [
            ("all-reduce", "tp")]

"""apex_tpu_torch's fleet view and health rules vs the JAX package's.

- ``FleetAggregator`` over the data-parallel group of 2 and 4 gloo ranks
  (``tests/torch_dist_workers.py::fleet_case``, one spawn per world size)
  against the reference's over the conftest's CPU devices: the gathered
  matrix, the straggler event naming the slow host, and the host
  collapse under ``LOCAL_WORLD_SIZE`` 1, 2 and the world (the
  reference's process map set to the same hosts) are EQUAL.
- "No per-step sync" is held by counting: between cadences ``observe``
  dispatches no gather and waits on no handle; each cadence dispatches
  one and waits on the one before (the reference's wall-clock tripwire
  is timing-flaky under load).
- Every training and goodput rule runs the reference's cases on both
  packages: the events (rule, severity, step, value, threshold, message,
  host) are EQUAL, and the reference's claims hold on them.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.observability as jobs
import torch_dist_workers as workers
from apex_tpu import parallel_state as jps
from apex_tpu_torch import observability as pobs

NAMES = ("train/step_time_ms", "train/mfu")


def _scalar(side, v):
    return jnp.float32(v) if side == "jax" else torch.tensor(v,
                                                             dtype=torch.float32)


def _events(evs):
    return [tuple(e) for e in evs]


# ---------------------------------------------------------------------------
# the fleet view across processes
# ---------------------------------------------------------------------------


def _rows(world):
    rows = np.full((world, len(NAMES)), 100.0, np.float32)
    rows[:, 1] = 0.4 + 0.01 * np.arange(world)
    rows[world // 2, 0] = 400.0  # the straggler
    return rows


def _values(world, steps=10):
    rs = np.random.RandomState(world)
    return [rs.rand(world, len(NAMES)).astype(np.float32) + i
            for i in range(steps)]


@pytest.fixture(scope="module")
def fleet_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    out = {}
    for world in (2, 4):
        cases = [(f"L{lw}", "fleet_case", dict(
            names=NAMES, rows=_rows(world), values=_values(world), every=4,
            local_world_size=lw)) for lw in sorted({1, 2, world})]
        out[world] = workers.spawn(world, cases, tmp)
    return out


def _jax_agg(world):
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(devices=jax.devices()[:world])
    return jobs.FleetAggregator(NAMES, mesh=mesh, every=4, publish=False)


@pytest.mark.parametrize("world", [2, 4])
def test_gathered_rows_and_straggler_equal_the_reference(fleet_runs, world):
    rows = _rows(world)
    agg = _jax_agg(world)
    try:
        want = agg.gather_rows(rows)
        agg._view = jobs.FleetView(10, agg.names, want)
        want_ev = _events(jobs.Watchdog([jobs.health.StragglerRule(
            zmax=3.0)], fleet=agg).check(10))
    finally:
        jps.destroy_model_parallel()
    for rank_out in fleet_runs[world]:
        for case in rank_out.values():
            np.testing.assert_array_equal(case["gathered"], want)
            got_ev = [(r, h, v, m) for r, h, v, m in case["events"]]
            assert got_ev == [(e[0], e[6], e[3], e[5]) for e in want_ev]
    assert want_ev and want_ev[0][6] == world // 2


@pytest.mark.parametrize("world", [2, 4])
def test_hosts_collapse_as_the_reference(fleet_runs, world):
    rows = _rows(world)
    agg = _jax_agg(world)
    try:
        for lw in sorted({1, 2, world}):
            hosts = [r // lw for r in range(world)]
            agg._row_host = hosts
            want = agg._collapse(9, rows)
            for rank_out in fleet_runs[world]:
                case = rank_out[f"L{lw}"]
                assert case["row_host"] == hosts
                got = case["collapsed"]
                assert got.host_ids == want.host_ids
                assert got.labels == want.labels
                np.testing.assert_array_equal(got.rows, want.rows)
                assert got.as_dict() == want.as_dict()
    finally:
        jps.destroy_model_parallel()


@pytest.mark.parametrize("world", [2, 4])
def test_no_per_step_sync_between_cadences(fleet_runs, world):
    """Steps 0..9 at every=4: a gather at steps 0, 4 and 8 only, and a
    wait only at the next cadence (on the previous gather); the view
    lags one cadence, as the reference's (its view steps are the same)."""
    agg = _jax_agg(world)
    try:
        want_steps = []
        for step in range(10):
            agg.observe(step, {})
            v = agg.view()
            want_steps.append(None if v is None else v.step)
        want_fetch = agg.fetch().step
    finally:
        jps.destroy_model_parallel()
    gathers = [1, 1, 1, 1, 2, 2, 2, 2, 3, 3]
    waits = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2]
    for rank_out in fleet_runs[world]:
        case = rank_out["L1"]
        assert [c[0] for c in case["cadence"]] == gathers
        assert [c[1] for c in case["cadence"]] == waits
        assert [c[2] for c in case["cadence"]] == want_steps
        step, rows, labels = case["fetched"]
        assert step == want_fetch == 9
        np.testing.assert_array_equal(rows, _values(world)[9])
        assert labels == tuple(range(world))


def test_world_one_view_is_the_local_row():
    from apex_tpu_torch import parallel_state as ps

    ps.destroy_model_parallel()
    agg = pobs.FleetAggregator(NAMES, every=2, publish=False)
    assert agg.world == 1 and agg.group is None
    for step in range(5):
        agg.observe(step, {"train/step_time_ms": float(step)})
    assert agg.gathers == 3 and agg.waits == 0
    assert agg.view().step == 2
    view = agg.fetch()
    assert view.step == 4 and view.per_host("train/step_time_ms") == [4.0]
    assert np.isnan(view.per_host("train/mfu")[0])
    with pytest.raises(ValueError):
        agg.gather_rows(np.zeros((2, 2)))


# ---------------------------------------------------------------------------
# the rules: the reference's cases on both packages
# ---------------------------------------------------------------------------


def _goodput_floor(side, obs):
    acct = obs.GoodputAccountant()
    for i in range(30):
        acct.on_step(i, skipped=(i % 2 == 0))
    wd = obs.Watchdog([obs.health.GoodputFloorRule(floor=0.8,
                                                   min_executed=20)],
                      goodput=acct)
    return wd.check(30)


def _loss_spike(side, obs):
    reg = obs.MetricRegistry(fetch_every=1)
    reg.gauge("train/loss")

    def push(step, loss):
        reg.observe(step, reg.update(reg.init(),
                                     {"train/loss": _scalar(side, loss)}))
        reg.fetch()

    rule = obs.health.LossSpikeRule(factor=5.0, warmup_fetches=2)
    wd = obs.Watchdog([rule], registry=reg)
    out = []
    for s, loss in enumerate([2.0, 2.1, 1.9, 2.0, 50.0]):
        push(s, loss)
        out += wd.check(s)
    rule._last_fired = None
    push(5, 2.0)
    out += wd.check(5)
    rule._last_fired = None
    push(6, float("nan"))
    out += wd.check(6)
    return out


def _nan_rate(side, obs):
    wd = obs.Watchdog([obs.health.NaNRateRule(max_rate=0.25, window=8)],
                      check_every=10 ** 9)
    for i in range(8):
        wd.on_step(i, skipped=(i == 3))
    out = wd.check(7)
    for i in range(8, 16):
        wd.on_step(i, skipped=(i % 2 == 0))
    return out + wd.check(15)


def _stale_fetch(side, obs):
    reg = obs.MetricRegistry(fetch_every=4)
    reg.gauge("x")
    wd = obs.Watchdog([obs.health.StaleFetchRule()], registry=reg)
    wd.on_step(0)
    return wd.check(10) + wd.check(20)


def _hung_step(side, obs):
    clock = [0.0]
    wd = obs.Watchdog([obs.health.HungStepRule(deadline_s=5.0)],
                      check_every=10 ** 9, clock=lambda: clock[0])
    out = []
    for t, step in ((0.0, 0), (1.0, 1), (11.0, 2)):
        clock[0] = t
        wd.on_step(step)
        out += wd.check(step)
    for t, step in ((30.0, None), (31.0, 3), (50.0, None), (60.0, None)):
        clock[0] = t
        if step is None:
            out += wd.poll()
        else:
            wd.on_step(step)
    return out


def _mfu_floor(side, obs):
    clockv = [0.0]

    def clock():
        clockv[0] += 1.0
        return clockv[0]

    meter = obs.StepMeter(flops_per_step=1e9, peak_flops=1e12, clock=clock)
    for _ in range(20):
        meter.tick()
    wd = obs.Watchdog([obs.health.MFUFloorRule(floor=0.05,
                                               warmup_steps=16)],
                      meter=meter)
    quiet = obs.Watchdog([obs.health.MFUFloorRule(floor=0.0005,
                                                  warmup_steps=16)],
                         meter=meter)
    return wd.check(20) + quiet.check(20)


def _fractions(side, obs):
    obs.board.clear()
    out = []
    for attribution in (None, {"collective": 0.5, "host_stall": 0.05}):
        wd = obs.Watchdog([obs.health.CollectiveFractionRule(),
                           obs.health.HostStallRule()],
                          attribution=attribution)
        out += wd.check(1)
    obs.board.set("attribution/host_stall_fraction", 0.4)
    obs.board.set("attribution/collective_fraction", 0.1)
    out += obs.Watchdog([obs.health.CollectiveFractionRule(),
                         obs.health.HostStallRule()]).check(2)
    obs.board.clear()
    return out


def _memory_ckpt_input(side, obs):
    obs.board.clear()
    out = []
    rules = [obs.health.MemoryBudgetRule(1000), obs.health.CheckpointStallRule(),
             obs.health.InputStallRule()]
    wd = obs.Watchdog(rules)
    out += wd.check(0)
    for step, (peak, stall, inp) in enumerate(
            [(950.0, 0.015, 0.2), (1200.0, 0.05, 0.1), (500.0, 0.005, 0.3)],
            start=1):
        for r in rules:
            r._last_fired = None
        obs.board.set("analysis/peak_hbm_bytes", peak)
        obs.board.set("goodput/ckpt/stall_frac", stall)
        obs.board.set("data/input_stall_fraction", inp)
        if step == 3:
            obs.board.set("attribution/host_stall_fraction", 0.25)
        out += wd.check(step)
    obs.board.clear()
    return out


def _goodput_rules(side, obs):
    acct = obs.GoodputAccountant()
    for i in range(40):
        acct.on_step(i, skipped=(i % 20 == 0))
    rules = obs.goodput_rules(floor=0.99, goodput_floor={"cooldown": 8})
    return [r.name for r in rules] + list(
        obs.Watchdog(rules, goodput=acct).check(40))


def _default_set(side, obs):
    rules = obs.default_rules(straggler={"zmax": 2.5})
    with pytest.raises(ValueError, match="unknown health rules"):
        obs.default_rules(typo={})
    with pytest.raises(ValueError):
        obs.goodput_rules(typo={})
    with pytest.raises(ValueError):
        obs.health.MemoryBudgetRule(0)
    wd = obs.Watchdog()
    return [r.name for r in rules] + [rules[0].zmax] + [
        r.name for r in wd.rules]


def _rollback(side, obs):
    wd = obs.Watchdog([obs.health.NaNRateRule(max_rate=0.25, window=8)],
                      check_every=10 ** 9)
    for i in range(8):
        wd.on_step(i, skipped=True)
    wd.on_rollback(7, 0, 8, 0)
    for i in range(8):
        wd.on_step(i, skipped=False)
    return wd.check(8)


CASES = {
    "goodput_floor": _goodput_floor,
    "loss_spike": _loss_spike,
    "nan_rate": _nan_rate,
    "stale_fetch": _stale_fetch,
    "hung_step": _hung_step,
    "mfu_floor": _mfu_floor,
    "fractions": _fractions,
    "memory_ckpt_input": _memory_ckpt_input,
    "goodput_rules": _goodput_rules,
    "default_rules": _default_set,
    "rollback": _rollback,
}

#: the reference's claims on each case's events (rule names in order)
WANT_RULES = {
    "goodput_floor": ["goodput_floor"],
    "loss_spike": ["loss_spike", "loss_spike"],
    "nan_rate": ["nan_rate"],
    "stale_fetch": ["stale_fetch"],
    "hung_step": ["hung_step", "hung_step"],
    "mfu_floor": ["mfu_floor"],
    "fractions": ["collective_fraction", "host_stall"],
    "memory_ckpt_input": ["memory_budget", "ckpt_stall", "input_stall",
                          "memory_budget", "ckpt_stall", "input_stall"],
    "rollback": [],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rule_case_equals_the_reference(name):
    got = CASES[name]("port", pobs)
    want = CASES[name]("jax", jobs)
    as_json = (lambda evs: json.dumps(  # events as tuples; NaN as NaN
        [tuple(e) if hasattr(e, "_fields") else e for e in evs],
        default=str))
    assert as_json(got) == as_json(want)
    if name in WANT_RULES:
        assert [e.rule for e in got] == WANT_RULES[name]
    if name == "loss_spike":
        assert got[0].value == pytest.approx(50.0)
        assert got[1].severity == "critical" and got[1].value != got[1].value
    if name == "hung_step":
        assert got[0].value == pytest.approx(10.0)
        assert got[1].value == pytest.approx(19.0)
    if name == "memory_ckpt_input":
        assert [e.severity for e in got] == ["warn", "warn", "warn",
                                             "critical", "critical", "warn"]
        assert "reads 0.250" in got[-1].message
    if name == "default_rules":
        assert got[:9] == ["straggler", "mfu_floor", "goodput_floor",
                           "loss_spike", "nan_rate", "stale_fetch",
                           "hung_step", "collective_fraction", "host_stall"]
        assert got[9] == 2.5 and got[10:] == got[:9]


def test_attribution_feeds_the_fraction_rules():
    """The port's own chain: a trace's attribution, published on the
    board, fires ``host_stall`` through a default ``Watchdog``."""
    from apex_tpu_torch.observability import attribution as A

    pobs.board.clear()
    ev = [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
           "name": "ln_fwd_kernel<1024>", "ts": ts, "dur": 10}
          for ts in (0, 100)]
    fr = A.publish_attribution(A.attribute_trace({"traceEvents": ev}))
    assert fr["host_stall"] == pytest.approx(90 / 110)
    wd = pobs.Watchdog(check_every=1)
    assert [e.rule for e in wd.check(0)] == ["host_stall"]
    pobs.board.clear()

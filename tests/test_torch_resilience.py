"""apex_tpu_torch.resilience against the JAX package's, on the CPU.

- chaos: ``parse_spec`` gives the reference's faults (or the same
  rejection) for the reference's specs; ``active()`` fires at the same
  steps for every registered site and mode, steps 0-999, three seeds,
  exactly; ``corrupt_tree`` poisons the same leaf;
- retry: ``RetryPolicy.delay``, ``retry_call``'s attempts, sleeps,
  warnings and listener events are the reference's;
- the lock sanitizer reports the same cycle for the same acquire order;
- ``run_resilient``: both packages drive one toy step written once in
  numpy (numpy state on the JAX side, CPU tensors on the port's) under
  the same chaos specs and skip schedules — fresh, auto-resume,
  preemption, rollback, the rollback budget, a healing save fault,
  partial debris, a healing restore fault — and the observer's events,
  every ``RunResult`` field and the final state are equal exactly (f32
  elementwise arithmetic: no tolerance).
"""

import os
import signal
import warnings

import numpy as np
import pytest
import torch

from apex_tpu import checkpoint as ref_ckpt
from apex_tpu import resilience as ref_res
from apex_tpu.observability import locks as ref_locks
from apex_tpu.resilience import chaos as ref_chaos
from apex_tpu_torch import checkpoint as port_ckpt
from apex_tpu_torch import resilience as port_res
from apex_tpu_torch.observability import locks as port_locks
from apex_tpu_torch.resilience import chaos as port_chaos

BOTH = (ref_chaos, port_chaos)


@pytest.fixture(autouse=True)
def _clean_chaos():
    for c in BOTH:
        c.clear()
    yield
    for c in BOTH:
        c.clear()


# ---------------------------------------------------------------------------
# chaos
# ---------------------------------------------------------------------------

#: the specs of tests/test_resilience.py and the chaos docstring, and the
#: chip drill's
SPECS = (
    "grads:nan@3,7;checkpoint_save:raise:x1@5;preemption@12;"
    "collective:stall:p=0.25;seed=42",
    "grads:nan@3;serve.decode:nan@5;serve.kv_alloc@2",
    "grads:nan@3,7",
    "checkpoint_save:raise:x1@5",
    "preemption@12",
    "grads:inf:p=0.001",
    "serve.decode:nan@9",
    "grads:nan:p=0.001;seed=42",
    "checkpoint_save:raise:x1@2;checkpoint_save:partial:x1@4;preemption@5",
    " ; grads:nan@1,,2 ;",
)
BAD_SPECS = ("grdas:nan@3", "grads:nan:p0.001", "grads:partial@3",
             "serve.kv_alloc:stall@1", "seed=x")


def _fields(f):
    return (f.site, f.steps, f.probability, f.mode, f.max_hits,
            f.stall_seconds)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_the_reference(spec):
    ref, ref_seed = ref_chaos.parse_spec(spec)
    out, seed = port_chaos.parse_spec(spec)
    assert seed == ref_seed
    assert [_fields(f) for f in out] == [_fields(f) for f in ref]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_spec_rejects_as_the_reference(spec):
    with pytest.raises(Exception) as ref:
        ref_chaos.parse_spec(spec)
    with pytest.raises(Exception) as out:
        port_chaos.parse_spec(spec)
    assert type(out.value) is type(ref.value)
    # the message up to the registry listing (the reference's registry
    # may hold sites other modules of the process registered)
    assert (str(out.value).split("; registered")[0]
            == str(ref.value).split("; registered")[0])


def test_registry_is_the_references():
    builtin = [getattr(ref_chaos, n) for n in ref_chaos.__all__
               if n.isupper()]
    assert set(port_chaos.registered_sites()) == set(builtin)
    for site in builtin:
        assert port_chaos.site_modes(site) == ref_chaos.site_modes(site)


def test_register_site_conflicts_match():
    for c in BOTH:
        c.register_site("unit.port_parity_site", ("raise",), "raise")
        c.register_site("unit.port_parity_site", ("raise",), "raise")
        with pytest.raises(ValueError, match="already registered"):
            c.register_site("unit.port_parity_site", ("raise", "stall"))
        with pytest.raises(ValueError, match="default mode"):
            c.register_site("unit.port_parity_other", ("raise",), "stall")
        with pytest.raises(ValueError):
            c.Fault("not_a_site", steps=(1,))


def _schedule(chaos, faults, seed, site):
    chaos.configure(*faults, seed=seed)
    fired = []
    for step in range(1000):
        f = chaos.active(site, step)
        fired.append(None if f is None else f.mode)
    return fired


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_active_schedule_is_the_references_exactly(seed):
    """Every registered site and mode: a seeded 30% coin, a step list that
    wins over probability 1, and a coin bounded to 5 hits."""
    for site in port_chaos.registered_sites():
        for mode in port_chaos.site_modes(site):
            for spec in (dict(probability=0.3),
                         dict(steps=(3, 500, 999), probability=1.0),
                         dict(probability=0.5, max_hits=5)):
                ref = _schedule(ref_chaos, [ref_chaos.Fault(
                    site, mode=mode, **spec)], seed, site)
                out = _schedule(port_chaos, [port_chaos.Fault(
                    site, mode=mode, **spec)], seed, site)
                assert out == ref, (site, mode, spec)
                assert any(ref) and not all(ref)


def test_active_with_several_faults_counts_hits_as_the_reference():
    spec = ("grads:nan:p=0.2:x7;grads:inf:p=0.1;checkpoint_save:raise@4,9;"
            "seed=5")
    for site in (ref_chaos.GRADS, ref_chaos.CHECKPOINT_SAVE):
        ref = _schedule(ref_chaos, ref_chaos.parse_spec(spec)[0], 5, site)
        out = _schedule(port_chaos, port_chaos.parse_spec(spec)[0], 5, site)
        assert out == ref


def test_corrupt_tree_poisons_the_references_leaf():
    """The first leaf in the reference's order (dict keys sorted), NaN or
    +inf, nothing else touched; a no-op off schedule; inject restores."""
    tree = {"w": np.ones(4, np.float32), "b": np.zeros(2, np.float32),
            "a": [np.full(3, 2.0, np.float32)]}
    port_tree = {"w": torch.ones(4), "b": torch.zeros(2),
                 "a": [torch.full((3,), 2.0)]}
    for mode in ("nan", "inf"):
        with ref_chaos.inject(ref_chaos.Fault(ref_chaos.GRADS, steps=(1,),
                                              mode=mode)):
            ref0 = ref_chaos.corrupt_tree(tree, 0)
            ref1 = ref_chaos.corrupt_tree(tree, 1)
        with port_chaos.inject(port_chaos.Fault(port_chaos.GRADS,
                                                steps=(1,), mode=mode)):
            out0 = port_chaos.corrupt_tree(port_tree, 0)
            out1 = port_chaos.corrupt_tree(port_tree, 1)
        assert out0 is port_tree
        for key in ("a", "b", "w"):
            r = np.asarray(ref1[key][0] if key == "a" else ref1[key])
            o = (out1[key][0] if key == "a" else out1[key]).numpy()
            np.testing.assert_array_equal(o, r)
            np.testing.assert_array_equal(
                (out0[key][0] if key == "a" else out0[key]).numpy(),
                np.asarray(ref0[key][0] if key == "a" else ref0[key]))
        assert torch.equal(port_tree["a"][0], torch.full((3,), 2.0))
    assert port_chaos.faults() == ref_chaos.faults() == ()


def test_maybe_fail_modes_match(tmp_path):
    """raise, partial (orbax-style debris with a payload, then raise) and
    stall (returns) at the same steps, with the same messages."""
    faults = "checkpoint_save:raise@1;checkpoint_save:partial@2;" \
             "collective:stall@3"
    for c, sub in ((ref_chaos, "ref"), (port_chaos, "port")):
        d = tmp_path / sub
        d.mkdir()
        c.configure(*c.parse_spec(faults)[0])
        c.maybe_fail(c.CHECKPOINT_SAVE, 0, partial_dir=d)
        with pytest.raises(c.InjectedFault, match="'raise'.*step 1"):
            c.maybe_fail(c.CHECKPOINT_SAVE, 1, partial_dir=d)
        with pytest.raises(c.InjectedFault, match="'partial'.*step 2"):
            c.maybe_fail(c.CHECKPOINT_SAVE, 2, partial_dir=d)
        assert c.maybe_stall(c.COLLECTIVE, 3) == 0.05
        debris = [p for p in os.listdir(d)
                  if p.startswith("2.orbax-checkpoint-tmp-")]
        assert debris and os.listdir(d / debris[0]) == ["params"]


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, dict(backoff=0.1, factor=3.0, max_backoff=2.0),
    dict(max_attempts=1), dict(backoff=0.0),
])
def test_retry_policy_delay_matches(kw):
    ref = ref_res.RetryPolicy(**kw)
    out = port_res.RetryPolicy(**kw)
    assert out.max_attempts == ref.max_attempts
    assert [out.delay(a) for a in range(12)] == [ref.delay(a)
                                                 for a in range(12)]


def _drive_retry(res, fails, max_attempts):
    sleeps, events, calls = [], [], {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise OSError(f"transient {calls['n']}")
        return "ok"

    def listener(what, attempt, error):
        events.append((what, attempt, type(error).__name__, str(error)))

    policy = res.RetryPolicy(max_attempts=max_attempts, backoff=0.1,
                             factor=2.0, sleep=sleeps.append)
    res.add_retry_listener(listener)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                out = res.retry_call(flaky, policy=policy,
                                     describe="checkpoint save (step 3)")
            except OSError as e:
                out = ("raised", str(e))
    finally:
        res.remove_retry_listener(listener)
    return (out, calls["n"], sleeps, events,
            [str(w.message) for w in caught])


@pytest.mark.parametrize("fails,max_attempts", [(0, 3), (2, 4), (3, 3),
                                                (5, 2)])
def test_retry_call_matches(fails, max_attempts):
    assert _drive_retry(port_res, fails, max_attempts) == _drive_retry(
        ref_res, fails, max_attempts)


# ---------------------------------------------------------------------------
# the lock sanitizer
# ---------------------------------------------------------------------------


def _lock_order_run(locks):
    locks.reset_sanitizer()
    locks.arm(True)
    try:
        a, b, c = (locks.TrackedLock(n) for n in ("ckpt", "stats", "scrape"))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with a:
                with b:
                    pass
            with b:
                with c:
                    pass
            with c:
                with a:  # closes ckpt -> stats -> scrape -> ckpt
                    pass
            with a:
                with b:
                    pass
        report = locks.sanitizer_report()
        return (report, locks.lock_order_graph(), locks.cycles(),
                [str(w.message) for w in caught], a.acquires, a.holder)
    finally:
        locks.arm(None)
        locks.reset_sanitizer()


def test_lock_sanitizer_reports_the_references_cycle():
    out, ref = _lock_order_run(port_locks), _lock_order_run(ref_locks)
    assert out == ref
    assert out[2][0]["cycle"] == ["ckpt", "stats", "scrape"]


# ---------------------------------------------------------------------------
# run_resilient
# ---------------------------------------------------------------------------


def _toy(acc, n, w, batch):
    """The toy step, written once in numpy: f32 elementwise."""
    return (acc + batch, n + np.int32(1),
            w * np.float32(0.5) + batch * np.float32(0.25))


def _batch(step):
    return {"step": step, "x": np.float32(step + 1) * np.float32(0.75)}


class _Recorder:
    """Every observer event, in order; ``on_checkpoint`` takes one
    argument, so the async engine's phase records (timed by the writer
    thread) are not delivered."""

    def __init__(self):
        self.events = []

    def on_step(self, step, skipped, info):
        self.events.append(("step", step, skipped))

    def on_rollback(self, step, anchor, skips, discarded):
        self.events.append(("rollback", step, anchor, skips, discarded))

    def on_resume(self, step):
        self.events.append(("resume", step))

    def on_preempt(self, step):
        self.events.append(("preempt", step))

    def on_checkpoint(self, step):
        self.events.append(("checkpoint", step))

    def on_retry(self, what, attempt, error):
        self.events.append(("retry", what, attempt, type(error).__name__,
                            str(error)))


class _Side:
    """One package's run_resilient on the toy job."""

    def __init__(self, port):
        self.port = port
        self.res = port_res if port else ref_res
        self.chaos = port_chaos if port else ref_chaos

    def init(self):
        acc, n, w = (np.zeros((), np.float32), np.zeros((), np.int32),
                     np.linspace(-1, 1, 4).astype(np.float32))
        if self.port:
            return {"acc": torch.from_numpy(acc), "n": torch.from_numpy(n),
                    "w": torch.from_numpy(w)}
        return {"acc": acc, "n": n, "w": w}

    def step_fn(self, state, batch):
        step, batch = batch["step"], batch["x"]
        if self.chaos.active(self.chaos.GRADS, step) is not None:
            return state, {"skipped": True}  # a guarded skip
        if self.port:
            acc, n, w = (state[k].numpy() for k in ("acc", "n", "w"))
        else:
            acc, n, w = (np.asarray(state[k]) for k in ("acc", "n", "w"))
        acc, n, w = _toy(acc, n, w, batch)
        if self.port:
            return ({"acc": torch.from_numpy(np.asarray(acc)),
                     "n": torch.from_numpy(np.asarray(n)),
                     "w": torch.from_numpy(w)}, {"skipped": False})
        return ({"acc": np.asarray(acc), "n": np.asarray(n), "w": w},
                {"skipped": False})

    def run(self, directory, spec=None, **kw):
        """(RunResult fields without the state, the state as numpy, the
        events) — or the raised exception's type and message."""
        rec = _Recorder()
        kw.setdefault("policy", self.res.RetryPolicy(
            max_attempts=kw.pop("attempts", 3), backoff=0.0,
            sleep=lambda _: None))
        faults = self.chaos.parse_spec(spec)[0] if spec else ()
        try:
            with self.chaos.inject(*faults), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                res = self.res.run_resilient(
                    self.step_fn, self.init(), _batch,
                    directory=directory, observer=rec, **kw)
        except Exception as e:  # noqa: BLE001 — compared across packages
            return ("raised", type(e).__name__, str(e)), None, rec.events
        state = {k: (v.numpy() if self.port else np.asarray(v))
                 for k, v in res.state.items()}
        return tuple(res[1:]), state, rec.events


#: (name, [(spec, run_resilient kwargs), ...] run in order on one dir)
SCENARIOS = {
    "fresh": [(None, dict(num_steps=5))],
    "auto_resume": [(None, dict(num_steps=3)), (None, dict(num_steps=6))],
    "preemption": [("preemption@5", dict(num_steps=10,
                                         save_interval_steps=2)),
                   ("preemption@5", dict(num_steps=10,
                                         save_interval_steps=2))],
    "rollback": [("grads:nan:x3@5,6,7", dict(
        num_steps=10, save_interval_steps=2, rollback_after=3))],
    "rollback_interleaved": [("grads:nan:x5@3,4,6,7,8", dict(
        num_steps=12, save_interval_steps=4, rollback_after=2))],
    "rollback_budget": [("grads:nan@5,6,7", dict(
        num_steps=10, rollback_after=3, max_rollbacks=2))],
    "rollback_before_any_save": [("grads:nan:x2@0,1", dict(
        num_steps=4, save_interval_steps=1, rollback_after=2))],
    "save_fault_heals": [("checkpoint_save:raise:x1@2", dict(num_steps=4))],
    "partial_debris": [
        ("checkpoint_save:partial@3", dict(num_steps=6, attempts=2)),
        (None, dict(num_steps=6))],
    "restore_fault_heals": [
        (None, dict(num_steps=3)),
        ("checkpoint_restore:raise:x1@2", dict(num_steps=5, attempts=2))],
    "chip_drill": [
        ("checkpoint_save:raise:x1@2;checkpoint_save:partial:x1@4;"
         "preemption@5", dict(num_steps=8, save_interval_steps=2,
                              max_to_keep=2)),
        ("checkpoint_save:raise:x1@2;checkpoint_save:partial:x1@4;"
         "preemption@5", dict(num_steps=8, save_interval_steps=2,
                              max_to_keep=2))],
}


@pytest.mark.parametrize("engine", ["async", "sync"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_run_resilient_matches_the_reference(tmp_path, scenario, engine):
    handler = signal.getsignal(signal.SIGTERM)
    results = {}
    for port in (False, True):
        side = _Side(port)
        d = tmp_path / ("port" if port else "ref")
        runs = [side.run(d, spec, checkpoint=engine, **kw)
                for spec, kw in SCENARIOS[scenario]]
        steps = (port_ckpt if port else ref_ckpt).all_steps(d)
        results[port] = (runs, steps)
    assert signal.getsignal(signal.SIGTERM) == handler
    (ref_runs, ref_steps), (out_runs, out_steps) = results[False], results[True]
    if engine == "async":
        assert out_steps == ref_steps
    else:
        # orbax's manager keeps an extra old step after a relaunch next to
        # chaos debris (chip_drill: [4, 5, 6] at max_to_keep=2); the
        # port's manager prunes to max_to_keep
        assert out_steps[-1:] == ref_steps[-1:]
        assert set(out_steps) <= set(ref_steps)
    for (o_res, o_state, o_ev), (r_res, r_state, r_ev) in zip(out_runs,
                                                              ref_runs):
        assert o_ev == r_ev
        assert o_res == r_res
        if r_state is None:
            assert o_state is None
            continue
        assert set(o_state) == set(r_state)
        for k in r_state:
            assert o_state[k].dtype == r_state[k].dtype
            np.testing.assert_array_equal(o_state[k], r_state[k])
    assert out_runs[0][2], "the observer saw nothing"


def test_preemption_handler_sets_flag_and_restores():
    before = signal.getsignal(signal.SIGTERM)
    with port_res.PreemptionHandler() as h:
        assert not h.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.requested
    assert signal.getsignal(signal.SIGTERM) == before


def test_observer_fanout_adapts_checkpoint_arity():
    got = []

    class Old:
        def on_checkpoint(self, step):
            got.append(("old", step))

    class New:
        def on_checkpoint(self, step, info=None):
            got.append(("new", step, info))

    fan = port_res.ObserverFanout([Old(), None, New()])
    fan.on_checkpoint(3)
    fan.on_checkpoint(4, {"phase": "write"})
    assert got == [("old", 3), ("new", 3, None),
                   ("new", 4, {"phase": "write"})]

"""apex_tpu_torch.observability against the JAX package's, on the CPU.

- ``metric_name`` and ``ExportNamespace`` map, accept and reject the same
  keys with the same messages;
- ``render`` gives the reference's exposition byte for byte for the same
  registry values, histograms and board, and ``parse_exposition`` reads
  it back as the reference's parser does; the ``OpsServer`` serves it on
  localhost;
- the ``MetricRegistry``: counters add, gauges replace, min/max fold,
  an undeclared name raises; a fetched value is at most ``2 *
  fetch_every`` steps stale and is the state as observed at its step,
  equal to the reference's at every step of the same sequence;
- span recorders fed the same request events keep the same spans, in
  the same order, or raise the same out-of-order error; a scheduler run
  under faults records the same span chains as the JAX scheduler's;
- flight dumps of the same events are equal apart from wall-clock
  fields;
- the serving health rules fire the same ``HealthEvent`` s on the same
  sequences of registry values (``tests/test_serve.py``'s
  ``TestServeHealthRules`` and its acceptance-rule test among them);
- the board's consumers: ``DevicePrefetcher``'s
  ``data/input_stall_fraction``, the async checkpoint engine's
  ``goodput/ckpt/*`` and the lock sanitizer's ``locksan/cycles``
  gauges, and ``run_resilient`` arming its flight and span recorders
  from ``APEX_TPU_FLIGHT`` / ``APEX_TPU_SPANS``, each held to the
  reference in the same scenario.

No tolerance: every comparison is exact (f32 values from the same
Python numbers on both sides).
"""

import json
import os
import signal
import urllib.request
import warnings

import numpy as np
import pytest
import torch

import apex_tpu.observability as jobs
from apex_tpu.observability import flight as jflight
from apex_tpu.observability import locks as jlocks
from apex_tpu.observability import metrics as jmetrics
from apex_tpu.observability import ometrics as jom
from apex_tpu.observability import spans as jspans
from apex_tpu_torch import observability as pobs
from apex_tpu_torch.observability import flight as pflight
from apex_tpu_torch.observability import locks as plocks
from apex_tpu_torch.observability import metrics as pmetrics
from apex_tpu_torch.observability import ometrics as pom
from apex_tpu_torch.observability import spans as pspans

BOTH = ("jax", "port")
OM = {"jax": jom, "port": pom}
OBS = {"jax": jobs, "port": pobs}
SPANS = {"jax": jspans, "port": pspans}
FLIGHT = {"jax": jflight, "port": pflight}
BOARD = {"jax": jmetrics.board, "port": pmetrics.board}


@pytest.fixture(autouse=True)
def _clean_boards():
    for b in BOARD.values():
        b.clear()
    yield
    for b in BOARD.values():
        b.clear()


def _outcome(fn, *args, **kw):
    """``("ok", value)`` or ``("raised", type name, message)``."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# metric names and the export namespace
# ---------------------------------------------------------------------------

KEYS = ("serve/ttft_queue_wait_fraction", "guard/skipped",
        "fleet/train/step_time_ms/host0", "memstats/device0/bytes_in_use",
        "a-b.c d:e", "Serve//TTFT__ms", "serve/p99!", "///", "", "x",
        "locksan/cycles", "goodput/ckpt/stall_frac", "9lives", "_x_")


@pytest.mark.parametrize("key", KEYS)
def test_metric_name_matches(key):
    assert (_outcome(pom.metric_name, key)
            == _outcome(jom.metric_name, key))


#: declaration sequences (key, kind); each side declares them in order
NAMESPACE_RUNS = (
    [("serve/ttft_ms", "gauge"), ("serve/ttft_ms", "gauge"),
     ("serve.ttft_ms", "gauge")],
    [("serve/shed", "counter"), ("serve/shed_total", "gauge")],
    [("serve/shed_total", "gauge"), ("serve/shed", "counter")],
    [("lat_ms", "histogram"), ("lat_ms_bucket", "gauge")],
    [("lat_ms_count", "gauge"), ("lat_ms", "histogram")],
    [("a/b", "counter"), ("a/b", "gauge")],
    [("///", "gauge")],
)


@pytest.mark.parametrize("run", range(len(NAMESPACE_RUNS)))
def test_export_namespace_collisions_match(run):
    out = {}
    for side in BOTH:
        ns = OM[side].ExportNamespace()
        out[side] = [_outcome(ns.declare, k, kind)
                     for k, kind in NAMESPACE_RUNS[run]]
        out[side].append(sorted(ns.families.items()))
    assert out["port"] == out["jax"]


def test_serve_vocabulary_declares_on_both():
    from apex_tpu.serve import declare_serve_metrics as jdeclare
    from apex_tpu_torch.serve import declare_serve_metrics as pdeclare

    regs = {"jax": jmetrics.MetricRegistry(),
            "port": pmetrics.MetricRegistry()}
    jdeclare(regs["jax"])
    pdeclare(regs["port"])
    assert regs["port"].names == regs["jax"].names
    assert ([regs["port"].kind(n) for n in regs["port"].names]
            == [regs["jax"].kind(n) for n in regs["jax"].names])
    assert ([regs["port"].unit(n) for n in regs["port"].names]
            == [regs["jax"].unit(n) for n in regs["jax"].names])


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _registry(side, fetch_every=1):
    reg = OBS[side].MetricRegistry(fetch_every=fetch_every)
    reg.counter("serve/completed")
    reg.gauge("serve/ttft_ms", "ms")
    reg.gauge("serve/batch_fill", "fraction of max_batch slots")
    reg.minimum("train/loss_min")
    reg.maximum("train/loss_max")
    return reg


#: per-step updates (the same Python numbers on both sides)
UPDATES = [
    {"serve/completed": 1, "serve/ttft_ms": 12.5, "train/loss_min": 3.25,
     "train/loss_max": 3.25},
    {"serve/completed": 2, "serve/batch_fill": 0.5, "train/loss_min": 2.0,
     "train/loss_max": 2.0},
    {"serve/completed": True, "serve/ttft_ms": 0.1,
     "train/loss_min": 4.0, "train/loss_max": 4.0},
    {"serve/ttft_ms": float("inf")},
    {"serve/completed": 1e-7, "serve/batch_fill": 1 / 3},
    {"serve/ttft_ms": float("nan"), "train/loss_max": 9.5},
    {"serve/completed": 3},
    {},
    {"serve/completed": 1, "train/loss_min": -1.0},
]


def _values_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert (a[k] == b[k]) or (a[k] != a[k] and b[k] != b[k]), (k, a, b)


@pytest.mark.parametrize("fetch_every", [1, 2, 3])
def test_registry_fetches_match_and_stay_fresh(fetch_every):
    """The same updates and observes give the same fetched values and
    steps on both sides at every step; a fetched value is the state as
    observed at its step, at most 2 * fetch_every steps back."""
    regs = {s: _registry(s, fetch_every) for s in BOTH}
    states = {s: regs[s].init() for s in BOTH}
    observed = []  # the port's state as observed, step by step
    for step, upd in enumerate(UPDATES):
        for s in BOTH:
            states[s] = regs[s].update(states[s], upd)
            regs[s].observe(step, states[s])
        observed.append({k: float(v) for k, v in states["port"].items()})
        _values_equal(regs["port"].values(), regs["jax"].values())
        assert regs["port"].fetched_step == regs["jax"].fetched_step
        fetched = regs["port"].fetched_step
        if fetched is not None:
            assert step - fetched <= 2 * fetch_every
            _values_equal(regs["port"].values(), observed[fetched])
    # an update after the last observe is not in the observed state
    for s in BOTH:
        states[s] = regs[s].update(states[s], {"serve/completed": 100})
    _values_equal(regs["port"].fetch(), regs["jax"].fetch())
    assert regs["port"].values()["serve/completed"] == observed[-1][
        "serve/completed"]
    _values_equal(regs["port"].close(), regs["jax"].close())


def test_registry_update_semantics():
    reg = _registry("port")
    state = reg.init()
    assert all(t.dtype == torch.float32 and t.dim() == 0
               and t.device.type == "cpu" for t in state.values())
    assert float(state["train/loss_min"]) == float("inf")
    assert float(state["train/loss_max"]) == float("-inf")
    same = {k: id(v) for k, v in state.items()}
    out = reg.update(state, {"serve/completed": 2, "serve/ttft_ms": 4.0,
                             "train/loss_min": 1.5})
    out = reg.update(out, {"serve/completed": torch.tensor(True),
                           "serve/ttft_ms": 7.0, "train/loss_min": 3.0,
                           "train/loss_max": torch.tensor(2.5)})
    assert out is state and {k: id(v) for k, v in out.items()} == same
    assert {k: float(v) for k, v in out.items()} == {
        "serve/completed": 3.0, "serve/ttft_ms": 7.0,
        "serve/batch_fill": 0.0, "train/loss_min": 1.5,
        "train/loss_max": 2.5}
    with pytest.raises(KeyError, match="not declared"):
        reg.update(state, {"serve/complete": 1})
    with pytest.raises(ValueError, match="already declared"):
        reg.gauge("serve/completed")
    with pytest.raises(ValueError):
        reg.gauge("serve.completed")  # collides after the name mapping


# ---------------------------------------------------------------------------
# the exposition
# ---------------------------------------------------------------------------


def _exposition(side):
    reg = _registry(side)
    state = reg.init()
    for step, upd in enumerate(UPDATES[:3]):
        state = reg.update(state, upd)
        reg.observe(step, state)
    reg.fetch()
    om = OM[side]
    hist = om.Histogram("serve/ttft_hist_ms", om.DEFAULT_LATENCY_BUCKETS_MS,
                        unit="ms", help='TTFT "distribution"\nper request')
    for v in (0.5, 2.5, 2.5, 40.0, 1e6):
        hist.observe(v)
    lat = om.Histogram("lat_ms", (1.0, 5.0, 25.0), unit="ms")
    board = {"serve/kv_wire": "int8", "serve/num_pages": 64,
             "serve/ttft_ms": 999.0, "analysis/peak_hbm_bytes": 4096,
             "x/nan": float("nan"), "x/inf": float("-inf")}
    return om.render([reg], [hist, lat], board)


def test_render_is_the_references_byte_for_byte():
    text = _exposition("port")
    assert text == _exposition("jax")
    assert text.endswith("# EOF\n")
    assert pom.parse_exposition(text) == jom.parse_exposition(text)
    fams = pom.parse_exposition(text)
    assert fams["apex_tpu_serve_completed"]["value"] == 4.0
    assert fams["apex_tpu_serve_ttft_ms"]["value"] == float(np.float32(0.1))


def test_parser_rejects_as_the_reference():
    bad = ("apex_tpu_x 1\n", "apex_tpu_x 1\n# EOF\n",
           "# TYPE apex_tpu_c counter\napex_tpu_c 1\n# EOF\n",
           "# TYPE x gauge\n# UNIT x ms\nx 1\n# EOF\n",
           '# TYPE h histogram\nh_bucket{le="1"} 1\n# EOF\n')
    for text in bad:
        got = _outcome(pom.parse_exposition, text)
        assert got[0] == "raised"
        assert got == _outcome(jom.parse_exposition, text)


def test_ops_server_serves_the_exposition_on_localhost():
    reg = _registry("port")
    reg.observe(0, reg.update(reg.init(), UPDATES[0]))
    reg.fetch()
    srv = pom.OpsServer(registries=[reg], port=0, host="127.0.0.1").start()
    try:
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            body = resp.read().decode()
            ctype = resp.headers["Content-Type"]
    finally:
        srv.stop()
    assert ctype == pom.CONTENT_TYPE
    fams = pom.parse_exposition(body)
    assert fams["apex_tpu_serve_completed"]["value"] == 1.0
    assert pmetrics.board.get("ops/scrapes") == 1


def test_ops_port_from_env_matches(monkeypatch):
    for spec in (None, "", " 0 ", "9100"):
        if spec is None:
            monkeypatch.delenv("APEX_TPU_OPS_PORT", raising=False)
        else:
            monkeypatch.setenv("APEX_TPU_OPS_PORT", spec)
        assert pom.ops_port_from_env() == jom.ops_port_from_env()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

#: request-event sequences (rid, state, t, args) of tests/test_spans.py
EVENT_RUNS = {
    "full_chain": [(5, "queued", 1.0, {"prompt_tokens": 4}),
                   (5, "prefill", 2.0, {"bucket": 8}),
                   (5, "decode", 3.0, {"ttft_ms": 2000.0}),
                   (5, "done", 4.0, {"tokens": 3})],
    "shed_from_queue": [(1, "queued", 1.0, {}),
                        (1, "shed", 2.0, {"reason": "deadline"})],
    "out_of_order": [(1, "decode", 1.0, {}), (1, "queued", 1.0, {}),
                     (1, "decode", 2.0, {}), (1, "prefill", 2.0, {}),
                     (1, "done", 3.0, {}), (1, "done", 4.0, {})],
    "backwards": [(1, "queued", 5.0, {}), (1, "prefill", 4.0, {})],
    "decode_retry": [(9, "queued", 1.0, {}), (9, "prefill", 2.0, {}),
                     (9, "decode", 3.0, {}),
                     (9, "retrying", 4.0, {"cause": "engine:Boom",
                                           "attempt": 1}),
                     (9, "decode", 5.0, {"resumed": True}),
                     (9, "done", 6.0, {"tokens": 4})],
    "prefill_retry": [(3, "queued", 1.0, {}), (3, "prefill", 2.0, {}),
                      (3, "retrying", 3.0, {"cause": "prefill:Boom"}),
                      (3, "prefill", 4.0, {"attempt": 1}),
                      (3, "decode", 5.0, {}), (3, "done", 6.0, {})],
    "illegal_recovery": [(6, "queued", 1.0, {}), (6, "prefill", 2.0, {}),
                         (6, "retrying", 3.0, {}), (6, "done", 4.0, {}),
                         (6, "shed", 4.0, {"reason": "retries_exhausted"}),
                         (6, "decode", 5.0, {}), (8, "queued", 1.0, {}),
                         (8, "retrying", 2.0, {})],
    "routed": [(9, "routed", 1.0, {"replica": "r0"}),
               (9, "queued", 1.0, {}),
               (9, "routed", 2.0, {"replica": "r1"}),
               (9, "queued", 2.5, {}), (9, "prefill", 3.0, {}),
               (9, "routed", 3.5, {}), (9, "decode", 4.0, {}),
               (9, "done", 5.0, {})],
}


@pytest.mark.parametrize("run", sorted(EVENT_RUNS))
def test_request_state_machine_matches(run):
    out = {}
    for side in BOTH:
        rec = SPANS[side].SpanRecorder(capacity=64)
        outcomes = [_outcome(rec.request_event, rid, st, t, **args)
                    for rid, st, t, args in EVENT_RUNS[run]]
        out[side] = (outcomes, rec.snapshot(), rec.open_requests,
                     rec.dropped)
    assert out["port"] == out["jax"]


def test_span_vocabulary_and_observer_bridge_match(tmp_path):
    names = ("TRACK_REQUESTS", "TRACK_ENGINE", "TRACK_TRAIN", "TRACK_HEALTH",
             "TRACK_TRACE", "REQ_QUEUED", "REQ_ROUTED", "REQ_PREFILL",
             "REQ_DECODE", "REQ_RETRYING", "REQ_DONE", "REQ_SHED",
             "REQ_TERMINAL", "ENV_SPANS", "DEFAULT_CAPACITY")
    for name in names:
        assert getattr(pspans, name) == getattr(jspans, name), name
    out = {}
    for side in BOTH:
        clock = iter(np.arange(100, dtype=np.float64) * 0.5)
        rec = SPANS[side].SpanRecorder(capacity=16,
                                       clock=lambda: float(next(clock)))
        for step in (0, 1, 2, 1, 2):
            rec.on_step(step, skipped=step == 2)
        rec.on_rollback(2, 0, skips=3, discarded=1)
        rec.on_resume(1)
        rec.on_preempt(2)
        rec.on_retry("save", 1, OSError("disk"))
        rec.on_checkpoint(2)
        rec.on_checkpoint(4, {"phase": "write", "t0": 1.0, "t1": 2.0,
                              "snapshot_t0": 0.5, "snapshot_t1": 0.75})
        rec.on_checkpoint(4, {"phase": "finalize", "t0": 3.0, "t1": 3.5})
        rec.span("engine/decode", 1.0, 2.0, track="serve/engine", iter=3)
        out[side] = rec.snapshot()
        path = rec.dump(reason="unit", path=str(tmp_path / f"{side}.json"))
        data = json.load(open(path))
        for key in ("anchor",):
            data.pop(key)
        out[side + "_dump"] = data
    assert out["port"] == out["jax"]
    assert out["port_dump"] == out["jax_dump"]
    assert pspans.parse_spans_spec("8:d") == jspans.parse_spans_spec("8:d")
    assert (_outcome(pspans.parse_spans_spec, "x")
            == _outcome(jspans.parse_spans_spec, "x"))


def test_scheduler_span_chains_match_under_faults(monkeypatch):
    """A scheduler run under a decode raise, a poisoned decode, a prefill
    raise and a clamp records the same span chains (names, states,
    lanes, args and the fake clock's times, in order) on both sides."""
    import types

    import jax
    import jax.numpy as jnp

    import apex_tpu.serve as jserve
    import apex_tpu.serve.engine as jengine_mod
    from apex_tpu.models.gpt import GptConfig as JaxGptConfig
    from apex_tpu.models.gpt import GptModel as JaxGptModel
    from apex_tpu.resilience import chaos as jchaos
    import apex_tpu_torch.serve as pserve
    import apex_tpu_torch.serve.engine as pengine_mod
    from apex_tpu_torch.models import GptConfig, from_jax_params
    from apex_tpu_torch.resilience import chaos as pchaos

    dims = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                intermediate_size=128, max_seq_len=128)
    jcfg = JaxGptConfig(**dims, dtype=jnp.float32)
    params = JaxGptModel(jcfg).init(jax.random.PRNGKey(0),
                                    jnp.zeros((8, 1), jnp.int32))
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                            GptConfig(**dims, dtype=torch.float32),
                            device="cpu")
    serve_kw = dict(page_size=8, num_pages=17, max_batch=2,
                    max_pages_per_seq=8)
    spec = ("serve.decode:raise:x1@2;serve.decode:nan:x1@5;"
            "serve.prefill:raise:x1@3")
    out = {}
    for side in BOTH:
        t = [0.0]

        def clock(t=t):
            t[0] += 1e-4
            return t[0]

        def sleep(dt, t=t):
            t[0] += dt

        if side == "jax":
            serve, chaos, engine_mod = jserve, jchaos, jengine_mod
            eng = serve.InferenceEngine(
                jcfg, params, serve.ServeConfig(verify=False, **serve_kw))
        else:
            serve, chaos, engine_mod = pserve, pchaos, pengine_mod
            eng = serve.InferenceEngine(
                model.cfg, model, serve.ServeConfig(**serve_kw),
                device="cpu")
        monkeypatch.setattr(engine_mod, "time",
                            types.SimpleNamespace(sleep=sleep))
        rec = SPANS[side].SpanRecorder(capacity=4096)
        sched = serve.ContinuousBatchingScheduler(
            eng, registry=None, spans=rec, clock=clock,
            clamp_max_new_tokens=3, clamp_occupancy=0.1)
        rs = np.random.RandomState(3)
        with chaos.inject(*chaos.parse_spec(spec)[0]):
            for i in range(5):
                sched.submit(serve.Request(
                    prompt=[int(x) for x in rs.randint(0, 64, size=12)],
                    max_new_tokens=6, rid=f"r{i}"))
            sched.run()
        out[side] = (rec.snapshot(), rec.open_requests)
    assert out["port"] == out["jax"]
    names = [e["name"] for e in out["port"][0]]
    for name in ("req/retrying", "req/shed", "req/clamped", "engine/decode",
                 "engine/prefill", "req/admitted"):
        assert name in names, name
    assert out["port"][1] == {}


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

#: wall-clock and per-process fields of a flight dump
WALL = ("t", "wall_time", "anchor")


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in WALL}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def test_flight_dumps_match_apart_from_wall_clock(tmp_path):
    out = {}
    for side in BOTH:
        reg = _registry(side, fetch_every=2)
        state = reg.init()
        BOARD[side].set("serve/kv_wire", "int8")
        BOARD[side].set("goodput/ckpt/stall_frac", 0.02)
        rec = FLIGHT[side].FlightRecorder(
            capacity=3, directory=str(tmp_path / side), registry=reg,
            run={"model": "gpt"})
        for step in (0, 1, 2, 3, 2, 3, 4):
            state = reg.update(state, {"serve/completed": 1,
                                       "serve/ttft_ms": float(step)})
            reg.observe(step, state)
            rec.on_step(step, skipped=step == 3)
        rec.on_rollback(3, 1, skips=2, discarded=1)
        rec.on_resume(2)
        rec.on_preempt(4)
        rec.on_retry("save", 2, OSError("disk full"))
        rec.on_checkpoint(4)
        rec.on_checkpoint(4, {"phase": "write", "ok": True, "t0": 1.0,
                              "t1": 2.5})
        rec.note_health(OBS[side].HealthEvent(
            "ttft", "critical", 4, float("nan"), 1000.0, "over", None))
        state = reg.update(state, {"train/loss_min": float("-inf")})
        reg.observe(5, state)
        path = rec.dump("unit test")
        assert os.path.dirname(path) == str(tmp_path / side)
        assert not [p for p in os.listdir(tmp_path / side)
                    if p.endswith(".tmp")]
        out[side] = _strip(json.load(open(path)))
        assert out[side]["final"]["metrics"]["train/loss_min"] == "-Infinity"
    assert out["port"] == out["jax"]
    for spec in ("8", "8:/d", " 0 ", "x", "-1"):
        assert (_outcome(pflight.parse_flight_spec, spec)
                == _outcome(jflight.parse_flight_spec, spec))
    weird = {"a": [1.0, float("nan"), (2, float("inf"))], 3: None,
             "t": np.float32(0.5), "o": object}
    assert pflight.json_safe(weird)["a"] == jflight.json_safe(weird)["a"]
    assert pflight.json_safe(weird)["t"] == jflight.json_safe(weird)["t"]


# ---------------------------------------------------------------------------
# the serving health rules
# ---------------------------------------------------------------------------


def _watch(side, rules_kw, sequence, rules=None, clock_steps=None):
    """Feed ``sequence`` (per step: registry values) through a serve
    registry and a Watchdog checking every step; the events."""
    from apex_tpu.serve import declare_serve_metrics as jdeclare
    from apex_tpu_torch.serve import declare_serve_metrics as pdeclare

    obs = OBS[side]
    reg = obs.MetricRegistry(fetch_every=1)
    (jdeclare if side == "jax" else pdeclare)(reg)
    state = reg.init()
    ticks = iter(clock_steps or [float(i) for i in range(10_000)])
    wd = obs.Watchdog(rules if rules is not None
                      else obs.serve_rules(**rules_kw),
                      registry=reg, check_every=1,
                      clock=lambda: next(ticks))
    for step, vals in enumerate(sequence):
        if vals is not None:
            state = reg.update(state, vals)
            reg.observe(step, state)
        wd.on_step(step)
    board = {k: v for k, v in BOARD[side].snapshot().items()
             if k.startswith("health/")}
    return [tuple(e) for e in wd.events], board


SEQUENCES = {
    "ttft_escalates": ({"ttft": {"deadline_ms": 1000.0}},
                       [{"serve/ttft_ms": 2500.0}, {"serve/ttft_ms": 1500.0},
                        None, {"serve/ttft_ms": 100.0}]),
    "ttft_quiet": ({"ttft": {"deadline_ms": 5000.0}},
                   [{"serve/ttft_ms": 100.0}] * 3),
    "queue_depth": ({"queue_depth": {"max_depth": 16, "cooldown": 2}},
                    [{"serve/queue_depth": d} for d in (4, 40, 41, 50, 3)]),
    "queue_wait_fraction": (
        {"queue_wait_fraction": {"max_fraction": 0.5}},
        [{"serve/ttft_queue_wait_fraction": f} for f in (0.2, 0.7, 0.7)]),
    "spec_acceptance": ({"spec_acceptance": {"min_rate": 0.5}},
                        [{"serve/spec_rounds": 8.0,
                          "serve/spec_accept_rate": 0.2}] * 2),
    "spec_never_ran": ({"spec_acceptance": {"min_rate": 0.5}},
                       [{}] * 3),
    "serve_faults": ({}, [{"serve/engine_faults": 1.0},
                          {"serve/shed_poisoned": 1.0,
                           "serve/shed": 1.0},
                          {"serve/decode_timeouts": 2.0,
                           "serve/engine_rebuilds": 1.0},
                          {}, {"serve/kv_alloc_faults": 1.0,
                               "serve/admission_faults": 3.0,
                               "serve/shed_retries_exhausted": 1.0}]),
    "stale_fetch": ({"stale_fetch": {"max_age_steps": 2}},
                    [{"serve/queue_depth": 1.0}, None, None, None, None]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_serve_rules_fire_as_the_reference(name):
    kw, seq = SEQUENCES[name]
    out = {side: _watch(side, kw, seq) for side in BOTH}
    assert out["port"] == out["jax"]
    if name not in ("ttft_quiet", "spec_never_ran"):
        assert out["port"][0], name


def test_hung_step_rule_matches():
    from apex_tpu.observability import health as jhealth
    from apex_tpu_torch.observability import health as phealth

    out = {}
    for side, health in (("jax", jhealth), ("port", phealth)):
        rule = health.HungStepRule(deadline_s=10.0)
        out[side] = _watch(side, {}, [{}] * 4, rules=[rule],
                           clock_steps=[0.0, 1.0, 30.0, 31.0, 100.0])
    assert out["port"] == out["jax"] and out["port"][0]


def test_serve_rules_rejects_unknown_as_the_reference():
    assert (_outcome(pobs.serve_rules, mfu_floor={})
            == _outcome(jobs.serve_rules, mfu_floor={}))
    assert ([type(r).__name__ for r in pobs.serve_rules()]
            == [type(r).__name__ for r in jobs.serve_rules()])


def test_watchdog_emits_to_flight_and_spans(tmp_path):
    fl = pflight.FlightRecorder(capacity=4, directory=str(tmp_path))
    sp = pspans.SpanRecorder(capacity=16)
    seen = []
    reg = pmetrics.MetricRegistry(fetch_every=1)
    reg.gauge("serve/queue_depth")
    reg.observe(0, reg.update(reg.init(), {"serve/queue_depth": 99}))
    reg.fetch()
    wd = pobs.Watchdog([pobs.QueueDepthRule(max_depth=4)], registry=reg,
                       flight=fl, spans=sp, on_unhealthy=seen.append,
                       check_every=1)
    wd.on_step(1)
    assert [e.rule for e in seen] == ["queue_depth"]
    assert fl.events[0]["kind"] == "health"
    assert sp.snapshot()[0]["name"] == "health/queue_depth"
    assert pmetrics.board.get("health/queue_depth") == 99.0


# ---------------------------------------------------------------------------
# the board's consumers
# ---------------------------------------------------------------------------


def test_prefetcher_publishes_the_stall_fraction_as_the_reference():
    from apex_tpu.data import DevicePrefetcher as JaxPrefetcher
    from apex_tpu_torch.data import DevicePrefetcher

    batches = [np.full((4,), i, np.float32) for i in range(12)]
    out = {}
    for side, cls, kw in (("jax", JaxPrefetcher, {}),
                          ("port", DevicePrefetcher, {"device": "cpu"})):
        seen = []
        with cls(iter(batches), depth=2, **kw) as pf:
            for _ in pf:
                seen.append(BOARD[side].get("data/input_stall_fraction"))
            frac = pf.stall_fraction
        out[side] = [v is not None for v in seen]
        assert 0.0 <= BOARD[side].get("data/input_stall_fraction") <= 1.0
        assert 0.0 <= frac <= 1.0
        BOARD[side].clear()
        with cls(iter(batches), depth=2, board_key=None, **kw) as pf:
            list(pf)
        assert BOARD[side].snapshot() == {}
    assert out["port"] == out["jax"]
    assert out["port"] == [False] * 7 + [True] * 5


def test_checkpoint_engine_publishes_its_gauges_as_the_reference(tmp_path):
    from apex_tpu.goodput import AsyncCheckpointEngine as JaxEngine
    from apex_tpu_torch.goodput import AsyncCheckpointEngine

    keys = ("goodput/ckpt/saves", "goodput/ckpt/writes",
            "goodput/ckpt/failures", "goodput/ckpt/last_snapshot_ms",
            "goodput/ckpt/last_write_ms", "goodput/ckpt/stall_frac")
    out = {}
    for side, cls, state in (
            ("jax", JaxEngine, {"w": np.arange(8, dtype=np.float32)}),
            ("port", AsyncCheckpointEngine,
             {"w": torch.arange(8, dtype=torch.float32)})):
        eng = cls(str(tmp_path / side))
        try:
            eng.save(1, state)
            after_save = BOARD[side].get("goodput/ckpt/saves")
            eng.save(2, state)
            eng.wait_until_finished()
        finally:
            eng.close()
        snap = BOARD[side].snapshot()
        assert set(keys) <= set(snap), side
        out[side] = (after_save, [snap[k] for k in keys[:3]])
        assert snap["goodput/ckpt/last_write_ms"] > 0.0
    assert out["port"] == out["jax"] == (1.0, [2.0, 2.0, 0.0])


def test_lock_cycle_publishes_the_gauge_as_the_reference():
    for side, locks in (("jax", jlocks), ("port", plocks)):
        locks.reset_sanitizer()
        locks.arm(True)
        try:
            a, b = locks.TrackedLock("a"), locks.TrackedLock("b")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with a:
                    with b:
                        pass
                with b:
                    with a:
                        pass
        finally:
            locks.arm(None)
            locks.reset_sanitizer()
        assert BOARD[side].get("locksan/cycles") == 1, side


def _resilient_run(side, tmp_path, spec, num_steps):
    """A toy step under ``run_resilient`` with the recorders armed from
    the environment; returns what the two dumps hold (wall clock
    stripped)."""
    import apex_tpu.resilience as jres
    import apex_tpu_torch.resilience as pres

    res = jres if side == "jax" else pres
    chaos = res.chaos

    def step_fn(state, batch):
        w = state["w"] + np.float32(1.0)
        if side == "port":
            w = torch.as_tensor(np.asarray(w))
        return {"w": w}, {"skipped": False}

    init = ({"w": np.zeros((), np.float32)} if side == "jax"
            else {"w": torch.zeros(())})
    faults = chaos.parse_spec(spec)[0] if spec else ()
    with chaos.inject(*faults), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = res.run_resilient(
            step_fn, init, lambda s: s, directory=tmp_path / side / "ckpt",
            num_steps=num_steps, save_interval_steps=2, checkpoint="sync",
            policy=res.RetryPolicy(max_attempts=2, backoff=0.0,
                                   sleep=lambda _: None))
    dumps = {}
    for kind in ("flight", "spans"):
        files = sorted((tmp_path / side / kind).glob(f"{kind}_*.json"))
        dumps[kind] = [_strip(json.load(open(f))) for f in files]
    for d in dumps["spans"]:
        for e in d["spans"]:
            e.pop("t0", None), e.pop("t1", None)
    return (result.preempted, result.last_step), dumps


@pytest.mark.parametrize("spec,steps", [("preemption@5", 8), (None, 4)])
def test_run_resilient_arms_recorders_from_the_environment(
        tmp_path, monkeypatch, spec, steps):
    handler = signal.getsignal(signal.SIGTERM)
    out = {}
    for side in BOTH:
        monkeypatch.setenv("APEX_TPU_FLIGHT", f"8:{tmp_path / side / 'flight'}")
        monkeypatch.setenv("APEX_TPU_SPANS", f"64:{tmp_path / side / 'spans'}")
        out[side] = _resilient_run(side, tmp_path, spec, steps)
    assert signal.getsignal(signal.SIGTERM) == handler
    assert out["port"] == out["jax"]
    (preempted, last), dumps = out["port"]
    if spec:
        assert preempted and len(dumps["flight"]) == 1
        assert dumps["flight"][0]["reason"].startswith("preemption")
        assert [e["kind"] for e in dumps["flight"][0]["events"]].count(
            "preempt") == 1
    else:
        # a good run dumps its timeline only (the flight box stays shut)
        assert not preempted and dumps["flight"] == []
        assert dumps["spans"][0]["reason"] == "completed"
    assert dumps["spans"] and any(e["name"] == "train/step"
                                  for e in dumps["spans"][0]["spans"])

"""apex_tpu_torch's SLOs and canary analysis vs the JAX package's.

Both modules are host code copied over, so every case of
``tests/test_slo.py`` and of ``tests/test_canary.py``'s statistics runs
on both packages and must give EXACTLY the same numbers: the burn rates
of a hand-checked window, the SLO sources, the multi-window rules' events
(through a ``Watchdog`` and its fan-out), ``burn_rate_drill``,
``mann_whitney_p`` and ``binom_tail`` over seeded samples, and the
analyzer's verdicts and checks.

Fingerprints: the port engine's golden probe (``probe_stream`` through
``model_fingerprint``) streams the JAX engine's greedy tokens for the
same weights (a tiny f32 GPT carried over by ``from_jax_params``; the JAX
engine with ``verify=False``).  Digests are not compared across packages
— they hash the prefill logits' bytes, which differ in the last bits by
construction — but within the port a rebuild keeps the digest bit for
bit, one flipped sign bit moves it, the restored weights restore it, and
NaN weights fingerprint as not finite.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.observability as jobs
from apex_tpu.models.gpt import GptConfig as JaxGptConfig
from apex_tpu.models.gpt import GptModel as JaxGptModel
from apex_tpu.observability import canary as JC
from apex_tpu.observability import ometrics as JOM
from apex_tpu.observability import slo as JS
from apex_tpu.serve import InferenceEngine as JaxEngine
from apex_tpu.serve import ServeConfig as JaxServeConfig
from apex_tpu_torch import observability as pobs
from apex_tpu_torch.models import GptConfig, from_jax_params
from apex_tpu_torch.observability import canary as PC
from apex_tpu_torch.observability import ometrics as POM
from apex_tpu_torch.observability import slo as PS
from apex_tpu_torch.serve import InferenceEngine, ServeConfig
from apex_tpu_torch.tools.canary_drill import corrupt_one_bit, nan_poison

SIDES = {"jax": (jobs, JS, JC, JOM), "port": (pobs, PS, PC, POM)}


@pytest.fixture(autouse=True)
def _clean_boards():
    jobs.board.clear()
    pobs.board.clear()
    yield
    jobs.board.clear()
    pobs.board.clear()


def _dump(x):
    return json.dumps(x, default=lambda o: tuple(o) if hasattr(
        o, "_fields") else repr(o), sort_keys=True)


# ---------------------------------------------------------------------------
# SLOs: the reference's cases on both packages
# ---------------------------------------------------------------------------


def _tracker(side):
    obs, S, _, _ = SIDES[side]
    out = []
    tr = S.BurnRateTracker(0.9, 600.0, min_interval_s=90.0)
    good = total = 0.0
    for half_minute in range(40):
        bad = 50.0 if 6 <= half_minute < 12 else 5.0
        good, total = good + 100.0 - bad, total + 100.0
        t = 30.0 * half_minute
        tr.observe(good, total, t)
        out.append([tr.burn_rate(w, now=t) for w in (60.0, 240.0, 600.0)])
    with pytest.raises(ValueError):
        S.BurnRateTracker(1.0, 60.0)
    return out + [tr.samples]


def _sources(side):
    obs, S, _, OM = SIDES[side]
    slo = S.CounterRatioSLO("goodput", 0.95,
                            good_keys=("serve/completed",),
                            total_keys=("serve/completed", "serve/shed"))
    h = OM.Histogram("serve/ttft_hist_ms", (10.0, 100.0), unit="ms")
    lat = S.LatencySLO("ttft", 0.9, histogram=h, threshold=10.0)
    before = lat.counts({})
    for v in (5.0, 50.0, 7.0, 500.0):
        h.observe(v)
    return [slo.counts({}), slo.counts({"serve/completed": 8.0,
                                        "serve/shed": 2.0}),
            slo.error_budget, before, lat.counts({})]


def _storm(side, window, error_rate, cooldown, minutes):
    obs, S, _, _ = SIDES[side]
    state = {"t": 0.0, "good": 0.0, "total": 0.0}
    rule = S.SLORule(
        S.CounterRatioSLO("t", 0.9, good_keys=("good",),
                          total_keys=("total",)),
        windows=(window(S),), cooldown=cooldown,
        values_fn=lambda: {"good": state["good"], "total": state["total"]},
        clock=lambda: state["t"])
    flight = obs.FlightRecorder(capacity=8)
    wd = obs.Watchdog([rule], flight=flight, check_every=1)
    fired = []
    for step in range(minutes):
        state["t"] = 60.0 * step
        fired += wd.check(step)
        rate = error_rate(step) if callable(error_rate) else error_rate
        state["good"] += 100.0 * (1.0 - rate)
        state["total"] += 100.0
    return fired + [obs.board.get("health/slo_t"),
                    [e["kind"] for e in flight.events]]


def _registry_slo(side):
    obs, S, _, _ = SIDES[side]
    reg = obs.MetricRegistry(fetch_every=1)
    reg.counter("serve/completed")
    reg.counter("serve/shed")
    t = {"now": 0.0}
    rule = S.SLORule(
        S.CounterRatioSLO("goodput", 0.9, good_keys=("serve/completed",),
                          total_keys=("serve/completed", "serve/shed")),
        windows=(S.Window(60.0, 240.0, 2.0, "critical"),),
        clock=lambda: t["now"])
    wd = obs.Watchdog(rules=[rule], registry=reg, check_every=1,
                      clock=lambda: t["now"])
    st = reg.init()
    for step in range(4):
        t["now"] = 60.0 * step
        st = reg.update(st, {"serve/shed": 60.0, "serve/completed": 40.0})
        reg.observe(step, st)
        reg.fetch()
        wd.on_step(step)
    return wd.events


def _serve_sets(side):
    obs, S, _, OM = SIDES[side]
    h = OM.Histogram("serve/ttft_hist_ms", (10.0, 100.0), unit="ms")
    dl = [r for r in S.serve_slo_rules() if r.name == "slo_deadline_shed"][0]
    return [[r.name for r in S.serve_slo_rules(ttft_histogram=h,
                                               ttft_threshold_ms=10.0)],
            [r.name for r in S.serve_slo_rules()],
            [r.name for r in S.fleet_slo_rules()],
            list(S.DEFAULT_WINDOWS),
            dl.slo.counts({"serve/completed": 90.0, "serve/shed": 10.0,
                           "serve/shed_growth_victim": 10.0}),
            dl.slo.counts({"serve/completed": 90.0, "serve/shed": 10.0}),
            S.burn_rate_drill(), S.burn_rate_drill()]


SLO_CASES = {
    "tracker": _tracker,
    "sources": _sources,
    "fires_when_both_hot": lambda s: _storm(
        s, lambda S: S.Window(60.0, 240.0, 2.0, "critical"), 0.5, 64, 3),
    "quiet_under_budget": lambda s: _storm(
        s, lambda S: S.Window(60.0, 240.0, 2.0, "critical"), 0.01, 64, 6),
    "short_blip": lambda s: _storm(
        s, lambda S: S.Window(60.0, 600.0, 4.0, "critical"),
        lambda m: 1.0 if m == 5 else 0.0, 64, 11),
    "cooldown_heartbeat": lambda s: _storm(
        s, lambda S: S.Window(60.0, 240.0, 2.0, "critical"), 0.5, 2, 7),
    "registry": _registry_slo,
    "serve_sets": _serve_sets,
}


@pytest.mark.parametrize("name", sorted(SLO_CASES))
def test_slo_case_equals_the_reference(name):
    got, want = SLO_CASES[name]("port"), SLO_CASES[name]("jax")
    assert _dump(got) == _dump(want)
    if name == "fires_when_both_hot":
        ev = got[0]
        assert ev.rule == "slo_t" and ev.value == pytest.approx(5.0)
        assert got[-2] == pytest.approx(5.0) and "health" in got[-1]
    if name == "cooldown_heartbeat":
        assert len(got) - 2 == 3
    if name in ("quiet_under_budget", "short_blip"):
        assert len(got) == 2
    if name == "serve_sets":
        assert got[-2:] == [1, 1]


def test_window_validation_equals_the_reference():
    for S in (JS, PS):
        slo = S.CounterRatioSLO("x", 0.9, good_keys=("a",),
                                total_keys=("a",))
        with pytest.raises(ValueError):
            S.SLORule(slo, windows=())
        with pytest.raises(ValueError):
            S.SLORule(slo, windows=(S.Window(600.0, 60.0, 2.0),))
        with pytest.raises(ValueError):
            S.CounterRatioSLO("x", 1.5, good_keys=("a",), total_keys=("a",))


# ---------------------------------------------------------------------------
# the statistics and the analyzer, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("worse", ["greater", "less"])
def test_mann_whitney_equals_the_reference(seed, worse):
    rs = np.random.RandomState(seed)
    a = list(rs.normal(10.0 + 0.3 * seed, 2.0, size=20 + seed))
    b = list(np.round(rs.normal(10.0, 2.0, size=60), 1))
    assert PC.mann_whitney_p(a, b, worse=worse) == \
        JC.mann_whitney_p(a, b, worse=worse)
    assert PC.mann_whitney_p([1.0] * 5, [1.0] * 9) == 1.0
    with pytest.raises(ValueError):
        PC.mann_whitney_p(a, b, worse="sideways")


@pytest.mark.parametrize("k,n,p", [(0, 10, 0.1), (3, 10, 0.02),
                                   (9, 12, 0.5), (40, 200, 0.1),
                                   (7, 7, 0.3), (1, 1000, 1e-4)])
def test_binom_tail_equals_the_reference(k, n, p):
    assert PC.binom_tail(k, n, p) == JC.binom_tail(k, n, p)


def _analyzer(C, seed):
    rs = np.random.RandomState(seed)
    an = C.CanaryAnalyzer(min_samples=16, alpha=1e-3, min_events=4,
                          min_event_total=8)
    shift = 10.0 if seed % 3 == 0 else 0.0
    an.add_samples("canary", "ttft_ms", rs.normal(10.0 + shift, 3.0, 48))
    an.add_samples("incumbent", "ttft_ms", rs.normal(10.0, 3.0, 160))
    an.add_samples("canary", "tokens_per_slot_tick",
                   rs.poisson(3.0, size=48).astype(float), worse="less")
    an.add_samples("incumbent", "tokens_per_slot_tick",
                   rs.poisson(3.0, size=160).astype(float), worse="less")
    an.add_events("canary", "shed_poisoned", 9 if seed % 3 == 1 else 0, 40)
    an.add_events("incumbent", "shed_poisoned", 0, 160)
    an.add_events("canary", "shed_deadline", 3, 10)
    an.add_events("incumbent", "shed_deadline", 0, 500)
    return an.verdict()


@pytest.mark.parametrize("seed", range(6))
def test_analyzer_verdicts_equal_the_reference(seed):
    got, want = _analyzer(PC, seed), _analyzer(JC, seed)
    assert _dump(got) == _dump(want)
    assert got.status == ("pass" if seed % 3 == 2 else "fail")
    assert PC.CanaryAnalyzer().verdict().status == "no_verdict"


def test_probe_sets_equal_the_reference():
    for kw in (dict(n_probes=3, prompt_len=5, max_new_tokens=4, seed=11),
               dict()):
        a = PC.GoldenProbeSet.generate(64, **kw)
        b = JC.GoldenProbeSet.generate(64, **kw)
        assert a == PC.GoldenProbeSet(b.prompts, b.max_new_tokens)
        assert a.total_tokens() == b.total_tokens()
    assert PC.DRIFT_SHED_REASONS == JC.DRIFT_SHED_REASONS


# ---------------------------------------------------------------------------
# fingerprints through the engines
# ---------------------------------------------------------------------------

DIMS = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_seq_len=128)
SERVE = dict(page_size=8, num_pages=32, max_batch=2, max_pages_per_seq=8)
PROBES = dict(n_probes=2, prompt_len=6, max_new_tokens=4)


@pytest.fixture(scope="module")
def engines():
    jcfg = JaxGptConfig(**DIMS, dtype=jnp.float32)
    params = JaxGptModel(jcfg).init(jax.random.PRNGKey(0),
                                    jnp.zeros((8, 1), jnp.int32))
    cfg = GptConfig(**DIMS, dtype=torch.float32)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    jeng = JaxEngine(jcfg, params, JaxServeConfig(**SERVE, verify=False),
                     registry=jobs.MetricRegistry(fetch_every=1)).build()
    peng = InferenceEngine(cfg, model, ServeConfig(**SERVE),
                           registry=pobs.MetricRegistry(fetch_every=1),
                           device="cpu").build()
    return jeng, peng, model


def test_fingerprint_streams_equal_the_jax_engines(engines):
    jeng, peng, _ = engines
    probes = PC.GoldenProbeSet.generate(64, **PROBES)
    jprobes = JC.GoldenProbeSet.generate(64, **PROBES)
    got = PC.model_fingerprint(peng, probes)
    want = JC.model_fingerprint(jeng, jprobes)
    assert got["streams"] == want["streams"]
    assert got["tokens"] == want["tokens"] == 8
    assert got["finite"] and want["finite"]
    # the distance reads streams: equal streams under differing digests
    # are the smallest nonzero distance, as in the reference
    d = PC.fingerprint_distance(got, want)
    assert d["streams_differing"] == 0
    assert d["distance"] == JC.fingerprint_distance(
        {**want, "digest": got["digest"]}, want)["distance"]


def test_fingerprint_identity_within_the_port(engines):
    _, peng, model = engines
    probes = PC.GoldenProbeSet.generate(64, **PROBES)
    fp_a = PC.model_fingerprint(peng, probes)
    assert peng.pool.in_use == 0
    peng.rebuild(full=True)
    fp_b = PC.model_fingerprint(peng, probes)
    assert fp_a["digest"] == fp_b["digest"]
    old = peng.weights
    peng.swap_weights(corrupt_one_bit(model))
    assert peng.weights is not old
    fp_bit = PC.model_fingerprint(peng, probes)
    assert fp_bit["digest"] != fp_a["digest"]
    assert PC.fingerprint_distance(fp_a, fp_bit)["distance"] > 0.0
    peng.swap_weights(old)  # the prepared incumbent, adopted as it is
    assert peng.weights is old
    assert PC.model_fingerprint(peng, probes)["digest"] == fp_a["digest"]
    peng.swap_weights(model)  # prepared anew: the same bits
    assert PC.model_fingerprint(peng, probes)["digest"] == fp_a["digest"]
    peng.swap_weights(nan_poison(model))
    assert not PC.model_fingerprint(peng, probes)["finite"]
    peng.swap_weights(old)
    with pytest.raises(ValueError):
        peng.swap_weights(object())

"""apex_tpu_torch's serving robustness vs the JAX package's.

Every scenario of ``tests/test_serve.py``'s ``TestServeResilience``,
``TestEngineRecovery`` and its speculative-decoding fault tests (the
draft's chaos site, the acceptance fallback), plus the prefix cache's
eviction drill and the engine's golden probe (``probe_stream``), runs as
one parametrised case on both packages: the same
tiny f32 GPT (vocab 128, hidden 64, 2 layers, 4 heads; JAX's
``GptModel.init`` carried into the port with ``from_jax_params``), the
same ``ServeConfig`` (the JAX one with ``verify=False``), the same
chaos faults (each package's own ``chaos`` module, fed the same
``Fault``s), a ``FakeClock`` per side that also stands in for the chaos
gate's ``time.sleep`` (so a stall is seen by the decode timeouts and
nothing else is), and a ``MetricRegistry(fetch_every=1)`` per side.

Each case's ledger — every request's terminal status, shed reason,
retry count, clamp, greedy tokens and TTFT components, the scheduler's
registry values (every ``declare_serve_metrics`` counter and gauge) and
the engine's rebuild count — must be EQUAL on both sides (exactly; the
clock's readings are the same numbers on both), and the reference
test's own claims are asserted on it.  The engine-level cases hold f32
logits to 1e-4, as ``test_torch_serve.py`` does.

The port's chaos drill at the reference drill's defaults
(``apex_tpu_torch.tools.serve_chaos_drill``) gives the reference
drill's artifact ledger (``tools/serve_chaos_drill.py``, imported from
its path) value for value.
"""

import dataclasses
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.observability as jax_obs
import apex_tpu.serve as jax_serve
import apex_tpu.serve.engine as jax_engine_mod
from apex_tpu.models.gpt import GptConfig as JaxGptConfig
from apex_tpu.models.gpt import GptModel as JaxGptModel
from apex_tpu.resilience import chaos as jax_chaos
from apex_tpu_torch import observability as port_obs
from apex_tpu_torch import serve as port_serve
from apex_tpu_torch.models import GptConfig, from_jax_params
from apex_tpu_torch.resilience import chaos as port_chaos
from apex_tpu_torch.serve import engine as port_engine_mod

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
DIMS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_seq_len=128)
#: the reference scenarios' engine
SERVE = dict(page_size=8, num_pages=32, max_batch=2, max_pages_per_seq=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs several workers
    at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxGptConfig(**DIMS, dtype=jnp.float32)
    params = JaxGptModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((8, 1), jnp.int32))
    cfg = GptConfig(**DIMS, dtype=torch.float32)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, params, cfg, model


class FakeClock:
    """Every read advances a hair (monotonic); ``sleep`` advances by the
    stall instead of sleeping."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-4
        return self.t

    def advance(self, dt):
        self.t += dt

    def sleep(self, dt):
        self.t += dt


class Side:
    """One package's serving stack behind one interface."""

    def __init__(self, kind, models, monkeypatch):
        self.kind = kind
        self.jcfg, self.params, self.cfg, self.model = models
        self.clock = FakeClock()
        if kind == "jax":
            self.serve, self.obs, self.chaos = jax_serve, jax_obs, jax_chaos
            engine_mod = jax_engine_mod
        else:
            self.serve, self.obs = port_serve, port_obs
            self.chaos, engine_mod = port_chaos, port_engine_mod
        # the chaos gates' stall advances this side's clock
        monkeypatch.setattr(engine_mod, "time",
                            types.SimpleNamespace(sleep=self.clock.sleep))

    def engine(self, spec=None, **kw):
        serve = dict(SERVE, **kw)
        if self.kind == "jax":
            return self.serve.InferenceEngine(
                self.jcfg, self.params,
                self.serve.ServeConfig(verify=False, **serve), spec=spec)
        return self.serve.InferenceEngine(
            self.cfg, self.model, self.serve.ServeConfig(**serve),
            spec=spec, device="cpu")

    def spec(self, draft_layers=None, **kw):
        """A SpecConfig: a self-draft, or the target's first layers."""
        if draft_layers is None:
            return self.serve.SpecConfig(None, **kw)
        if self.kind == "jax":
            return self.serve.SpecConfig(
                self.serve.draft_from_params(self.params, draft_layers),
                draft_cfg=dataclasses.replace(self.jcfg,
                                              num_layers=draft_layers),
                **kw)
        return self.serve.SpecConfig(
            self.serve.draft_from_params(self.model, draft_layers), **kw)

    def registry(self):
        return self.obs.MetricRegistry(fetch_every=1)

    def sched(self, eng, registry=None, **kw):
        return self.serve.ContinuousBatchingScheduler(
            eng, registry=registry, clock=self.clock, **kw)

    def request(self, prompt, **kw):
        return self.serve.Request(prompt=list(prompt), **kw)

    def fault(self, site, steps, mode, max_hits=None):
        return self.chaos.Fault(getattr(self.chaos, site), steps=tuple(steps),
                                mode=mode, max_hits=max_hits)

    def inject(self, *faults):
        return self.chaos.inject(*faults)


def _prompt(rs, n):
    return [int(t) for t in rs.randint(0, 64, size=n)]


def ledger(reqs):
    """What a request's life left behind, comparable across packages."""
    return [dict(status=r.status, reason=r.shed_reason, retries=r.retries,
                 tokens=[int(t) for t in r.tokens],
                 clamped_from=r.clamped_from, max_new=r.max_new_tokens,
                 pages=len(r.pages), ttft=r.ttft_components())
            for r in reqs]


def values(reg):
    reg.fetch()
    return reg.values()


# ---------------------------------------------------------------------------
# the scenarios: each returns its ledger; CLAIMS holds the reference test's
# assertions on it
# ---------------------------------------------------------------------------


def decode_fault_retries_preserve_prefix(s):
    rs = np.random.RandomState(20)
    prompts = [_prompt(rs, 6) for _ in range(2)]

    def run(faults):
        eng, reg = s.engine(), s.registry()
        sched = s.sched(eng, reg)
        with s.inject(*faults):
            reqs = [sched.submit(s.request(p, max_new_tokens=6))
                    for p in prompts]
            sched.run()
        return dict(reqs=ledger(reqs), values=values(reg),
                    rebuilds=eng.rebuilds, pool=sched.pool.in_use,
                    leak_checks=sched.leak_checks_run)

    return dict(clean=run(()), faulted=run(
        (s.fault("SERVE_DECODE", (2,), "raise", max_hits=1),)))


def persistent_decode_fault_exhausts_rebuild_limit(s):
    eng, reg = s.engine(), s.registry()
    sched = s.sched(eng, reg, rebuild_limit=1)
    rs = np.random.RandomState(21)
    with s.inject(s.fault("SERVE_DECODE", range(64), "raise")):
        req = sched.submit(s.request(_prompt(rs, 6), max_new_tokens=4))
        with pytest.raises(RuntimeError, match="rebuild_limit") as err:
            sched.run()
    return dict(error=str(err.value), reqs=ledger([req]),
                values=values(reg), rebuilds=eng.rebuilds)


def prefill_fault_retried_then_shed_when_persistent(s):
    rs = np.random.RandomState(22)
    eng, reg = s.engine(), s.registry()
    sched = s.sched(eng, reg)
    with s.inject(s.fault("SERVE_PREFILL", (0,), "raise", max_hits=1)):
        req = sched.submit(s.request(_prompt(rs, 6), max_new_tokens=2))
        sched.run()
    eng2, reg2 = s.engine(), s.registry()
    sched2 = s.sched(eng2, reg2, max_retries=2)
    with s.inject(s.fault("SERVE_PREFILL", range(16), "raise")):
        req2 = sched2.submit(s.request(_prompt(rs, 6)))
        sched2.run()
    return dict(transient=ledger([req]), values=values(reg),
                persistent=ledger([req2]), values2=values(reg2),
                pool2=sched2.pool.in_use)


def poisoned_decode_evicts_only_offending_slot(s):
    eng, reg = s.engine(), s.registry()
    sched = s.sched(eng, reg)
    rs = np.random.RandomState(23)
    reqs = [sched.submit(s.request(_prompt(rs, 6), max_new_tokens=8))
            for _ in range(2)]
    with s.inject(s.fault("SERVE_DECODE", (1,), "nan", max_hits=1)):
        sched.run()
    return dict(reqs=ledger(reqs), values=values(reg), pool=sched.pool.in_use)


def poisoned_prefill_quarantined_at_first_token(s):
    eng, reg = s.engine(), s.registry()
    sched = s.sched(eng, reg)
    rs = np.random.RandomState(24)
    with s.inject(s.fault("SERVE_PREFILL", (0,), "nan", max_hits=1)):
        req = sched.submit(s.request(_prompt(rs, 6)))
        sched.run()
    return dict(reqs=ledger([req]), values=values(reg), pool=sched.pool.in_use)


def decode_timeout_is_per_request(s):
    eng, reg = s.engine(), s.registry()
    sched = s.sched(eng, reg, max_retries=8)
    rs = np.random.RandomState(25)
    reqs = [sched.submit(s.request(_prompt(rs, 6), max_new_tokens=4,
                                   decode_timeout_ms=20.0)),
            sched.submit(s.request(_prompt(rs, 6), max_new_tokens=4))]
    with s.inject(s.fault("SERVE_DECODE", (1,), "stall", max_hits=1)):
        sched.run()
    return dict(reqs=ledger(reqs), values=values(reg))


def admission_fault_is_transient(s):
    eng, reg = s.engine(), s.registry()
    sched = s.sched(eng, reg)
    rs = np.random.RandomState(26)
    with s.inject(s.fault("SERVE_ADMISSION", (0, 1), "raise")):
        req = sched.submit(s.request(_prompt(rs, 6), max_new_tokens=2))
        sched.run()
    return dict(reqs=ledger([req]), values=values(reg))


def kv_alloc_fault_degrades_gracefully(s):
    eng, reg = s.engine(), s.registry()
    sched = s.sched(eng, reg)
    rs = np.random.RandomState(27)
    with s.inject(s.fault("SERVE_KV_ALLOC", (0,), "fail", max_hits=1)):
        req = sched.submit(s.request(_prompt(rs, 6), max_new_tokens=2))
        sched.run()
    return dict(reqs=ledger([req]), values=values(reg))


def queue_cap_fast_rejects_excess(s):
    eng, reg = s.engine(), s.registry()
    sched = s.sched(eng, reg, max_queue_depth=2)
    rs = np.random.RandomState(28)
    reqs = [sched.submit(s.request(_prompt(rs, 6), max_new_tokens=2))
            for _ in range(5)]
    at_submit = [(r.shed_reason, r.done_at is not None) for r in reqs]
    sched.run()
    return dict(at_submit=at_submit, reqs=ledger(reqs), values=values(reg))


def clamp_rung_bounds_token_budget(s):
    eng, reg = s.engine(num_pages=9, max_pages_per_seq=4), s.registry()
    sched = s.sched(eng, reg, clamp_max_new_tokens=2, clamp_occupancy=0.25)
    rs = np.random.RandomState(29)
    reqs = [sched.submit(s.request(_prompt(rs, 16), max_new_tokens=10))
            for _ in range(2)]
    sched.run()
    return dict(reqs=ledger(reqs), values=values(reg))


def drain_finishes_running_and_sheds_queued(s):
    eng, reg = s.engine(), s.registry()
    sched = s.sched(eng, reg)
    rs = np.random.RandomState(30)
    reqs = [sched.submit(s.request(_prompt(rs, 6), max_new_tokens=6))
            for _ in range(4)]
    sched.step()  # two admitted, two still queued
    report = sched.drain()
    late = sched.submit(s.request(_prompt(rs, 6)))
    return dict(report=report, reqs=ledger(reqs + [late]), values=values(reg))


def step_loop_flushes_deferred_rebuild_at_idle(s):
    eng, reg = s.engine(), s.registry()
    sched = s.sched(eng, reg)
    rs = np.random.RandomState(34)
    with s.inject(s.fault("SERVE_DECODE", (1,), "raise", max_hits=1)):
        req = sched.submit(s.request(_prompt(rs, 6), max_new_tokens=4))
        while sched.pending:
            sched.step()
    return dict(reqs=ledger([req]), values=values(reg), rebuilds=eng.rebuilds)


def resume_clears_drained_state_and_gauge(s):
    eng, reg = s.engine(), s.registry()
    sched = s.sched(eng, reg)
    rs = np.random.RandomState(35)
    sched.drain()
    rejected = sched.submit(s.request(_prompt(rs, 6)))
    sched.resume()
    accepted = sched.submit(s.request(_prompt(rs, 6), max_new_tokens=2))
    sched.run()
    return dict(reqs=ledger([rejected, accepted]), values=values(reg))


def drain_handoff_reroutes_instead_of_shedding(s):
    eng, reg = s.engine(), s.registry()
    sched = s.sched(eng, reg)
    rs = np.random.RandomState(36)
    reqs = [sched.submit(s.request(_prompt(rs, 6), max_new_tokens=6))
            for _ in range(4)]
    sched.step()
    handed = []

    def handoff(r):
        handed.append(reqs.index(r))
        return True

    report = sched.drain(handoff=handoff)
    return dict(report=report, handed=handed, reqs=ledger(reqs),
                shed=len(sched.shed), values=values(reg))


def incremental_drain_start_finish_split(s):
    eng, reg = s.engine(), s.registry()
    sched = s.sched(eng, reg)
    rs = np.random.RandomState(37)
    reqs = [sched.submit(s.request(_prompt(rs, 6), max_new_tokens=6))
            for _ in range(2)]
    sched.step()
    rerouted = sched.start_drain(handoff=lambda r: True)
    draining, steps = sched.draining, 0
    while sched.pending:
        sched.step()
        steps += 1
    report = sched.finish_drain()
    return dict(rerouted=rerouted, draining=draining, steps=steps,
                report=report, reqs=ledger(reqs), values=values(reg))


def shed_breakdown_still_sums_with_new_reasons(s):
    reasons = s.serve.SHED_REASONS
    return dict(reasons=reasons,
                exported=[s.obs.metric_name(f"serve/shed_{r}")
                          for r in reasons])


def prefix_evict_drill_spares_borrowed_pages(s):
    eng, reg = s.engine(), s.registry()
    sched = s.sched(eng, reg, prefix_cache=True)
    rs = np.random.RandomState(54)
    prompt = _prompt(rs, 19)
    cold = sched.submit(s.request(prompt, max_new_tokens=4))
    sched.run()
    with s.inject(s.fault("SERVE_PREFIX_EVICT", range(64), "force",
                          max_hits=1)):
        warm = sched.submit(s.request(prompt, max_new_tokens=4))
        sched.run()
    report = sched.drain()
    return dict(reqs=ledger([cold, warm]), report=report, values=values(reg))


def _decode_stream(s, rebuild_at):
    """The reference's rebuild bit-identity: one request decoded by hand
    for 6 steps over retained pages, the engine rebuilt at
    ``rebuild_at``."""
    cfg_vocab = DIMS["vocab_size"]
    rs = np.random.RandomState(31)
    prompt = [int(t) for t in rs.randint(0, cfg_vocab, size=9)]
    eng = s.engine()
    pages = eng.pool.alloc(eng.pool.pages_for(len(prompt)))
    _, tok = eng.prefill(prompt, pages)
    ctx = len(prompt)
    table = np.zeros((2, 8), np.int32)
    toks, logits = [], []
    for step in range(6):
        if step == rebuild_at:
            eng.rebuild()
        if ctx // 8 >= len(pages):
            pages += eng.pool.alloc(1)
        table[0, : len(pages)] = pages
        lg, nxt = eng.decode(np.array([tok, 0]), np.array([ctx + 1, 0]),
                             table)
        toks.append(int(nxt[0]))
        logits.append(np.asarray(lg[0], np.float32))
        ctx += 1
        tok = int(nxt[0])
    return eng.rebuilds, toks, logits


def rebuild_decode_is_bit_identical(s):
    _, clean_toks, clean_logits = _decode_stream(s, None)
    rebuilds, toks, logits = _decode_stream(s, 3)
    for a, b in zip(logits, clean_logits):
        np.testing.assert_array_equal(a, b)  # bit for bit on each side
    return dict(rebuilds=rebuilds, toks=toks, clean=clean_toks,
                logits=np.stack(logits))


def full_rebuild_drops_prefill_buckets_lazily(s):
    eng = s.engine().build(buckets=(8,))
    rs = np.random.RandomState(32)
    prompt = [int(t) for t in rs.randint(0, 64, size=5)]
    pages = eng.pool.alloc(1)
    _, before = eng.prefill(prompt, pages)
    eng.rebuild(full=True)
    logits, after = eng.prefill(prompt, pages)
    eng.pool.free(pages)
    return dict(before=before, after=after, rebuilds=eng.rebuilds,
                logits=np.asarray(logits, np.float32))


def finite_screens_default_clean(s):
    eng = s.engine()
    rs = np.random.RandomState(33)
    pages = eng.pool.alloc(1)
    eng.prefill([int(t) for t in rs.randint(0, 64, size=5)], pages)
    prefill_finite = eng.last_prefill_finite
    table = np.zeros((2, 8), np.int32)
    table[0, :1] = pages
    eng.decode(np.array([1, 0]), np.array([6, 0]), table)
    eng.pool.free(pages)
    return dict(prefill=prefill_finite,
                decode=[bool(x) for x in eng.last_decode_finite])


def probe_stream_fingerprints(s):
    """The golden probe: a greedy stream, the prefill's last logits as
    f32 bytes, the screens folded in (a poisoned decode clears it), the
    pages back in the pool."""
    eng = s.engine()
    rs = np.random.RandomState(38)
    prompt = _prompt(rs, 11)
    toks, logits, finite = eng.probe_stream(prompt, 6)
    with s.inject(s.fault("SERVE_DECODE", (eng.decode_iters + 2,), "nan")):
        ptoks, _, pfinite = eng.probe_stream(prompt, 6)
    too_long = _outcome_of(eng.probe_stream, prompt, 60)
    return dict(tokens=[int(t) for t in toks],
                logits=np.frombuffer(logits, np.float32).copy(),
                finite=finite, poisoned=(ptoks == toks, pfinite),
                too_long=too_long, pool=eng.pool.in_use)


def _outcome_of(fn, *args):
    try:
        fn(*args)
        return "ok"
    except ValueError as e:
        return str(e)


def _spec_run(s, sched, prompts, max_new=8):
    reqs = [sched.submit(s.request(p, max_new_tokens=max_new, rid=f"r{i}"))
            for i, p in enumerate(prompts)]
    sched.run()
    return reqs


def _draft_fault_storm(s, mode):
    rs = np.random.RandomState(65)
    prompts = [_prompt(rs, 6), _prompt(rs, 11)]
    base = _spec_run(s, s.sched(s.engine()), prompts)
    reg = s.registry()
    sched = s.sched(s.engine(spec=s.spec(k=4)), reg)
    with s.inject(s.fault("SERVE_DRAFT", (0, 1, 2), mode)):
        reqs = _spec_run(s, sched, prompts)
    sched.leak_check()
    return dict(base=ledger(base), reqs=ledger(reqs), values=values(reg),
                pool=sched.engine.pool.in_use)


def draft_fault_storm_raise(s):
    return _draft_fault_storm(s, "raise")


def draft_fault_storm_nan(s):
    return _draft_fault_storm(s, "nan")


def acceptance_collapse_falls_back_to_plain(s):
    eng = s.engine(spec=s.spec(draft_layers=1, k=4, min_accept_rate=0.95,
                               window=2))
    reg = s.registry()
    sched = s.sched(eng, reg)
    rs = np.random.RandomState(66)
    prompts = [_prompt(rs, 8), _prompt(rs, 8)]
    base = _spec_run(s, s.sched(s.engine()), prompts, max_new=12)
    reqs = _spec_run(s, sched, prompts, max_new=12)
    fell_back = sched._spec_fallback
    sched.resume()
    return dict(base=ledger(base), reqs=ledger(reqs), values=values(reg),
                fell_back=fell_back, rearmed=not sched._spec_fallback,
                pool=eng.pool.in_use)


def _statuses(led):
    return [(r["status"], r["reason"]) for r in led]


#: the reference test's claims on each scenario's ledger
CLAIMS = {
    "decode_fault_retries_preserve_prefix": lambda r: (
        [q["tokens"] for q in r["faulted"]["reqs"]]
        == [q["tokens"] for q in r["clean"]["reqs"]]
        and r["faulted"]["rebuilds"] == 1 and r["faulted"]["pool"] == 0
        and r["faulted"]["leak_checks"] > 0
        and _statuses(r["faulted"]["reqs"]) == [("done", None)] * 2),
    "persistent_decode_fault_exhausts_rebuild_limit": lambda r: (
        "rebuild_limit" in r["error"]),
    "prefill_fault_retried_then_shed_when_persistent": lambda r: (
        r["transient"][0]["status"] == "done"
        and r["transient"][0]["retries"] == 1
        and len(r["transient"][0]["tokens"]) == 2
        and _statuses(r["persistent"]) == [("shed", "retries_exhausted")]
        and r["persistent"][0]["retries"] == 2 and r["pool2"] == 0
        and r["values2"]["serve/shed_retries_exhausted"] == 1.0
        and r["values2"]["serve/retries"] == 2.0
        and r["values2"]["serve/engine_faults"] == 3.0),
    "poisoned_decode_evicts_only_offending_slot": lambda r: (
        _statuses(r["reqs"]) == [("shed", "poisoned"), ("done", None)]
        and len(r["reqs"][1]["tokens"]) == 8 and r["pool"] == 0
        and r["values"]["serve/shed_poisoned"] == 1.0
        and r["values"]["serve/shed"] == 1.0),
    "poisoned_prefill_quarantined_at_first_token": lambda r: (
        _statuses(r["reqs"]) == [("shed", "poisoned")]
        and r["reqs"][0]["tokens"] == [] and r["pool"] == 0),
    "decode_timeout_is_per_request": lambda r: (
        _statuses(r["reqs"]) == [("done", None)] * 2
        and r["reqs"][0]["retries"] >= 1 and r["reqs"][1]["retries"] == 0
        and [len(q["tokens"]) for q in r["reqs"]] == [4, 4]
        and r["values"]["serve/decode_timeouts"] >= 1.0),
    "admission_fault_is_transient": lambda r: (
        r["reqs"][0]["status"] == "done"
        and r["values"]["serve/admission_faults"] == 2.0),
    "kv_alloc_fault_degrades_gracefully": lambda r: (
        r["reqs"][0]["status"] == "done"
        and r["values"]["serve/kv_alloc_faults"] == 1.0),
    "queue_cap_fast_rejects_excess": lambda r: (
        sum(1 for reason, done in r["at_submit"]
            if reason == "queue_full" and done) == 3
        and [q["status"] for q in r["reqs"][:2]] == ["done", "done"]
        and r["values"]["serve/shed_queue_full"] == 3.0
        and r["values"]["serve/shed"] == 3.0),
    "clamp_rung_bounds_token_budget": lambda r: (
        _statuses(r["reqs"]) == [("done", None)] * 2
        and r["reqs"][1]["clamped_from"] == 10
        and r["reqs"][1]["max_new"] == 2
        and len(r["reqs"][1]["tokens"]) == 2
        and r["values"]["serve/clamped"] >= 1.0),
    "drain_finishes_running_and_sheds_queued": lambda r: (
        r["report"]["drained"] and r["report"]["pool_in_use"] == 0
        and _statuses(r["reqs"]) == [("done", None)] * 2
        + [("shed", "draining")] * 3
        and r["values"]["serve/drains"] == 1.0
        # the late request was shed after the drain's last publish
        and r["values"]["serve/shed_draining"] == 2.0),
    "step_loop_flushes_deferred_rebuild_at_idle": lambda r: (
        r["reqs"][0]["status"] == "done" and r["rebuilds"] == 1),
    "resume_clears_drained_state_and_gauge": lambda r: (
        _statuses(r["reqs"]) == [("shed", "draining"), ("done", None)]
        and r["values"]["serve/draining"] == 0.0),
    "drain_handoff_reroutes_instead_of_shedding": lambda r: (
        r["report"]["rerouted"] == 2 and r["handed"] == [2, 3]
        and [q["status"] for q in r["reqs"]] == ["done", "done", "queued",
                                                 "queued"]
        and all(q["reason"] is None and q["pages"] == 0
                for q in r["reqs"][2:])
        and r["shed"] == 0 and r["values"]["serve/shed_rerouted"] == 2.0
        and r["values"]["serve/shed"] == 2.0
        and r["values"]["serve/shed_draining"] == 0.0),
    "incremental_drain_start_finish_split": lambda r: (
        r["draining"] and r["rerouted"] == 0 and r["steps"] > 0
        and r["report"]["drained"] and r["report"]["pool_in_use"] == 0
        and _statuses(r["reqs"]) == [("done", None)] * 2),
    "shed_breakdown_still_sums_with_new_reasons": lambda r: (
        {"poisoned", "queue_full", "retries_exhausted", "draining",
         "rerouted"} < set(r["reasons"])
        and len(set(r["exported"])) == len(r["reasons"])),
    "prefix_evict_drill_spares_borrowed_pages": lambda r: (
        r["reqs"][1]["status"] == "done"
        and r["reqs"][1]["tokens"] == r["reqs"][0]["tokens"]
        and r["values"]["serve/prefix_evict_faults"] == 1.0
        and r["report"]["pool_in_use"] == 0),
    "rebuild_decode_is_bit_identical": lambda r: (
        r["rebuilds"] == 1 and r["toks"] == r["clean"]),
    "full_rebuild_drops_prefill_buckets_lazily": lambda r: (
        r["before"] == r["after"] and r["rebuilds"] == 1),
    "finite_screens_default_clean": lambda r: (
        r["prefill"] is True and all(r["decode"])),
    "probe_stream_fingerprints": lambda r: (
        len(r["tokens"]) == 6 and r["finite"] is True
        and r["logits"].shape == (DIMS["vocab_size"],)
        and r["poisoned"] == (True, False) and r["pool"] == 0
        and "max_context" in r["too_long"]),
    "draft_fault_storm_raise": lambda r: (
        [q["tokens"] for q in r["reqs"]] == [q["tokens"] for q in r["base"]]
        and r["values"]["serve/draft_faults"] >= 1.0 and r["pool"] == 0),
    "draft_fault_storm_nan": lambda r: (
        [q["tokens"] for q in r["reqs"]] == [q["tokens"] for q in r["base"]]
        and r["values"]["serve/spec_rejected"] >= 1.0 and r["pool"] == 0),
    "acceptance_collapse_falls_back_to_plain": lambda r: (
        [q["tokens"] for q in r["reqs"]] == [q["tokens"] for q in r["base"]]
        and r["values"]["serve/spec_fallbacks"] >= 1.0 and r["fell_back"]
        and r["rearmed"] and r["pool"] == 0),
}

SCENARIOS = {name: globals()[name] for name in CLAIMS}


def _assert_equal(jax_out, port_out, path="result"):
    """Equal ledgers; arrays (f32 logits) within TOL."""
    if isinstance(jax_out, np.ndarray):
        np.testing.assert_allclose(port_out, jax_out, **TOL, err_msg=path)
        return
    if isinstance(jax_out, dict):
        assert set(port_out) == set(jax_out), (path, set(port_out)
                                               ^ set(jax_out))
        for k in jax_out:
            _assert_equal(jax_out[k], port_out[k], f"{path}.{k}")
        return
    if isinstance(jax_out, (list, tuple)):
        assert len(port_out) == len(jax_out), path
        for i, (a, b) in enumerate(zip(jax_out, port_out)):
            _assert_equal(a, b, f"{path}[{i}]")
        return
    assert port_out == jax_out, (path, jax_out, port_out)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(models, monkeypatch, name):
    out = {}
    for kind in ("jax", "port"):
        side = Side(kind, models, monkeypatch)
        out[kind] = SCENARIOS[name](side)
    _assert_equal(out["jax"], out["port"])
    assert CLAIMS[name](out["port"]), out["port"]


# ---------------------------------------------------------------------------
# the chaos drill, port against reference
# ---------------------------------------------------------------------------


def _reference_drill():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_chaos_drill", ROOT / "tools" / "serve_chaos_drill.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the artifact's sections that are the drill's ledger (the reference's
#: ``engine.compile_counts`` and the wall-clock anchor are not)
LEDGER_KEYS = ("config", "chaos_spec", "chaos_sites", "reference", "storm",
               "overload_probe", "p99_ttft_inflation", "process_deaths",
               "terminals", "pages", "registry", "drain")


def test_port_drill_reproduces_the_reference_ledger():
    from apex_tpu_torch.tools import serve_chaos_drill as port_drill

    ref = _reference_drill()
    assert port_drill.DEFAULT_CHAOS_SPEC == ref.DEFAULT_CHAOS_SPEC
    assert port_drill.DEFAULT_EXPECTED == ref.DEFAULT_EXPECTED
    jargs = ref.build_parser().parse_args([])
    pargs = port_drill.build_parser().parse_args(["--device", "cpu"])
    assert pargs.device == "cpu"
    for key in vars(jargs):
        if key != "verify":
            assert getattr(pargs, key) == getattr(jargs, key), key
    want = ref.run_drill(jargs)
    keep = {}
    got = port_drill.run_drill(pargs, keep=keep)
    for section in LEDGER_KEYS:
        w, g = want[section], got[section]
        if section in ("reference", "storm"):
            g = {k: v for k, v in g.items() if k != "host_s"}
        if section == "overload_probe":
            assert g.pop("clamped_to") == [4]
        assert g == w, section
    assert got["engine"]["rebuilds"] == want["engine"]["rebuilds"] == 1
    assert port_drill.check(got, pargs) == []
    # every request the storm completed streams what the fault-free run
    # streamed: a retried request resumed from its kept pages
    both = [(a.tokens, b.tokens) for a, b in zip(keep["reference"],
                                                 keep["storm"])
            if a.status == b.status == "done"]
    assert len(both) >= 90 and all(a == b for a, b in both)

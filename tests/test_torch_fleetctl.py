"""apex_tpu_torch's fleet control plane vs the JAX package's.

One seeded storm — a replica crash, a preemption, a traffic spike, two
router faults and a rolling deploy against an autoscaled fleet, beside a
fault-free reference fleet — runs through the reference drill
(``tools/fleet_drill.py``, imported from its path) and the port's
(``apex_tpu_torch.tools.fleet_drill``) at the reference's flags but 60
requests, on the same weights (the JAX drill's seeded trees carried over
by ``from_jax_params``; f32).  The artifacts' ledgers — every run's
terminals, shed reasons, TTFTs and ticks, the fleet counters, the
per-replica serve counters summed, the deploy records, the autoscaler's
decisions and health events, the replicas' summaries — are EQUAL, and
every request streams the same greedy tokens on both.

The shared-weights trap: a fleet's replicas share one prepared copy of
the weights, so a redeploy that copied new weights into those tensors in
place would deploy to every replica at once.  The port's redeploy gives
the canary weights of its own (the incumbents keep theirs); a planted
in-place redeploy must make the canary drill fail, with the incumbents'
fingerprints moved.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from apex_tpu.fleetctl import Fleet as JaxFleet
from apex_tpu_torch.fleetctl import LIVE, EngineReplica
from apex_tpu_torch.models import from_jax_params
from apex_tpu_torch.serve.model import PackedParams, PackedWeight
from apex_tpu_torch.tools import canary_drill as pcanary
from apex_tpu_torch.tools import fleet_drill as pdrill

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--requests", "60"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def carried_params(jdrill, jargs):
    """The port's ``params_fn``: the JAX drill's seeded tree for ``key``,
    carried into a port model."""
    def params_fn(args, key, configs):
        cfg, _ = configs(args)
        tree = jdrill.make_params(jargs, key=key)
        return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), cfg,
                               device="cpu")

    return params_fn


@pytest.fixture(scope="module")
def storm(monkeypatch_module):
    jdrill = _reference("fleet_drill")
    jargs = jdrill.build_parser().parse_args(FLAGS)
    pargs = pdrill.build_parser().parse_args(FLAGS + ["--device", "cpu"])
    submitted = []
    orig = JaxFleet.submit

    def submit(self, req):
        submitted.append(req)
        return orig(self, req)

    monkeypatch_module.setattr(JaxFleet, "submit", submit)
    want = jdrill.run_drill(jargs)
    monkeypatch_module.setattr(JaxFleet, "submit", orig)
    keep = {}
    got = pdrill.run_drill(pargs, params_fn=carried_params(jdrill, jargs),
                           keep=keep)
    n = jargs.requests
    return dict(jdrill=jdrill, jargs=jargs, pargs=pargs, want=want, got=got,
                keep=keep, jax_reqs={"reference": submitted[:n],
                                     "storm": submitted[n:]})


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_flags_and_storm_equal_the_reference(storm):
    jargs, pargs = storm["jargs"], storm["pargs"]
    assert pdrill.DEFAULT_CHAOS_SPEC == storm["jdrill"].DEFAULT_CHAOS_SPEC
    assert pdrill.DEFAULT_EXPECTED == storm["jdrill"].DEFAULT_EXPECTED
    for key in vars(jargs):
        assert getattr(pargs, key) == getattr(jargs, key), key
    assert pargs.device == "cpu"


#: the artifact's sections that are the drill's ledger (the wall-clock
#: anchor, the ops servers' ports and the span file are not)
LEDGER_KEYS = ("config", "chaos_spec", "chaos_sites", "p99_ttft_inflation",
               "process_deaths", "goodput", "terminals", "pages",
               "fleet_registry", "aggregated_serve", "replicas", "deploys",
               "autoscaler")


@pytest.mark.parametrize("section", ("reference", "storm") + LEDGER_KEYS)
def test_ledger_section_equals_the_reference(storm, section):
    got, want = storm["got"][section], storm["want"][section]
    if section in ("reference", "storm"):
        got = {k: v for k, v in got.items() if k != "ledger_digest"}
    assert got == want


def test_drill_passes_and_ops_fold_every_replica(storm):
    got, want = storm["got"], storm["want"]
    assert pdrill.check(got, storm["pargs"]) == []
    for key in ("servers", "distinct_ports", "all_bound",
                "aggregated_sources", "aggregated_completed",
                "counter_families"):
        assert got["ops"][key] == want["ops"][key], key
    fr = got["fleet_registry"]
    assert fr["fleet/scale_out"] >= 1 and fr["fleet/scale_in"] >= 1
    assert all(fr[k] == v for k, v in pdrill.DEFAULT_EXPECTED.items())


@pytest.mark.parametrize("run", ["reference", "storm"])
def test_requests_stream_the_references_tokens(storm, run):
    mine, ref = storm["keep"][run], storm["jax_reqs"][run]
    assert len(mine) == len(ref) == storm["jargs"].requests
    for a, b in zip(mine, ref):
        assert (a.status, a.shed_reason, a.retries) == \
            (b.status, b.shed_reason, b.retries)
        assert a.tokens == [int(t) for t in b.tokens]
    assert pdrill.ledger_digest(pdrill.ledger(
        mine, pdrill.VirtualClock().tick_s)) == \
        storm["got"][run]["ledger_digest"]


def test_replicas_share_weights_until_redeployed(storm):
    fleet = storm["keep"]["storm_fleet"]
    first = storm["keep"]["reference_fleet"].replicas[0].engine.weights
    ref_weights = {id(r.engine.weights)
                   for r in storm["keep"]["reference_fleet"].replicas}
    assert ref_weights == {id(first)}
    updated = set(fleet.deploy_history[-1]["updated"])
    for rep in fleet.replicas:
        if rep.name in updated:
            assert rep.engine.weights is not first
    born_after = [r for r in fleet.replicas if r.name not in updated]
    assert any(r.engine.weights is born_after[0].engine.weights
               for r in born_after[1:])


# ---------------------------------------------------------------------------
# the planted fault: an in-place redeploy into the shared weights
# ---------------------------------------------------------------------------


def _tensors(weights):
    if isinstance(weights, PackedParams):
        out = []
        for leaf in weights.leaves():
            out += ([leaf.codes, leaf.scale]
                    if isinstance(leaf, PackedWeight) else [leaf])
        return out
    return list(weights.parameters())


@torch.no_grad()
def inplace_redeploy(self, params, draft_params=None):
    """The fault: the new weights copied into the replica's tensors in
    place — which its fleet's other replicas share."""
    if self.sched.prefix is not None:
        self.sched.prefix.flush()
    self.engine.reset_cache()
    new = (params if isinstance(params, PackedParams)
           or getattr(params, "_serving_copy", False)
           else self.engine.prepare_weights(params))
    for dst, src in zip(_tensors(self.engine.weights), _tensors(new)):
        dst.copy_(src)
    self.engine.rebuild(full=True)
    self.sched.resume()
    self.state = LIVE
    self.drain_reason = None


CANARY_FLAGS = ["--device", "cpu", "--clean-seeds", "1", "--requests", "60"]


@pytest.mark.parametrize("fault", [False, True])
def test_shared_weights_fault_is_caught(fault, monkeypatch):
    args = pcanary.build_parser().parse_args(CANARY_FLAGS)
    if fault:
        monkeypatch.setattr(EngineReplica, "redeploy", inplace_redeploy)
    art = pcanary.run_drill(args)
    failures = pcanary.check(args, art)
    reg = art["regression"]
    moved = {n for n, d in reg["post_rollback_digests"].items()
             if d != reg["incumbent_digest"]}
    if not fault:
        assert failures == [] and moved == set()
        assert reg["deploys"][-1]["canary"]["rollback_digest"] == \
            reg["incumbent_digest"]
    else:
        # the bad weights reached every replica: the incumbents'
        # fingerprints moved and the drill fails
        assert failures and moved == set(reg["post_rollback_digests"])

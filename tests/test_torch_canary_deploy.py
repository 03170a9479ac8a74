"""apex_tpu_torch's canary-gated deploys vs the JAX package's.

The reference canary drill (``tools/canary_drill.py``, imported from its
path) and the port's (``apex_tpu_torch.tools.canary_drill``) run at the
reference's flags but one clean seed and 100 requests, on the same
weights (the JAX drill's seeded trees carried over by
``from_jax_params``; f32): a clean deploy passes the canary and rolls to
every replica, a NaN-poisoned one fails inside the window and rolls back.
Every run's ledger — terminals, shed reasons, TTFT p99, ticks, the
deploy records with the canary's verdict, detect ticks, routed exposure
and token exposure, the fleet counters, the health events — is EQUAL,
and so are the golden probes' greedy streams and the old-to-new
fingerprint distance.  Digests are compared within each package only
(they hash the prefill logits' bytes): the rollback's digest is the
incumbent's bit for bit, and after a clean deploy every replica
fingerprints as the canary's new weights.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from apex_tpu_torch.models import from_jax_params
from apex_tpu_torch.tools import canary_drill as pcanary

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--clean-seeds", "1", "--requests", "100"]

#: per-run keys that hold digests (compared within a package only)
DIGEST_KEYS = ("incumbent_digest", "post_rollback_digests",
               "post_deploy_digests", "canary_new_digest", "ledger_digest")


def carried_params(jdrill, jargs):
    """The port's ``params_fn``: the JAX drill's seeded tree for ``key``,
    carried into a port model."""
    def params_fn(args, key, configs):
        cfg, _ = configs(args)
        tree = jdrill.make_params(jargs, key=key)
        return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), cfg,
                               device="cpu")

    return params_fn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def drills():
    spec = importlib.util.spec_from_file_location(
        "reference_canary_drill", ROOT / "tools" / "canary_drill.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    jargs = ref.build_parser().parse_args(FLAGS)
    pargs = pcanary.build_parser().parse_args(FLAGS + ["--device", "cpu"])
    want = ref.run_drill(jargs)
    got = pcanary.run_drill(
        pargs, params_fn=carried_params(ref.fleet_drill, jargs))
    return ref, jargs, pargs, want, got


def _strip(run):
    out = {k: v for k, v in run.items() if k not in DIGEST_KEYS}
    deploys = []
    for d in out["deploys"]:
        d = dict(d)
        c = dict(d.get("canary", {}))
        c.pop("rollback_digest", None)
        fp = dict(c.get("fingerprint", {}))
        fp.pop("old_digest", None)
        fp.pop("new_digest", None)
        if fp:
            c["fingerprint"] = fp
        d["canary"] = c
        deploys.append(d)
    out["deploys"] = deploys
    return out


def test_flags_equal_the_reference(drills):
    _, jargs, pargs, _, _ = drills
    for key in vars(jargs):
        assert getattr(pargs, key) == getattr(jargs, key), key


@pytest.mark.parametrize("run", ["clean[0]", "regression"])
def test_run_ledger_equals_the_reference(drills, run):
    _, _, _, want, got = drills
    pick = (lambda art: art["clean_runs"][0] if run != "regression"
            else art["regression"])
    assert _strip(pick(got)) == _strip(pick(want))


def test_verdicts_and_bounds(drills):
    ref, jargs, pargs, want, got = drills
    assert pcanary.check(pargs, got) == []
    assert ref.check(jargs, want) == []
    for key in ("false_positives", "detect_ticks", "open_spans",
                "span_drops"):
        assert got[key] == want[key], key
    fp_got, fp_want = got["fingerprints"], want["fingerprints"]
    for key in ("rebuild_bit_exact", "single_bit_flips_digest",
                "restore_matches", "probe_pool_clean", "probe_tokens"):
        assert fp_got[key] == fp_want[key], key
    assert fp_got["rebuild_bit_exact"] and fp_got["restore_matches"]
    reg = got["regression"]
    c = reg["deploys"][-1]["canary"]
    assert c["verdict"] == "fail" and reg["rolled_back"] == 1
    assert c["rollback_digest"] == reg["incumbent_digest"]
    assert set(reg["post_rollback_digests"].values()) == {
        reg["incumbent_digest"]}
    clean = got["clean_runs"][0]
    assert clean["deploys"][-1]["canary"]["verdict"] == "pass"
    assert set(clean["post_deploy_digests"].values()) == {
        clean["canary_new_digest"]}

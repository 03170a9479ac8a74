"""apex_tpu_torch's resilient example vs the reference's.

``apex_tpu_torch.examples.train_resilient`` and
``examples/simple/resilient/train_resilient.py`` (JAX on as many CPU
devices as the port has ranks) run as subprocesses with the same flags,
the same seeded toy data and the same ``APEX_TPU_CHAOS`` storm:

- a NaN burst, a save fault healed by its retry and a preemption at step
  42; then the same command again, which resumes from the preemption's
  checkpoint and finishes;
- a NaN streak longer than the rollback trigger (one rollback, its
  window discarded and replayed);
- two ranks over gloo (the reference on two devices), where the port's
  ``FleetAggregator`` feeds the straggler rule (one microbatch a step:
  the reference's accumulation scan fails under jax 0.9.0, as
  ``tests/test_comm.py``'s accumulation tests do, ROADMAP §C3).

Every invocation's final ``train/goodput`` record (accepted, skipped,
discarded, rollbacks, retries, resumes, preempted), its ``done:`` line
and its final loss (1e-5) are the reference's.  A profiler window armed
by ``APEX_TPU_TRACE_STEPS`` lands in its window directory and is
attributed on the way out, onto the JSONL.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "examples" / "simple" / "resilient" / "train_resilient.py"
CHAOS = "grads:nan@7,8;checkpoint_save:raise:x1@5;preemption@42"

#: scenario -> (chaos spec, the invocations' extra flags, world)
SCENARIOS = {
    "preempt_then_resume": (CHAOS, [["--steps", "60"], ["--steps", "60"]], 1),
    "rollback": ("grads:nan:x6@10,11,12,13,14,15",
                 [["--steps", "24", "--save-every", "4"]], 1),
    "two_ranks": ("grads:nan@3", [["--steps", "16"]], 2),
}


def _env(extra):
    env = dict(os.environ)
    env.pop("APEX_TPU_CHAOS", None)
    env.pop("APEX_TPU_TRACE_STEPS", None)
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _run(cmd, env, timeout=240):
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=timeout)
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout


def _summary(stdout, jsonl):
    recs = [json.loads(line) for line in Path(jsonl).read_text().splitlines()]
    (final,) = [r for r in recs
                if r["metric"] == "train/goodput" and "accepted" in r]
    done = re.search(r"^done: .*$", stdout, re.M).group(0)
    loss = float(re.search(r"^final loss: (\S+)$", stdout, re.M).group(1))
    return final, done, loss, recs


def _port(tmp, name, flags, world, env):
    if world == 1:
        out = _run([sys.executable, "-m",
                    "apex_tpu_torch.examples.train_resilient", "--device",
                    "cpu", "--dir", str(tmp / "port"), "--metrics-out",
                    str(tmp / f"{name}.jsonl"), *flags], env)
        return [_summary(out, tmp / f"{name}.jsonl")]
    store = tmp / f"{name}.store"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch.examples.train_resilient",
         "--device", "cpu", "--backend", "gloo", "--init-method",
         f"file://{store}", "--world-size", str(world), "--rank", str(r),
         "--dir", str(tmp / "port"), "--metrics-out",
         str(tmp / f"{name}.r{r}.jsonl"), *flags],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    outs = []
    for r, p in enumerate(procs):
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, out + err
        outs.append(_summary(out, tmp / f"{name}.r{r}.jsonl"))
    return outs


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def runs(request, tmp_path_factory):
    name = request.param
    chaos, invocations, world = SCENARIOS[name]
    tmp = tmp_path_factory.mktemp(name)
    env = _env({"APEX_TPU_CHAOS": chaos})
    jenv = _env({"APEX_TPU_CHAOS": chaos, "JAX_PLATFORMS": "cpu",
                 "XLA_FLAGS": f"--xla_force_host_platform_device_count="
                              f"{world}"})
    mine, ref = [], []
    for i, flags in enumerate(invocations):
        ref_out = _run([sys.executable, str(REF), "--dir", str(tmp / "ref"),
                        "--metrics-out", str(tmp / f"ref{i}.jsonl"),
                        *flags], jenv)
        ref.append(_summary(ref_out, tmp / f"ref{i}.jsonl"))
        mine.append(_port(tmp, f"port{i}", flags, world, env))
    return name, mine, ref


def test_counts_and_losses_equal_the_reference(runs):
    name, mine, ref = runs
    for ranks, (want, want_done, want_loss, _) in zip(mine, ref):
        for final, done, loss, _ in ranks:
            keys = ("accepted", "skipped", "discarded", "rollbacks",
                    "retries", "resumes", "preempted", "step", "value")
            assert {k: final[k] for k in keys} == {k: want[k] for k in keys}
            assert done == want_done
            assert loss == pytest.approx(want_loss, rel=0, abs=1e-5)
    finals = [r[0][0] for r in mine]
    if name == "preempt_then_resume":
        assert [f["preempted"] for f in finals] == [True, False]
        assert finals[0]["skipped"] == 2 and finals[0]["retries"] == 1
        assert finals[1]["resumes"] == 1
    if name == "rollback":
        assert finals[0]["rollbacks"] == 1 and finals[0]["discarded"] > 0


def test_trace_window_is_attributed_on_the_way_out(tmp_path):
    trace_dir = tmp_path / "trace"
    env = _env({"APEX_TPU_CHAOS": "grads:nan@3",
                "APEX_TPU_TRACE_STEPS": f"4+3:{trace_dir}"})
    out = _run([sys.executable, "-m",
                "apex_tpu_torch.examples.train_resilient", "--device", "cpu",
                "--steps", "12", "--dir", str(tmp_path / "run"),
                "--metrics-out", str(tmp_path / "m.jsonl")], env)
    (window,) = os.listdir(trace_dir)
    assert window == "steps_000004_000006"
    (name,) = os.listdir(trace_dir / window)
    assert name.endswith(".pt.trace.json.gz")
    assert "trace attribution (steps 4..6, host-ops)" in out
    recs = [json.loads(line)
            for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    fr = {r["metric"]: r["value"] for r in recs
          if r["metric"].startswith("attribution/")}
    total = sum(fr[f"attribution/{k}_fraction"]
                for k in ("compute", "collective", "host_stall"))
    assert total == pytest.approx(1.0)

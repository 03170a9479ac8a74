"""apex_tpu_torch.tools.goodput_drill against tools/goodput_drill.py.

Both drills run at their defaults (60 steps, a preemption every 12, a
save every 8 with one save fault that heals on retry, a 75 ms step
floor), each in a process of its own and both at once: the reference
with JAX on the CPU, the port with ``--device cpu``.  Both must print
``PASS``; their ledgers — the accountant's accepted, skipped,
discarded, rollbacks, retries and resumes, the invocations, the saves
and writes, the checkpoint spans, the restored stream cursor and the
planted mid-write checks — must be equal (the finalize spans, whose
count the host's load decides, are held between 1 and the storm's
barriers on both sides), and the port's resume must be
bit-exact with the previous checkpoint intact under the port's own
mid-write debris.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from apex_tpu_torch.tools import goodput_drill

ROOT = Path(__file__).resolve().parents[1]

# The finalize barriers the storm's invocations call: each of the five
# run_resilient invocations ends in the shutdown drain
# (apex_tpu_torch/resilience/runner.py:667, apex_tpu/resilience/
# runner.py:684), and each of the four preempted ones drains once more
# before its forced save (runner.py:481 via :659 in the port, :499 via
# :676 in the reference); the storm rolls nothing back, so the anchoring
# drain never runs.  A barrier records a ckpt/finalize span only when it
# really waited (``dt > 1e-4`` at apex_tpu/goodput/async_ckpt.py:416-425
# and apex_tpu_torch/goodput/async_ckpt.py:476-485), and whether a drain
# finds the write queue already empty is up to the host's load — so the
# span count is bounded on both sides, not a ledger quantity.
STORM_FINALIZE_BARRIERS = 5 + 4


def _start(cmd, tmp_path, tag):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               TMPDIR=str(tmp_path))
    # one JAX device, as the reference drill runs on its own (the
    # conftest's eight would put its dp mesh on eight devices)
    env.pop("XLA_FLAGS", None)
    log = open(tmp_path / f"{tag}.log", "w")
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT), log


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("goodput_drill")
    runs = {}
    for tag, cmd in (
            ("ref", [sys.executable, str(ROOT / "tools" / "goodput_drill.py"),
                     "--dir", str(tmp / "ref_dir"),
                     "--json", str(tmp / "ref.json")]),
            ("port", [sys.executable, "-m",
                      "apex_tpu_torch.tools.goodput_drill", "--device",
                      "cpu", "--dir", str(tmp / "port_dir"),
                      "--json", str(tmp / "port.json")])):
        runs[tag] = _start(cmd, tmp, tag)
    out = {}
    for tag, (proc, log) in runs.items():
        rc = proc.wait(timeout=300)
        log.close()
        text = (tmp / f"{tag}.log").read_text()
        out[tag] = dict(rc=rc, text=text,
                        art=json.loads((tmp / f"{tag}.json").read_text())
                        if (tmp / f"{tag}.json").exists() else None)
    return out


@pytest.mark.parametrize("side", ["ref", "port"])
def test_the_drill_passes(drills, side):
    run = drills[side]
    assert run["rc"] == 0, run["text"][-3000:]
    assert "goodput drill: PASS" in run["text"]
    art = run["art"]
    assert art["goodput"] >= 0.99
    assert art["loss_trajectory"]["bit_exact"]
    assert art["planted_midwrite"]["previous_intact"]
    assert art["planted_midwrite"]["resume_ok"]
    assert art["ckpt"]["stall_frac"] < 0.01


def test_the_ledgers_equal_the_reference(drills):
    ref, port = drills["ref"]["art"], drills["port"]["art"]
    for key in ("accepted", "skipped", "discarded", "rollbacks", "retries",
                "resumes", "preempted"):
        assert port["accountant"][key] == ref["accountant"][key], key
    assert (port["accountant"]["accepted"], port["accountant"]["retries"],
            port["accountant"]["resumes"], port["invocations"]) == (
        60, 1, 4, 5)
    for key in ("steps", "preempt_every", "save_every", "chaos_spec",
                "invocations", "goodput", "stream_cursor", "watchdog_pages"):
        assert port[key] == ref[key], key
    timed = {"ckpt_finalize"}
    assert set(port["spans"]) == set(ref["spans"])
    for key in set(ref["spans"]) - timed:
        assert port["spans"][key] == ref["spans"][key], key
    for side in (ref, port):
        # no rollback: the anchoring drain, not counted above, never ran
        assert side["accountant"]["rollbacks"] == 0
        assert (1 <= side["spans"]["ckpt_finalize"]
                <= STORM_FINALIZE_BARRIERS), side["spans"]
    for key in ("saves", "writes", "failures"):
        assert port["ckpt"][key] == ref["ckpt"][key], key
    for key in ("ref_steps", "storm_steps", "bit_exact"):
        assert port["loss_trajectory"][key] == ref["loss_trajectory"][key]
    assert port["planted_midwrite"] == ref["planted_midwrite"]
    # the printed ledger line is the reference's, character for character
    line = [ln for ln in drills["ref"]["text"].splitlines()
            if ln.startswith("goodput drill: goodput=")]
    assert line and line[0] in drills["port"]["text"]


def test_the_drill_defaults_to_the_card():
    args = goodput_drill.build_parser().parse_args([])
    assert args.device == "cuda" and args.steps == 60
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            goodput_drill.run_drill(steps=2, workdir="unused-dir")

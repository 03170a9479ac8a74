"""``apex_tpu_torch.tools.repo_lint`` over the port's tree, and against
``tools/repo_lint.py``.

- the port's tree is clean (exit 0, every ``.py`` file counted), in a
  process where ``torch`` cannot be imported;
- each rule fires on a line planted in a temporary copy of the tree —
  exactly one violation, at the planted file and line — and does not
  fire where the rule allows the line (a host sync under
  ``observability/``, a wall clock outside the step paths and the
  replay-critical modules);
- each of the two waivers (``repo-lint: allow`` and ``# lint:
  allow(<rule>): reason``) silences it, and a waiver naming another
  rule does not;
- on the same planted lines, the printed report of the two rules that
  share the reference's catalog (``kernel-hardcoded-block``,
  ``replay-wall-clock``) is the reference tool's, with
  ``apex_tpu_torch/`` in place of ``apex_tpu/``;
- ``--device cuda`` refuses on a host without a card.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from apex_tpu_torch.tools import repo_lint

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "apex_tpu_torch"

#: (rule, file under the package, planted line, why the lint gives)
PLANTS = [
    ("step-wall-clock", "ops/rope.py", "_T = time.time()",
     "wall clock in a step path freezes when a CUDA graph captures it"),
    ("step-wall-clock", "models/gpt.py", "_T = datetime.now()",
     "wall clock in a step path freezes when a CUDA graph captures it"),
    ("step-f64", "optimizers/fused_adam.py", "_D = torch.float64",
     "f64 literal in a step path"),
    ("step-f64", "normalization/__init__.py", "_X = torch.ones(2).double()",
     "f64 literal in a step path"),
    ("host-sync", "parallel/comm.py", "_V = torch.ones(1).item()",
     "a device->host read"),
    ("host-sync", "serve/scheduler.py", "_V = torch.ones(1).tolist()",
     "a device->host read"),
    ("host-sync", "train/trainer.py", "_V = torch.ones(1).cpu()",
     "a device->host read"),
    ("host-sync", "data/__init__.py", "_V = torch.ones(1).numpy()",
     "a device->host read"),
    ("kernel-hardcoded-block", "ops/layer_norm.py",
     "_Y = layer_norm_fwd(x, w, b, eps=1e-5, rms=False, block_rows=64)",
     "a call site passes a literal block_q=/block_k= tile size"),
    ("kernel-hardcoded-block", "transformer/moe.py",
     "_F = flash(q, k, v, block_q=128, block_k=64)",
     "a call site passes a literal block_q=/block_k= tile size"),
    ("kernel-hardcoded-block", "ops/attention.py",
     "_DEF = ('APEX_FLASH_FWD_BLOCK_K=64',)",
     "a call site passes a literal block_q=/block_k= tile size"),
    ("replay-wall-clock", "serve/engine.py", "_T = time.time()",
     "a wall-clock read (time.time / datetime.now) in a replay-critical"),
    ("replay-wall-clock", "resilience/runner.py",
     "_T = datetime.datetime.now()",
     "a wall-clock read (time.time / datetime.now) in a replay-critical"),
]

#: lines no rule may flag where they stand
ALLOWED = [
    ("observability/metrics.py", "_V = torch.ones(1).item()"),
    ("checkpoint/__init__.py", "_V = torch.ones(1).cpu()"),
    ("analysis/memory.py", "_V = torch.ones(1).tolist()"),
    ("tools/ln_tune.py", "_T = time.time()"),
    ("data/__init__.py", "_T = time.time()"),
    ("goodput/async_ckpt.py", "_T = time.time()"),
    ("ops/layer_norm.py", "_Y = layer_norm_fwd(x, block_rows=block_rows)"),
    ("ops/layer_norm.py", "# block_rows=64 in a comment"),
]


def _copy_tree(tmp_path) -> Path:
    dst = tmp_path / "apex_tpu_torch"
    shutil.copytree(PKG, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so",
                                                  "build"))
    return dst


def _plant(root: Path, rel: str, line: str) -> int:
    path = root / rel
    text = path.read_text()
    if not text.endswith("\n"):
        text += "\n"
    path.write_text(text + line + "\n")
    return len((text + line).splitlines())


def test_the_ports_tree_is_clean_without_torch(tmp_path):
    # torch made unimportable: the scan reads source only
    (tmp_path / "torch.py").write_text("raise ImportError('no torch')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT)]))
    p = subprocess.run([sys.executable, "-m",
                        "apex_tpu_torch.tools.repo_lint", "--device", "cpu"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    n = sum(1 for _ in PKG.rglob("*.py") if "__pycache__" not in _.parts)
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout.strip() == f"repo lint: apex_tpu_torch/ clean ({n} files)"
    assert repo_lint.lint() == []


@pytest.mark.parametrize("rule,rel,line,why", PLANTS,
                         ids=[f"{p[0]}:{p[1]}" for p in PLANTS])
def test_each_rule_fires_and_each_waiver_silences_it(tmp_path, rule, rel,
                                                     line, why):
    root = _copy_tree(tmp_path)
    lineno = _plant(root, rel, line)
    got = repo_lint.lint(str(root))
    assert [(v[0], v[1]) for v in got] == [(rel.replace("/", os.sep),
                                            lineno)], got
    assert got[0][3].startswith(why) and got[0][2] == line.strip()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert repo_lint.main(["--root", str(root), "--device", "cpu"]) == 1
    assert f"  apex_tpu_torch/{rel}:{lineno}: {got[0][3]}\n    {line}\n" \
        f"    fix: {got[0][4]}" in buf.getvalue()
    # the two waivers, on the planted line
    for waiver in ("  # repo-lint: allow (planted)",
                   f"  # lint: allow({rule}): planted"):
        path = root / rel
        lines = path.read_text().splitlines()
        lines[lineno - 1] = line + waiver
        path.write_text("\n".join(lines) + "\n")
        assert repo_lint.lint(str(root)) == [], waiver
    # a waiver of another rule leaves it standing
    other = "host-sync" if rule != "host-sync" else "step-f64"
    lines[lineno - 1] = line + f"  # lint: allow({other}): planted"
    path.write_text("\n".join(lines) + "\n")
    assert len(repo_lint.lint(str(root))) == 1


@pytest.mark.parametrize("rel,line", ALLOWED)
def test_lines_a_rule_allows_do_not_fire(tmp_path, rel, line):
    root = _copy_tree(tmp_path)
    _plant(root, rel, line)
    assert repo_lint.lint(str(root)) == []


def _ref_tool():
    spec = importlib.util.spec_from_file_location(
        "ref_repo_lint", ROOT / "tools" / "repo_lint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rel,line", [
    ("ops/flash.py", "    out = flash(q, k, v, block_q=128)"),
    ("serve/clock.py", "    t0 = time.time()"),
])
def test_shared_rules_print_the_references_report(tmp_path, rel, line):
    src = textwrap.dedent("""\
        import time


        def f(q, k, v):
        """) + line + "\n"
    texts = {}
    for side in ("ref", "port"):
        root = tmp_path / side
        (root / rel).parent.mkdir(parents=True)
        (root / rel).write_text(src)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if side == "ref":
                ref = _ref_tool()
                ref.PKG = str(root)
                rc = ref.main()
            else:
                rc = repo_lint.main(["--root", str(root), "--device", "cpu"])
        assert rc == 1
        texts[side] = buf.getvalue()
    assert texts["port"] == texts["ref"].replace("apex_tpu/",
                                                 "apex_tpu_torch/")


def test_cuda_device_is_required_unless_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert repo_lint.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err

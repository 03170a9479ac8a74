"""``apex_tpu_torch.tools.ln_tune`` against ``tools/ln_tune.py``.

- the flags and defaults are the reference's (``--rows 16384``, its
  ``HIDDENS``), and every candidate is a ``block_rows`` that
  ``norm_launch_plan`` takes: the plan's rows per CTA are the candidate's,
  and its grid covers the card's SMs while the next multiple's would not;
- a cache that ``--cache-out`` writes is read back by the port's
  ``layer_norm_block_rows`` (and so by K1/K2's launch plan) and by the
  reference's ``apex_tpu.ops.pallas.tune_cache`` loader, under the card's
  name and with no name;
- for the same times the table and the ``_TUNED_BLOCK_ROWS`` literal are
  the reference's text, character for character (the reference's
  ``tune`` run with its timer stood in for);
- the tool refuses to run without a CUDA device, and with ``--device
  cpu``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import pytest
import torch

from apex_tpu.ops.pallas import tune_cache as jtc
from apex_tpu_torch.ops import layer_norm as ln
from apex_tpu_torch.ops import tune_cache as tc
from apex_tpu_torch.tools import ln_tune

ROOT = Path(__file__).resolve().parents[1]
#: the H100 SXM's SMs and name, as the card reports them
H100_SMS = 132
H100 = "NVIDIA H100 80GB HBM3"


def _ref_tool():
    spec = importlib.util.spec_from_file_location(
        "ref_ln_tune", ROOT / "tools" / "ln_tune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flags_and_defaults_are_the_references():
    ref = _ref_tool()
    args = ln_tune.build_parser().parse_args([])
    assert args.rows == 16384
    assert (args.dtype, args.device, args.cache_out, args.hidden) == (
        "bf16", "cuda", None, None)
    assert ln_tune.HIDDENS == ref.HIDDENS
    args = ln_tune.build_parser().parse_args(
        ["--rows", "4096", "--hidden", "1024", "--hidden", "4096",
         "--dtype", "f32", "--cache-out", "c.json"])
    assert (args.rows, args.hidden, args.dtype, args.cache_out) == (
        4096, [1024, 4096], "f32", "c.json")


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("hidden", ln_tune.HIDDENS + [64, 130])
def test_candidates_are_plans_norm_launch_plan_takes(hidden, dtype):
    elem = ln_tune.DTYPES[dtype]
    rows = 16384
    cands = ln_tune.candidates(rows, hidden, elem, H100_SMS)
    default = ln.norm_launch_plan(rows, hidden, elem, sms=H100_SMS,
                                  ctas_per_sm=lambda v, p, w: 8)
    base = default.per_cta
    assert base == ln.NORM_WARPS * default.rows_per_warp \
        // default.warps_per_row
    assert cands[0] == base
    # then the multiples of the larger of the default and NORM_WARPS
    step = max(base, ln.NORM_WARPS)
    assert cands[1:] == [step * k for k in range(base // step + 1,
                                                base // step + len(cands))]
    for c in cands:
        plan = ln.norm_launch_plan(rows, hidden, elem, sms=H100_SMS,
                                   ctas_per_sm=lambda v, p, w: 8, block_rows=c)
        assert plan.per_cta == c
        assert (plan.vec, plan.per_lane, plan.lanes) == (
            default.vec, default.per_lane, default.lanes)
        assert -(-rows // c) >= H100_SMS
        assert plan.grid == min(-(-rows // c), H100_SMS * 8)
    # the next multiple would leave an SM without a CTA
    assert -(-rows // (cands[-1] + step)) < H100_SMS
    if 768 <= hidden <= 1024:
        # one row per warp: 8, 16, ..., 120 at 16384 rows on 132 SMs
        assert cands == list(range(8, 121, 8))
    elif hidden > 1024:
        # a row on 4 or 8 warps: 2 or 1 rows a CTA, then 8, 16, ..., 120
        assert cands == [8 // default.warps_per_row] + list(range(8, 121, 8))


def test_bound_counts_each_input_once():
    # bf16 at 16384 x 1024: 5 row tensors of 2 bytes, memory-bound
    rows, hidden = 16384, 1024
    nbytes = 5 * rows * hidden * 2 + 16 * rows + 24 * hidden
    assert ln_tune.bound_ms(rows, hidden, 2) == pytest.approx(
        nbytes / 3.35e12 * 1e3)


@pytest.mark.parametrize("backend", [H100, None])
def test_written_cache_is_read_by_both_loaders(tmp_path, monkeypatch,
                                               backend):
    path = tmp_path / "tune.json"
    best = {1024: 32, 4096: 64}
    ln_tune.write_cache(str(path), best, backend)
    # a second sweep's winner for one width replaces its entry
    ln_tune.write_cache(str(path), {4096: 96}, backend)
    data = json.loads(path.read_text())
    assert sorted((e["hidden"], e["block_rows"], e["backend"])
                  for e in data["layer_norm"]) == [
        (1024, 32, backend), (4096, 96, backend)]
    monkeypatch.setenv(tc.ENV_VAR, str(path))
    monkeypatch.setattr(tc, "_backend_kind", lambda: H100)
    monkeypatch.setattr(jtc, "_backend_kind", lambda: H100)
    tc.reset()
    jtc.reset()
    try:
        for hidden, want in ((1024, 32), (4096, 96), (768, None)):
            assert tc.layer_norm_block_rows(hidden) == want
            assert jtc.layer_norm_block_rows(hidden) == want
        # another card's name matches neither loader's entry
        monkeypatch.setattr(tc, "_backend_kind", lambda: "NVIDIA A100")
        monkeypatch.setattr(jtc, "_backend_kind", lambda: "NVIDIA A100")
        tc.reset()
        jtc.reset()
        want = 32 if backend is None else None
        assert tc.layer_norm_block_rows(1024) == want
        assert jtc.layer_norm_block_rows(1024) == want
    finally:
        tc.reset()
        jtc.reset()


def _ref_text(ref, rows, times_of):
    """The reference's ``tune(rows)`` output with its timer answering
    ``times_of(hidden, block_rows)`` seconds."""

    def fake_time_scan(step, x, args, iters=24, trials=3):
        return times_of(int(x.shape[1]), step.__defaults__[0])

    ref._time_scan = fake_time_scan
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        best = ref.tune(rows)
    return buf.getvalue(), best


def test_table_and_literal_are_the_references_text():
    ref = _ref_tool()
    rows = 16

    def times_of(hidden, br):
        # a bowl over the blocks, its floor at a width-dependent block,
        # and a tie between two blocks at 2048
        floor = {768: 16, 1024: 32, 2048: 64}.get(hidden, 128)
        if hidden == 2048 and br in (32, 64):
            return 4e-5
        return (1 + abs(br - floor) / 64) * hidden * 1e-8

    text, best = _ref_text(ref, rows, times_of)
    times = {}
    for hidden in ref.HIDDENS:
        times[hidden] = {br: times_of(hidden, br) for br in ref.BLOCKS
                         if br * hidden * 4 <= 8_000_000}
    mine = ln_tune.render_table(rows, "bfloat16", "cpu", ref.BLOCKS, times)
    assert text == mine + "\n"
    assert ln_tune.winners(times) == best
    # the skipped cells print as the reference's "-"
    assert "      -" in mine


def test_refuses_without_a_card(capsys):
    assert ln_tune.main(["--device", "cpu", "--hidden", "64"]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert ln_tune.main(["--hidden", "64"]) == 2

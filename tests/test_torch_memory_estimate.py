"""The peak-memory estimate of a recorded step (``analysis/memory.py``):
a fixture whose peak is known by construction, the 2x of a dropped
donation, the budget gate, the board gauges, and the reference's
attribution buckets."""

from __future__ import annotations

import pytest
import torch

from apex_tpu.analysis import memory as jmem
from apex_tpu_torch import analysis
from apex_tpu_torch.analysis import memory, passes

N = 4096          # f32 elements: 16 KiB, a multiple of the 512-byte round
NB = 4 * N


def _chain(x):
    a = x * 2.0        # op 0: a live
    b = a + 1.0        # op 1: a, b live (a's last use)
    c = b * 3.0        # op 2: b, c live
    return c.sum()     # op 3: c's last use


def test_peak_of_a_chain_is_two_activations_and_the_argument():
    _, rec = passes.capture(_chain, torch.zeros(N))
    est = memory.estimate_peak(rec)
    assert est["peak_bytes"] == NB + 2 * NB
    assert est["param_bytes"] == NB
    assert est["by_category"] == {"args": NB, "activations": 2 * NB}
    names = [b["name"] for b in est["buffers"]]
    assert names[0] == "arg0" or est["buffers"][0]["bytes"] == NB


def test_allocations_round_to_the_allocators_blocks():
    _, rec = passes.capture(lambda x: (x + 1.0) * 2.0, torch.zeros(3))
    est = memory.estimate_peak(rec)
    # a 12-byte argument and two 12-byte results: 512 bytes each
    assert est["peak_bytes"] == 3 * 512


def test_views_and_in_place_ops_cost_nothing():
    def step(x):
        y = x.view(64, 64)
        y.mul_(2.0)
        return y.t()

    _, rec = passes.capture(step, torch.zeros(N))
    assert memory.estimate_peak(rec)["peak_bytes"] == NB


def test_a_dropped_donation_reads_twice_the_state():
    state = {"m": torch.zeros(N), "v": torch.zeros(N)}

    def in_place(s):
        for t in s.values():
            t.add_(1.0)
        return s

    def copied(s):
        return {k: t + 1.0 for k, t in s.items()}

    peaks = {}
    for name, fn in (("in_place", in_place), ("copied", copied)):
        report = analysis.check(fn, {k: v.clone() for k, v in state.items()},
                                donate_argnums=(0,))
        peaks[name] = memory.estimate_peak(report.record)["peak_bytes"]
        assert (report.rule_ids() == ["donation-dropped"]) == \
            (name == "copied")
    assert peaks["copied"] == 2 * peaks["in_place"] == 4 * NB


def test_kernel_pointers_extend_live_ranges(monkeypatch):
    """A kernel launch reads its operands through raw pointers: the
    recorder maps them back, so the operand stays live to the launch."""
    import ctypes

    def step(x):
        a = x * 2.0
        b = a + 1.0
        for rec in list(_dispatch.RECORDERS):
            rec.note_launch("layer_norm_fwd", [ctypes.c_void_p,
                                               ctypes.c_int],
                            [a.data_ptr(), 1], None)
        return b

    from apex_tpu_torch.ops import _dispatch

    _, rec = passes.capture(step, torch.zeros(N))
    kernel = [op for op in rec.ops if op.kind == "kernel"]
    assert len(kernel) == 1 and kernel[0].meta["scalars"] == (1,)
    est = memory.estimate_peak(rec)
    # a is read at the launch, after b exists: x, a and b live together
    assert est["peak_bytes"] == 3 * NB


def test_budget_gate_names_the_top_buffers():
    report = analysis.check(_chain, torch.zeros(N), hbm_budget=2 * NB)
    assert report.rule_ids() == ["memory-budget"]
    msg = report.by_rule("memory-budget")[0].message
    assert "exceeds" in msg and "activations:%" in msg
    assert analysis.check(_chain, torch.zeros(N),
                          hbm_budget=3 * NB).findings == []


def test_publish_peak_gauges_the_board():
    from apex_tpu_torch.observability.metrics import board

    _, rec = passes.capture(_chain, torch.zeros(N))
    memory.publish_peak(memory.estimate_peak(rec), prefix="serve/hbm/test")
    assert board.get("serve/hbm/test/peak_hbm_bytes") == 3 * NB
    assert board.get("serve/hbm/test/peak_hbm/activations") == 2 * NB


def test_buffer_categories_are_the_references():
    assert memory.BUFFER_CATEGORIES == jmem.BUFFER_CATEGORIES


@pytest.mark.parametrize("path", [
    "state/opt/m/w", "params/blocks/0/attn/qkv/weight", "kv_cache/k",
    "batch/tokens", "arg0/scale", "arg3", "draft/kv_cache/v_scale",
    "master/w", "embed/wte",
])
def test_argument_categories_are_the_references(path):
    assert memory.categorize_buffer("parameter", path) == \
        jmem.categorize_buffer("parameter", path)


def test_collective_results_and_constants():
    assert memory.categorize_buffer("all-gather", "") == "collective"
    assert memory.categorize_buffer("constant", "") == "constants"
    assert memory.categorize_buffer("parameter", "") == "constants"


def test_attach_shard_sections_takes_the_largest_program():
    _, small = passes.capture(lambda x: x + 1.0, torch.zeros(N))
    _, big = passes.capture(_chain, torch.zeros(N))
    report = analysis.Report(target="serve")
    analysis.attach_shard_sections(report, [("a", small), ("b", big)])
    assert report.sections["peak_hbm_bytes"] == 3 * NB
    assert report.sections["peak_hbm_by_program"] == {"a": 2 * NB,
                                                     "b": 3 * NB}
    assert {r["path"] for r in report.sections["shard_plan"]} == {"arg0"}

"""apex_tpu_torch's profiler windows and step-time attribution vs the JAX
package's.

- ``parse_trace_spec`` and ``TraceScheduler``'s windows (start/stop calls,
  a rollback rewind, ``arm``, the span it records) equal the reference's
  over the same step sequences, both schedulers driven with recording
  start/stop functions; the real ``torch.profiler`` window writes a
  gzipped Chrome trace where ``load_trace_dir`` finds it.
- A hand-made kineto trace (kernel, memcpy and host events, the device
  events at the intervals of the reference's recorded fixture
  ``tests/data/attribution_trace_clean.json`` and its planted-gap twin)
  gives the reference parser's bucket ms, busy, stall, fractions and step
  period on that fixture — exactly (float sums in the same order; 1e-12
  where the order differs).  Host events, gloo's staged copies and
  CUDA-graph replays are handled as the port's docstring says.
- The cost model over a recorded step: ``instruction_flops`` of a recorded
  ``mm`` is exactly 2·M·N·K (the math of the reference's
  ``test_dot_flops_exact``), a toy train step's products are its matmul
  bucket's flops exactly, and ``roofline_report``/``publish_attribution``
  give the reference's rows and board keys for the same costs.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from apex_tpu.observability import attribution as JA
from apex_tpu.observability import trace as JT
from apex_tpu.observability.metrics import board as jboard
from apex_tpu_torch.observability import attribution as A
from apex_tpu_torch.observability import trace as T
from apex_tpu_torch.observability.metrics import board
from apex_tpu_torch.observability.spans import SpanRecorder

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _fixture(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the trace spec and the scheduler's windows
# ---------------------------------------------------------------------------

SPECS = ["7", "1200+3", "5..9", "  12 + 1 ", "3+2:/tmp/x", "4..4:rel/dir"]
BAD_SPECS = ["", "x", "5+0", "9..3", "1+2+3", "-1"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_trace_spec_equals_the_reference(spec):
    assert T.parse_trace_spec(spec) == JT.parse_trace_spec(spec)
    start, end, _ = T.parse_trace_spec(spec)
    assert T.window_dir("/b", start, end) == JT.window_dir("/b", start, end)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_trace_specs_raise_as_the_reference(spec):
    with pytest.raises(ValueError) as mine:
        T.parse_trace_spec(spec)
    with pytest.raises(ValueError) as ref:
        JT.parse_trace_spec(spec)
    assert str(mine.value) == str(ref.value)


def _drive(mod, spec, steps, tmp_path, arms=(), spans=None):
    calls = []
    sched = mod.TraceScheduler(
        spec=spec, base_dir=str(tmp_path), spans=spans,
        _start_fn=lambda d: calls.append(("start", os.path.relpath(
            d, tmp_path))),
        _stop_fn=lambda: calls.append(("stop",)),
    )
    for step in steps:
        for at, start, length in arms:
            if at == step:
                sched.arm(start, length)
        sched.on_step(step)
        calls.append(("state", step, sched.tracing, sched.active))
    sched.stop()
    return calls, (sched.start, sched.end, sched.log_dir is not None)


#: step sequences: a plain window, a rollback rewinding mid-window (the
#: capture aborts and is taken again on the replay), a resume landing
#: inside the window (never starts), an alert re-arming
SCENARIOS = {
    "plain": ("3+2", list(range(8)), ()),
    "rollback": ("3+3", [0, 1, 2, 3, 4, 2, 3, 4, 5, 6, 7], ()),
    "resume_inside": ("3+3", [4, 5, 6, 7], ()),
    "stop_in_window": ("5+10", list(range(8)), ()),
    "arm": ("", list(range(12)), ((2, 5, 2), (6, 9, 2))),
    "arm_future_kept": ("", list(range(12)), ((1, 4, 2), (2, 8, 2))),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_windows_equal_the_reference(name, tmp_path):
    spec, steps, arms = SCENARIOS[name]
    mine = _drive(T, spec, steps, tmp_path, arms)
    ref = _drive(JT, spec, steps, tmp_path, arms)
    assert mine == ref
    assert any(c[0] == "start" for c in mine[0]) == (name != "resume_inside")


def test_window_span_lands_on_the_recorder(tmp_path):
    rec = SpanRecorder(clock=iter(float(i) for i in range(100)).__next__)
    _drive(T, "2+2", [0, 1, 2, 3, 2, 3, 4, 5], tmp_path, spans=rec)
    windows = [e for e in rec.snapshot() if e["name"] == "trace/window"]
    assert [w["args"].get("aborted") for w in windows] == ["rollback", None]
    assert all(w["args"]["start_step"] == 2 and w["args"]["end_step"] == 3
               for w in windows)


def test_profiler_window_writes_a_trace_the_reader_finds(tmp_path):
    sched = T.TraceScheduler(spec=f"1+2:{tmp_path}")
    a = torch.randn(32, 32)
    for step in range(4):
        sched.on_step(step)
        with T.annotate("step"), T.nvtx_range("host"):
            (a @ a).sum()
    sched.stop()
    files = os.listdir(sched.log_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json.gz")
    trace = A.load_trace_dir(str(tmp_path))
    meas = A.attribute_trace(trace)
    # a CPU run has no device events: its top-level host ops
    assert meas.source == "host-ops" and meas.events > 0
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"step", "host", "aten::mm"} <= names
    T.range_push("x")
    T.range_pop()
    with pytest.raises(RuntimeError):
        T.range_pop()


# ---------------------------------------------------------------------------
# the measured trace: a kineto trace against the reference's fixture
# ---------------------------------------------------------------------------

#: the reference fixture's op rows -> a CUDA kernel of the same bucket
KERNEL_NAMES = {
    "dot.12": "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128",
    "loop_add_fusion.7": "void at::native::vectorized_elementwise_kernel"
                         "<4, at::native::CUDAFunctor_add<float>>",
    "all-reduce.5": "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)",
    "dot.13": "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT",
    "tanh.9": "void at::native::tanh_kernel_cuda<float>",
}


def _kineto(reference_trace):
    """The reference fixture's device op rows as kineto kernel events
    (same intervals), with the host side kineto records around them: the
    launches (``cuda_runtime``), the ops (``cpu_op``), the profiler's own
    span — none of which is device time."""
    events = [{"ph": "X", "cat": "Trace", "name": "PyTorch Profiler",
               "pid": "Spans", "tid": "PyTorch Profiler", "ts": 0,
               "dur": 5000}]
    corr = 100
    for e in reference_trace["traceEvents"]:
        if e.get("ph") != "X" or e["name"] not in KERNEL_NAMES:
            continue
        corr += 1
        events.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
                       "name": KERNEL_NAMES[e["name"]], "ts": e["ts"],
                       "dur": e["dur"], "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "cuda_runtime", "pid": 9,
                       "tid": 9, "name": "cudaLaunchKernel",
                       "ts": e["ts"] - 20, "dur": 5,
                       "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "cpu_op", "pid": 9, "tid": 9,
                       "name": "aten::mm", "ts": e["ts"] - 30, "dur": 15})
    return {"traceEvents": events}


@pytest.mark.parametrize("fixture", ["attribution_trace_clean.json",
                                     "attribution_trace_gap.json"])
def test_kineto_trace_gives_the_references_attribution(fixture):
    ref_trace = _fixture(fixture)
    want = JA.attribute_trace(ref_trace)
    got = A.attribute_trace(_kineto(ref_trace))
    assert got.source == want.source == "device-ops"
    assert got.events == want.events == 5
    for b in want.bucket_ms:
        assert got.bucket_ms[b] == pytest.approx(want.bucket_ms[b],
                                                 rel=0, abs=1e-12), b
    assert got.busy_ms == pytest.approx(want.busy_ms, rel=0, abs=1e-12)
    assert got.span_ms == want.span_ms
    assert got.stall_ms == want.stall_ms
    for key, val in want.fractions().items():
        assert got.fractions()[key] == pytest.approx(val, rel=0,
                                                     abs=1e-12), key
    assert got.compute_ms == pytest.approx(
        want.busy_ms - want.bucket_ms["collective"], rel=0, abs=1e-12)
    assert got.graph_note() is None
    assert A.trace_step_period(_kineto(ref_trace)) == \
        JA.trace_step_period(ref_trace) == 0.0


def test_step_period_equals_the_references():
    """The reference's step-period case (one op recurring every 1000 us
    but for one 50 ms gap) as kernel events: the same median period."""
    times = (0, 50_000, 51_000, 52_000, 53_000)
    ref = {"traceEvents": [{"ph": "X", "pid": 1, "tid": 1, "name": "dot.12",
                            "ts": ts, "dur": 10, "args": {}}
                           for ts in times]}
    kin = {"traceEvents": [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
                            "name": "flash_fwd_kernel<64>", "ts": ts,
                            "dur": 10} for ts in times]}
    assert A.trace_step_period(kin) == JA.trace_step_period(ref) == 1e-3
    assert A.attribute_trace(kin).layer_ms == {"K3 flash_fwd": 0.05}


def test_step_period_of_kernels_that_recur_within_a_step():
    """A step of kineto kernels repeats names (a GEMM a layer): the
    sequence repeats once a step, and its shift gives the step time (the
    consecutive-occurrence median would give the gap between layers)."""
    step = ["gemm", "ln_fwd_kernel", "gemm", "ln_fwd_kernel", "gemm",
            "multi_tensor_apply_kernel"]
    ev, t = [], 0.0
    for k in range(3):
        for j, name in enumerate(step):
            ev.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
                       "name": name, "ts": t + 10.0 * j, "dur": 5})
        t += 1000.0 + 7.0 * k
    period = A.trace_step_period({"traceEvents": ev[::-1]})
    assert period == pytest.approx(1007e-6)


def test_empty_trace_is_all_zero_not_nan():
    assert A.attribute_trace({"traceEvents": []}).fractions() == \
        JA.attribute_trace({"traceEvents": []}).fractions()


def test_gloo_staging_copies_are_collective():
    """A copy launched inside a gloo collective's host span is the
    collective's staging; the same copy outside one is not."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1,
         "name": "gloo:all_reduce", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 1,
         "name": "cudaMemcpyAsync", "ts": 110, "dur": 5,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 1,
         "name": "cudaMemcpyAsync", "ts": 300, "dur": 5,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7,
         "name": "Memcpy DtoH (Device -> Pinned)", "ts": 120, "dur": 40,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7,
         "name": "Memcpy DtoH (Device -> Pinned)", "ts": 310, "dur": 10,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "ln_fwd_kernel<1024>", "ts": 200, "dur": 50,
         "args": {"correlation": 9}},
    ]
    meas = A.attribute_trace({"traceEvents": ev})
    assert meas.bucket_ms["collective"] == pytest.approx(0.04)
    assert meas.bucket_ms["norm_elementwise"] == pytest.approx(0.05)
    assert meas.bucket_ms["other"] == pytest.approx(0.01)
    assert meas.kernel_events == {"other": 2, "K1 layer_norm_fwd": 1}
    assert meas.span_ms == pytest.approx(0.2)
    assert meas.stall_ms == pytest.approx(0.1)


@pytest.mark.parametrize("expanded", [True, False])
def test_graph_replays_are_reported_not_invented(expanded):
    ev = [{"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 1,
           "name": "cudaGraphLaunch", "ts": 0, "dur": 5,
           "args": {"correlation": 3}},
          {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
           "name": "paged_decode_kernel<64>", "ts": 10, "dur": 30,
           "args": {"correlation": 3 if expanded else 4}}]
    meas = A.attribute_trace({"traceEvents": ev})
    assert meas.graph_launches == 1
    assert meas.graph_kernel_events == (1 if expanded else 0)
    assert ("not in the trace" in meas.graph_note()) != expanded


def test_kernel_groups_are_one_table():
    rows = [("flash_fwd_kernel<64, true>", 1000.0, 2),
            ("flash_bwd_dq_kernel<64>", 500.0, 1),
            ("ln_bwd_kernel<1024>", 250.0, 4),
            ("nvjet_tst_64x8", 2000.0, 9),
            ("elementwise_kernel", 125.0, 3)]
    got = A.group_kernels(rows)
    assert got["K3 flash_fwd"] == 1.0 and got["K4 flash_bwd"] == 0.5
    assert got["K2 layer_norm_bwd"] == 0.25 and got["cuBLAS GEMMs"] == 2.0
    assert got["other"] == 0.125
    assert set(got) == {g for g, _, _ in A.KERNEL_GROUPS} | {"other"}
    assert A.kernel_layer("paged_decode_kernel<64, 16>") == (
        "K6 paged_decode", "attention")


# ---------------------------------------------------------------------------
# the cost model over a recorded step
# ---------------------------------------------------------------------------


def _record(fn, *args):
    from apex_tpu_torch.analysis import passes

    _, record = passes.capture(fn, *args)
    return record


@pytest.mark.parametrize("m,k,n", [(64, 32, 16), (7, 5, 3), (1, 128, 1)])
def test_recorded_mm_flops_are_exact(m, k, n):
    from apex_tpu_torch.analysis import hlo as H

    rs = np.random.RandomState(0)
    a = torch.from_numpy(rs.randn(m, k).astype(np.float32))
    b = torch.from_numpy(rs.randn(k, n).astype(np.float32))
    record = _record(lambda x, y: torch.mm(x, y), a, b)
    comps, entry = H.parse_computations(record)
    (mm,) = [i for i in comps[entry] if i["opcode"].startswith("aten.mm")]
    assert H.instruction_flops(mm) == 2.0 * m * n * k
    cost = A.attribute_cost_model(record, device_kind="", peak_flops=1.0,
                                  hbm_bw=1.0, ici_bw=1.0)
    assert cost.buckets["matmul"]["flops"] == 2.0 * m * n * k


def test_toy_train_step_is_matmul_bound():
    """A two-layer step (forward, backward, SGD): its matmul bucket holds
    exactly the five products' 2·M·N·K (x has no gradient) and the other
    buckets' flops are the elementwise work, a few percent of it."""
    d, batch = 64, 32
    rs = np.random.RandomState(0)
    w1, w2 = (torch.from_numpy(rs.randn(d, d).astype(np.float32) * 0.1)
              .requires_grad_() for _ in range(2))
    x, y = (torch.from_numpy(rs.randn(batch, d).astype(np.float32))
            for _ in range(2))

    def step(w1, w2, x, y):
        loss = ((torch.tanh(x @ w1) @ w2 - y) ** 2).mean()
        g1, g2 = torch.autograd.grad(loss, (w1, w2))
        with torch.no_grad():
            return w1 - 1e-2 * g1, w2 - 1e-2 * g2, loss

    cost = A.attribute_cost_model(_record(step, w1, w2, x, y),
                                  device_kind="NVIDIA H100 80GB HBM3")
    assert cost.buckets["matmul"]["flops"] == 5 * 2.0 * batch * d * d
    assert cost.buckets["matmul"]["flops"] > 0.9 * cost.total_flops
    assert cost.fractions()["host_stall"] == 0.0
    assert sum(cost.bucket_fractions().values()) == pytest.approx(1.0)
    mine = A.hlo_bucket_map(_record(step, w1, w2, x, y))
    assert "matmul" in mine.values()


@pytest.mark.parametrize("target,causal,products", [
    ("flash_fwd", True, 2), ("flash_fwd", False, 2),
    ("flash_bwd", True, 5), ("flash_bwd_dbias", False, 5),
    ("layer_norm_fwd", False, 0)])
def test_kernel_nodes_cost_their_products(target, causal, products):
    """A recorded K3/K4 launch costs its products from its scalars (bh, sq,
    sk, d, groups, rows, scale, causal lead them: the C argument order):
    2·D flops a pair and product, half the pairs when causal; the other
    kernels are costed by their bytes."""
    bh, s, d = 16, 256, 64
    instr = {"kind": "kernel", "target": target,
             "attrs": {"scalars": (bh, s, s, d, 1, s, 0.125, causal)}}
    want = 2.0 * products * bh * s * s * d / (2 if causal else 1)
    assert A._kernel_flops(instr) == want


def _costs(mod):
    ops = [mod.OpCost("dot.1", "dot", "dot", "matmul", 4e12, 3 * 2**30),
           mod.OpCost("fusion.2", "fusion", "add", "norm_elementwise", 1e9,
                      2**30),
           mod.OpCost("ar.3", "all-reduce", "ar", "collective", 0.0, 2**28),
           mod.OpCost("flash.4", "custom-call", "flash", "attention", 2e12,
                      2**29)]
    return mod.CostAttribution(ops, 989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("measured", [False, True])
def test_roofline_and_publication_equal_the_references(measured):
    mine, ref = _costs(A), _costs(JA)
    assert mine.fractions() == ref.fractions()
    meas_m = meas_r = None
    if measured:
        trace = _fixture("attribution_trace_gap.json")
        meas_r = JA.attribute_trace(trace)
        meas_m = A.attribute_trace(_kineto(trace))
    rows_m = A.roofline_report(mine, step_time_s=0.02, measured=meas_m)
    rows_r = JA.roofline_report(ref, step_time_s=0.02, measured=meas_r)
    assert len(rows_m) == len(rows_r)
    for a, b in zip(rows_m, rows_r):
        assert a.bucket == b.bucket and a.bound == b.bound
        np.testing.assert_allclose(tuple(a)[1:7], tuple(b)[1:7], rtol=1e-12)
    assert A.render_roofline(rows_m).splitlines()[0] == \
        JA.render_roofline(rows_r).splitlines()[0]
    board.clear()
    jboard.clear()
    src_m = meas_m if measured else mine
    src_r = meas_r if measured else ref
    fr_m = A.publish_attribution(src_m, step=3)
    fr_r = JA.publish_attribution(src_r, step=3)
    assert fr_m == pytest.approx(fr_r, rel=0, abs=1e-12)
    assert sorted(board.snapshot()) == sorted(jboard.snapshot())
    board.clear()
    jboard.clear()


def test_chrome_trace_of_the_cpu_profiler_parses(tmp_path):
    """``trace()`` around a block writes one gzipped JSON whose events the
    attribution selects (top-level host ops only: nothing nested twice)."""
    with T.trace(str(tmp_path)):
        a = torch.randn(16, 16)
        torch.tanh(a @ a)
    (name,) = os.listdir(tmp_path)
    with gzip.open(tmp_path / name, "rt") as f:
        trace = json.load(f)
    meas = A.attribute_trace(trace)
    tops = [e["name"] for e in A._top_level_host_ops(
        [e for e in trace["traceEvents"] if e.get("ph") == "X"])]
    assert "aten::mm" not in tops or "aten::matmul" not in tops
    assert meas.busy_ms <= meas.span_ms + 1e-9

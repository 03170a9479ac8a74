"""``apex_tpu_torch.tools.comm_structure`` against ``tools/comm_structure.py``.

- ``ring_traffic_bytes`` and ``cp_ring_balance_model`` equal the
  reference's (both pure Python) on the same inputs;
- the tp + SP ``GptBlock`` step (its backward, the sequence-parallel
  gradients' all-reduce and a FusedAdam update) at world 2 on tiny widths,
  run on two gloo ranks and read from the recorded step, against the
  reference's compiled step on two CPU devices (h 64, 4 heads, 256 MLP,
  seq 32, batch 2).  In f32 the all-gathers and reduce-scatters are the
  reference's in count and bytes, and the all-reduces in bytes.  Two
  divergences are kept, each for its reason: the reference's six small
  sequence-parallel gradient all-reduces reach the HLO as ONE (XLA's
  all-reduce combiner merges them; the port issues the calls eagerly, one
  a parameter), and its bf16 step's collectives are f32 in the HLO
  (XLA:CPU upcasts bf16 collectives) where the port's bf16 step moves
  bf16 — half the bytes, as ``tp_sp_block_plan`` says;
- ResNet (SyncBatchNorm) with DDP at world 2, on the f32 and the int8
  wire: the recorded gradient sync holds to the port's ``sync_plan`` (the
  trainer's plan check finds nothing) and equals its exact summary;
- a row's keys are the reference artifact's (``COMM_STRUCTURE_r05.json``)
  but for the reference's compiled-schedule ``overlap`` counters, null
  here; the tool refuses without a card unless ``--device cpu``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from apex_tpu_torch.tools import comm_structure as cs

ROOT = Path(__file__).resolve().parents[1]
#: the tiny tp block: hidden, heads, MLP, seq, batch
TINY = dict(hidden=64, heads=4, inter=256, seq=32, batch=2)
#: the small ResNet of the DDP case (the collectives' structure is the
#: same at every depth; ResNet-50 runs on the card)
SMALL_RESNET = dict(stage_sizes=(1, 1, 1, 1), width=8, image=32)


def _ref_tool():
    spec = importlib.util.spec_from_file_location(
        "ref_comm_structure", ROOT / "tools" / "comm_structure.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return _ref_tool()


@pytest.mark.parametrize("world", [2, 4, 8])
def test_ring_traffic_and_balance_model_equal_the_references(ref, world):
    kinds = {"all-reduce": {"count": 3, "bytes": 1536},
             "all-gather": {"count": 4, "bytes": 65536},
             "reduce-scatter": {"count": 4, "bytes": 32768},
             "collective-permute": {"count": 2, "bytes": 4096},
             "all-to-all": {"count": 1, "bytes": 386360}}
    assert cs.ring_traffic_bytes(kinds, world) == \
        ref.ring_traffic_bytes(kinds, world)
    assert cs.cp_ring_balance_model(world) == \
        ref.cp_ring_balance_model(world)


@pytest.fixture(scope="module")
def tp_runs(ref):
    want, flops, _ = ref.tp_gpt_structure(2, **TINY)
    got = {dt: cs.tp_gpt_structure(2, **TINY, device="cpu", dtype=dt)
           for dt in ("float32", "bfloat16")}
    return want, flops, got


def test_tp_sp_block_collectives_equal_the_references(tp_runs):
    want, ref_flops, got = tp_runs
    kinds, flops, _ = got["float32"]
    assert flops == ref_flops
    assert set(kinds) == set(want)
    for kind in ("all-gather", "reduce-scatter"):
        assert kinds[kind] == want[kind], kind
    # the same bytes; the count is the kept divergence (XLA's combiner)
    assert kinds["all-reduce"]["bytes"] == want["all-reduce"]["bytes"]
    assert (kinds["all-reduce"]["count"], want["all-reduce"]["count"]) == (
        6, 1)


def test_tp_sp_block_bf16_is_its_plan(tp_runs):
    want, _, got = tp_runs
    kinds, _, _ = got["bfloat16"]
    h, seq, batch = TINY["hidden"], TINY["seq"], TINY["batch"]
    assert kinds == cs.tp_sp_block_plan(2, h, seq, batch, elem_bytes=2)
    assert kinds == {k: {"count": v["count"], "bytes": v["bytes"]}
                     for k, v in got["float32"][0].items()
                     } | {k: {"count": 4, "bytes": want[k]["bytes"] // 2}
                          for k in ("all-gather", "reduce-scatter")}


@pytest.mark.parametrize("quantized", [False, True])
def test_ddp_syncbn_gradient_sync_is_the_plan(quantized):
    details = {}
    kinds, flops, _ = cs.ddp_syncbn_structure(
        2, quantized=quantized, device="cpu", details=details,
        **SMALL_RESNET)
    assert flops is None
    assert cs.check_ddp(details, 2, quantized) == []
    sync = cs.ddp_sync_summary(details["sizes"], 2, quantized)
    # the rest of the step's all-reduces are SyncBatchNorm's statistics
    for kind, rec in sync.items():
        if kind != "all-reduce":
            assert kinds[kind] == rec
    bn = kinds["all-reduce"]["count"] - sync["all-reduce"]["count"]
    assert bn > 0 and bn % 2 == 0  # a forward and a backward a norm
    # a planted fault: a gradient synced twice fails the check
    doubled = dict(details, grad_sync=details["grad_sync"]
                   + details["grad_sync"][-1:])
    assert cs.check_ddp(doubled, 2, quantized)


def test_rows_keep_the_reference_artifacts_keys():
    rows = [json.loads(line) for line in
            (ROOT / "COMM_STRUCTURE_r05.json").read_text().splitlines()]
    kinds = {"all-gather": {"count": 4, "bytes": 65536},
             "reduce-scatter": {"count": 4, "bytes": 32768},
             "all-reduce": {"count": 6, "bytes": 1536}}
    for ref_row in rows:
        name = ref_row["config"]
        if name == "cp_ring_causal_balance":
            continue
        flops = ref_row.get("per_chip_gemm_flops")
        mine = cs.config_record(name, kinds, flops, 8, cs.NVLINK_GBPS,
                                cs.PEAK_TFLOPS)
        assert set(mine) == set(ref_row), name
        assert mine["overlap"] is None
        assert mine["analytic_comm_ms_nonoverlapped"] == \
            mine["analytic_comm_ms"]
    # the analytic fields are the reference's formulas
    row = cs.config_record("tp_gpt_block", kinds, 9437184.0, 2, 450.0,
                           989.0)
    traffic = cs.ring_traffic_bytes(kinds, 2)
    comm_s, comp_s = traffic / 450e9, 9437184.0 / 989e12
    assert row["analytic_comm_ms"] == round(comm_s * 1e3, 4)
    assert row["analytic_comm_fraction"] == round(comm_s / (comm_s + comp_s),
                                                  4)
    assert sorted(cs.CONFIGS) == sorted(
        r["config"] for r in rows if r["config"] != "cp_ring_causal_balance")


def test_the_tool_defaults_to_the_card():
    args = cs.build_parser().parse_args([])
    assert (args.world, args.device, args.ici_gbps, args.peak_tflops) == (
        8, "cuda", 450.0, 989.0)
    assert args.out.endswith("build/COMM_STRUCTURE_torch.json")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cs.main(["--config", "cp_ring_causal_balance"])

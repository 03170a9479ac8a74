"""The kernel passes over the CUDA launch plans (``analysis/kernels.py``,
the op modules' ``kernel_specs``, ``ops/introspect.py``) and the
meter's bucket and shared-memory tables.

The dead-tile accounting and the operations the tiles execute equal the
reference's at the same tiles and sequence lengths; the roofline's bound
gives ``PERF.md`` §6's bound column for every main-path row; each pass
catches its planted plan; the occupancy model and the launch-signature
path run on the CPU (the card holds the plans to its own figures:
``chip_smoke.py`` phase 23c)."""

from __future__ import annotations

import ctypes
import dataclasses

import pytest

from apex_tpu.analysis import kernels as jk
from apex_tpu.observability import meter as jmeter
from apex_tpu.ops.pallas import flash_attention as fa
from apex_tpu_torch.analysis import kernels
from apex_tpu_torch.observability import meter
from apex_tpu_torch.ops import _dispatch, introspect
from apex_tpu_torch.ops import attention as attn
from apex_tpu_torch.ops import layer_norm as ln
from apex_tpu_torch.ops import paged_attention as pa

SHAPES = [(4, 256, 256, 64), (2, 200, 330, 32), (8, 1024, 1024, 128),
          (3, 64, 200, 64), (1, 2048, 2048, 256)]


@pytest.mark.parametrize("bh,sq,sk,d", SHAPES)
def test_dead_tiles_and_flops_are_the_references(bh, sq, sk, d):
    """At the kernels' 64 x 64 walk (the reference's tiles set to it) the
    live/dead tiles, the waste and the executed operations of K3 and of
    both K4 passes equal the reference's (S_q <= S_k: the reference's dQ
    pass skips the fully masked rows the port's walks)."""
    ref = fa.kernel_specs(bh, sq, sk, d, block_q=64, block_k=64,
                          block_q_dq=64, block_k_dq=64)
    mine = attn.kernel_specs(bh, sq, sk, d, defines=())
    assert [s.name for s in ref] == ["flash_fwd", "flash_bwd_dkdv",
                                     "flash_bwd_dq"]
    assert len(mine) == 3
    for r, m in zip(ref, mine):
        assert kernels.dead_tile_stats(m) == jk.dead_tile_stats(r)
        assert kernels.roofline(m)["flops"] == pytest.approx(
            jk.roofline(r, device_kind="TPU v5 lite")["flops"], rel=1e-12)


def test_non_causal_has_no_dead_tiles():
    spec = attn.kernel_specs(4, 128, 128, 64, causal=False, defines=())[0]
    assert kernels.dead_tile_stats(spec) is None
    ref = fa.kernel_specs(4, 128, 128, 64, causal=False, block_q=64,
                          block_k=64)[0]
    assert kernels.roofline(spec)["flops"] == jk.roofline(
        ref, device_kind="TPU v5 lite")["flops"]


#: PERF.md §6's bound column (ms, 4 decimals) for the main-path rows
PERF_BOUNDS = {
    "flash_attention/gpt": [(0.0695, "operations"), (0.1738, "operations"),
                            (0.1738, "operations")],
    "flash_attention/bert": [(0.0410, "bytes"), (0.0711, "bytes"),
                             (0.0711, "bytes")],
    "flash_attention/triangle": [(0.1011, "bytes"), (0.1963, "bytes"),
                                 (0.1963, "bytes"), (0.1812, "bytes")],
    "flash_attention/msa_row_f32": [(0.0806, "bytes"), (0.1302, "operations"),
                                    (0.1302, "operations"),
                                    (0.1207, "bytes")],
    "layer_norm": [(0.0201, "bytes"), (0.0301, "bytes")],
    "paged_decode": [(0.0071, "bytes"), (0.0038, "bytes")],
}


@pytest.mark.parametrize("label", sorted(PERF_BOUNDS))
def test_roofline_gives_the_perf_bound_column(label):
    specs = dict(kernels.default_kernel_specs())[label]
    got = [(round(kernels.roofline(s)["bound_ms"], 4),
            kernels.roofline(s)["bound_by"]) for s in specs]
    assert got == PERF_BOUNDS[label]


def test_default_kernels_lint_clean():
    report = kernels.analyze_default_kernels()
    assert report.errors() == [] and report.warnings() == []
    assert set(report.pass_timings) == set(kernels.KERNEL_PASSES)
    assert len(report.sections["kernels"]) == 18


def _spec(**over):
    base = attn.kernel_specs(16, 512, 512, 64, defines=())[0]
    return dataclasses.replace(base, **over)


@pytest.mark.parametrize("over,rule", [
    (dict(smem_bytes=240 * 1024), "kernel-vmem-overflow"),
    (dict(mma={"op": "wgmma", "m": 32, "n": 64, "k": 16,
               "dtype": "bfloat16"}), "kernel-tile-misaligned"),
    (dict(mma={"op": "wgmma", "m": 64, "n": 64, "k": 8,
               "dtype": "bfloat16"}), "kernel-tile-misaligned"),
    (dict(tma=((512, 128),)), "kernel-tile-misaligned"),
    (dict(tma=((64, 100),)), "kernel-tile-misaligned"),
    (dict(items={"n_items": 100, "per_cta": "one"}), "kernel-grid-oob"),
    (dict(causal={"causal": True, "bq": 1024, "bk": 64, "nq": 1, "nk": 16,
                  "offset": 0, "include_fully_masked": True, "heads": 1}),
     "kernel-dead-tiles"),
])
def test_each_pass_catches_its_planted_plan(over, rule):
    assert kernels.analyze(_spec()).findings == []
    assert kernels.analyze(_spec(**over)).rule_ids() == [rule]


def test_two_launches_of_one_call_writing_one_output_race():
    dkdv, dq = attn.kernel_specs(16, 512, 512, 64, modes=("bwd",),
                                 defines=())
    assert kernels.analyze([dkdv, dq]).findings == []
    bad = dataclasses.replace(dq, writes=("dq", "dk"))
    bad.work = dkdv.work
    assert kernels.analyze([dkdv, bad]).rule_ids() == ["kernel-block-race"]


def test_tuned_defines_change_the_plan():
    default = attn.kernel_specs(16, 512, 512, 64, defines=())
    tuned = attn.kernel_specs(
        16, 512, 512, 64, defines=("APEX_FLASH_FWD_BLOCK_K=64",
                                   "APEX_FLASH_FWD_STAGES=2",
                                   "APEX_FLASH_BWD_STAGES=2"))
    assert (default[0].tile["block_k"], default[0].stages) == (128, 3)
    assert (tuned[0].tile["block_k"], tuned[0].stages) == (64, 2)
    assert tuned[0].smem_bytes < default[0].smem_bytes
    assert tuned[1].stages == 2 and default[1].stages == 3


def test_occupancy_model():
    k3 = attn.kernel_specs(128, 2048, 2048, 64, defines=())[0]
    assert kernels.occupancy(k3, regs=168, static_smem=0) == 1
    k1 = ln.kernel_specs(16384, 1024)[0]
    assert kernels.occupancy(k1, regs=32) == 8
    assert kernels.occupancy(k1, regs=64) == 4
    assert kernels.occupancy(k1, regs=255) == 1
    with pytest.raises(KeyError, match="no SM limits"):
        kernels.occupancy(k1, regs=32, device_kind="TPU v5 lite")


def test_meter_buckets_and_shared_memory():
    assert meter.BUCKETS == jmeter.BUCKETS
    assert meter.smem_bytes_for("NVIDIA H100 80GB HBM3") == 227 * 1024
    with pytest.raises(ValueError, match="no shared memory known"):
        meter.smem_bytes_for("TPU v5 lite")
    for name, bucket in (
            ("void (anonymous namespace)::flash_fwd_kernel<64, 0, false>",
             "attention"),
            ("paged_decode_kernel<__nv_bfloat16, signed char>", "attention"),
            ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "matmul"),
            ("ln_fwd_kernel<__nv_bfloat16, 8, 32>", "norm_elementwise"),
            ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective"),
            ("vectorized_elementwise_kernel<4, CUDAFunctor_add>",
             "norm_elementwise"),
            ("at::native::index_kernel", "other")):
        assert meter.categorize_op("", name) == bucket, name
    assert meter.categorize_op("aten.mm.default") == "matmul"
    assert meter.categorize_op("custom-call", "flash_bwd") == "attention"


def _sig(argtypes, args):
    return _dispatch.signature(argtypes, args)


def test_signatures_rebuild_every_entrys_plan():
    """A recorded launch (its pointers reduced to their class) rebuilds
    the wrapper's plan: the same instances as ``kernel_specs``."""
    a16, a4 = 1 << 20, (1 << 20) + 4
    fwd = _sig(attn._FWD_ARGS[:-1], (a16,) * 3 + (a16, None) + (a16,) * 4 + (
        2048, 128, 128, 64, 128, 1, 0.125, 0, 0, 1.0))
    assert fwd[3] == 16 and fwd[4] == 0
    got = introspect.specs_from_launch("flash_fwd", fwd)
    want = attn.kernel_specs(2048, 128, 128, 64, causal=False,
                             bias_shape=(128, 1), defines=())[0]
    assert got[0].full_name == want.full_name == "flash_fwd_kernel<64, 1, false>"
    assert got[0].smem_bytes == want.smem_bytes
    bwd = _sig(attn._BWD_DBIAS_ARGS[:-1], (a16,) * 8 + (None,) + (a16,) * 4
               + (1024, 256, 256, 32, 1024, 256, 0.17, 0, 0, 1.0))
    names = [s.full_name for s in introspect.specs_from_launch(
        "flash_bwd_dbias", bwd)]
    assert names == ["flash_bwd_dkdv_kernel<32, 2, false>",
                     "flash_bwd_dq_dbias_kernel<32, 2, false>"]
    # a misaligned bias takes the global-memory mode
    bwd_g = _sig(attn._BWD_DBIAS_ARGS[:-1], (a16,) * 7 + (a4, None)
                 + (a16,) * 4
                 + (1024, 256, 256, 32, 1024, 256, 0.17, 0, 0, 1.0))
    assert introspect.specs_from_launch("flash_bwd_dbias", bwd_g)[0].instance \
        == "<32, 1, false>"
    f32 = _sig(attn._DBIAS_ARGS[:-1], (a16,) * 8 + (None, a16) + (
        512, 256, 256, 64, 512, 256, 0.125, 0, 0, 1.0))
    assert [s.full_name for s in introspect.specs_from_launch(
        "flash_dbias_f32", f32)] == ["flash_dbias_f32_kernel<64, false, "
                                     "true, false>"]
    wide = introspect.specs_from_launch("flash_fwd", fwd[:12] + (384,)
                                        + fwd[13:])
    assert wide[0].name == "flash_fwd_wide_kernel"
    lnf = _sig(ln._FWD_ARGS[:-1], (a16,) * 6 + (16384, 1024, 1e-5, 0, 1, 8,
                                                32, 32, 1056))
    assert introspect.specs_from_launch("layer_norm_fwd", lnf)[0].full_name \
        == "ln_fwd_kernel<__nv_bfloat16, 8, 32>"
    lnb = _sig(ln._BWD_ARGS[:-1], (a16,) * 8 + (64, 33, 0, 0, 0, 1, 4, 16,
                                                 4))
    assert introspect.specs_from_launch("layer_norm_bwd", lnb)[0].full_name \
        == "ln_bwd_kernel<float, 1, 4>"
    k6 = _sig(pa._ARGS[:-1], (a16,) * 3 + (None, None) + (a16,) * 5 + (
        8, 16, 64, 16, 128, 0.125, 1, 1, a16, a16, 4, 32))
    spec = introspect.specs_from_launch("paged_decode", k6)[0]
    assert spec.full_name == \
        "paged_decode_kernel<__nv_bfloat16, __nv_bfloat16>"
    assert spec.grid == 8 * 16 * 32
    with pytest.raises(KeyError):
        introspect.specs_from_launch("no_such_kernel", ())


def test_signature_classes_pointers():
    types = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]
    assert _dispatch.signature(types, [0, 7, 32, 36, 37]) == (0, 7, 16, 4, 1)
    assert introspect.pointer_class(None) == 0


def test_signature_log_is_off_by_default():
    assert _dispatch.SIGNATURES is None
    _dispatch.record_signatures(True)
    try:
        assert _dispatch.launch_signatures() == {}
    finally:
        _dispatch.record_signatures(False)
    assert _dispatch.launch_signatures() == {}

"""apex_tpu_torch's structural contracts, checked without a GPU.

- the port and ``chip_smoke.py`` import neither ``jax`` nor ``apex_tpu``
  (AST scan of every module);
- entry points (the GPT and BERT models, the engine, the converters,
  the example trainers and the OpenFold modules) run on the card by
  default and raise without one, unless the caller passes
  ``device="cpu"``;
- kernel wrappers launch their kernel or raise: handed CPU tensors, a
  kernel entry refuses instead of computing the plain version, and a
  kernel that cannot be built raises; a trainable attention bias on the
  card goes through K5;
- every kernel source carries its note (what it replaces, its bound on
  the card, what its design does about it);
- K3 and K4 are built for Hopper (TMA, mbarriers, wgmma, no wmma), K4
  has no atomics, their C argument lists stay as the wrappers declare
  them, and no kernel links libcuda;
- K5's f32 instance multiplies on the tensor cores (3xTF32 ``mma.sync``,
  no FFMA tile loop) through a cp.async ring and, like K6, uses no float
  atomic or reduction; K6 loads through cp.async, and its C arguments
  match the wrapper's list.
"""

import ast
import ctypes
import re
from pathlib import Path

import pytest
import torch

from apex_tpu_torch.contrib.openfold import DAPAxialBlock, EvoformerBlock
from apex_tpu_torch.models import (
    BertConfig,
    BertForPreTraining,
    GptConfig,
    GptModel,
    bert_from_jax_params,
    from_jax_params,
)
from apex_tpu_torch.ops import _build, _dispatch
from apex_tpu_torch.examples import pretrain_bert, train_gpt
from apex_tpu_torch.ops import attention
from apex_tpu_torch.ops.attention import flash_bwd, flash_dbias, flash_fwd
from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
from apex_tpu_torch.ops.paged_attention import paged_decode_fwd
from apex_tpu_torch.ops import paged_attention
from apex_tpu_torch.serve import InferenceEngine, ServeConfig, init_kv_pages

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=32, hidden_size=32, num_layers=1, num_heads=2,
            intermediate_size=64, max_seq_len=64, dtype=torch.float32)
TINY_BERT = dict(vocab_size=32, hidden_size=32, num_layers=1, num_heads=2,
                 intermediate_size=64, max_position_embeddings=64,
                 dtype=torch.float32)


def _port_files():
    return sorted((ROOT / "apex_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"
    ]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_apex_tpu():
    files = _port_files()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    bad = [
        (p.relative_to(ROOT).as_posix(), mod)
        for p in files
        for mod in _imported_modules(p)
        if mod.split(".")[0] in ("jax", "jaxlib", "apex_tpu", "flax")
    ]
    assert bad == []


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["model", "engine", "convert", "train",
                                   "bert_model", "bert_convert",
                                   "bert_train", "evoformer", "dap_axial",
                                   "kv_pages"])
def test_entry_points_default_to_the_card(no_gpu, entry):
    cfg = GptConfig(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "model":
            GptModel(cfg)
        elif entry == "engine":
            InferenceEngine(cfg, GptModel(cfg, device="cpu"),
                            ServeConfig(max_pages_per_seq=4))
        elif entry == "convert":
            from_jax_params({}, cfg)
        elif entry == "train":
            train_gpt.main(["--tiny", "--steps", "1"])
        elif entry == "bert_model":
            BertForPreTraining(BertConfig(**TINY_BERT))
        elif entry == "bert_convert":
            bert_from_jax_params({}, BertConfig(**TINY_BERT))
        elif entry == "evoformer":
            EvoformerBlock(16, 8, 2)
        elif entry == "dap_axial":
            DAPAxialBlock(16, 2)
        elif entry == "kv_pages":
            init_kv_pages(1, 4, 2, 16, 8)
        else:
            pretrain_bert.main(["--tiny", "--steps", "1"])


def test_cpu_runs_when_asked(no_gpu):
    cfg = GptConfig(**TINY)
    eng = InferenceEngine(cfg, GptModel(cfg, device="cpu"),
                          ServeConfig(max_pages_per_seq=4), device="cpu")
    _, tok = eng.prefill([1, 2, 3], eng.pool.alloc(1))
    assert 0 <= tok < cfg.vocab_size


def test_kernel_entries_refuse_cpu_tensors():
    x = torch.zeros(4, 32)
    w = torch.ones(32)
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_fwd(x, w, w, eps=1e-5, rms=False)
    stats = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_bwd(x, w, w, stats, stats, x, rms=False,
                       x_is_output=False)
    q = torch.zeros(2, 16, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd(q, q, q, scale=0.125, causal=True)
    stats = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd(q, q, q, q, stats, stats, stats, scale=0.125, causal=True)
    bias = torch.zeros(1, 1, 16)
    seed = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd(q, q, q, bias, scale=0.125, causal=False, dropout_p=0.1,
                  seed=seed)
    pages = torch.zeros(4, 2, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_fwd(
            torch.zeros(1, 2, 64), pages, pages,
            torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), scale=0.125,
        )


@pytest.mark.parametrize("bias_rows,dropout_p", [(16, 0.0), (1, 0.1)])
def test_flash_dbias_refuses_cpu_tensors(bias_rows, dropout_p):
    q = torch.zeros(2, 16, 32, dtype=torch.bfloat16)
    stats = torch.zeros(2, 16)
    seed = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_dbias(q, q, q, q, stats, stats, stats,
                    torch.zeros(2, bias_rows, 16), scale=0.125, causal=False,
                    dropout_p=dropout_p, seed=seed)


@pytest.mark.parametrize("bias_grad", [True, False])
def test_trainable_bias_on_the_card_launches_k5(monkeypatch, bias_grad):
    """On the card a trainable bias goes through K3, K4 and K5 (and a
    mask-only bias through K3 and K4), with no plain path in between.
    The kernel wrappers are stood in for by their twins, counted."""
    monkeypatch.setattr(_dispatch, "on_card", lambda *tensors: True)
    calls = []
    for name in ("flash_fwd", "flash_bwd", "flash_dbias"):
        twin = getattr(attention, name + "_reference")

        def wrapper(*args, _name=name, _twin=twin, **kwargs):
            calls.append(_name)
            return _twin(*args, **kwargs)

        monkeypatch.setattr(attention, name, wrapper)
    q = torch.randn(1, 2, 16, 32, requires_grad=True)
    bias = torch.randn(1, 2, 16, 16, requires_grad=True)
    attention.flash_attention(q, q, q, bias, bias_grad=bias_grad).sum().backward()
    if bias_grad:
        assert calls == ["flash_fwd", "flash_bwd", "flash_dbias"]
        assert bias.grad.shape == bias.shape
    else:
        assert calls == ["flash_fwd", "flash_bwd"] and bias.grad is None


def test_device_rule():
    cpu = torch.zeros(2)
    assert _dispatch.on_card(cpu, cpu) is False
    with pytest.raises(ValueError, match="devices"):
        _dispatch.on_card(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        _dispatch.resolve_device("meta")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("paged_decode")


def test_build_dir(monkeypatch, tmp_path):
    # a checkout builds under its own build/; an installed copy under the
    # per-user cache
    assert _build._build_dir() == _build._PKG.parent / "build" / "apex_tpu_torch"
    monkeypatch.setattr(_build, "_PKG", tmp_path / "site" / "apex_tpu_torch")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build._build_dir() == tmp_path / "cache" / "apex_tpu_torch"


def test_launch_counters():
    _dispatch.reset_launches()
    _dispatch.count_launch("layer_norm_fwd")
    _dispatch.count_launch("layer_norm_fwd")
    assert _dispatch.launches() == {"layer_norm_fwd": 2}
    _dispatch.reset_launches()
    assert _dispatch.launches() == {}


@pytest.mark.parametrize("name", _build.KERNELS)
def test_kernel_sources_carry_their_note(name):
    src = _build.source_path(name).read_text()
    head = src.split("#include")[0]
    for field in ("Replaces:", "apex_tpu/ops/pallas/", "Bound on the H100:",
                  "Design:"):
        assert field in head, (name, field)
    assert 'extern "C"' in src and "cudaGetLastError" in src


def _translation_unit(name):
    """Kernel ``name``'s source with the csrc headers it includes: what
    nvcc compiles."""
    src = _build.source_path(name).read_text()
    csrc = _build.source_path(name).parent
    headers = [csrc / h for h in
               re.findall(r'#include "([^"]+)"', src)]
    return src, "\n".join([src] + [h.read_text() for h in headers])


def _code(text):
    """``text`` without its // comments."""
    return "\n".join(line.split("//")[0] for line in text.splitlines())


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd"])
def test_flash_kernels_run_on_wgmma_and_tma(name):
    """K3 and K4 load through TMA into an mbarrier ring and multiply on
    wgmma; no wmma fragment is left."""
    src, tu = _translation_unit(name)
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor",
                "mbarrier.try_wait", "mbarrier.arrive.expect_tx",
                "setmaxnreg"):
        assert ptx in tu, (name, ptx)
    for call in ("wgmma_ss(", "wgmma_rs(", "tma_load_3d(", "mbar_wait(",
                 "make_map("):
        assert call in src, (name, call)
    assert "wmma::" not in tu and "<mma.h>" not in tu


def test_flash_bwd_is_atomic_free():
    """K4's gradients are the same bits from run to run: two passes and
    no atomic or reduction to global memory."""
    _, tu = _translation_unit("flash_bwd")
    code = _code(tu)
    assert "atomic" not in code
    assert re.search(r"\bred\.", code) is None
    assert "cp.reduce.async" not in code
    # the dK/dV pass and the dQ pass, each also as the wide instance, and
    # the dQ pass with the dbias epilogue (flash_bwd_dbias)
    assert code.count("__global__") == 5


def test_flash_c_argument_lists_are_unchanged():
    """The redesigned K3 and K4 keep their C entry points' arguments."""
    p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_uint)
    assert attention._FWD_ARGS == [p] * 9 + [i] * 6 + [f, i, u, f, p]
    assert attention._BWD_ARGS == [p] * 12 + [i] * 6 + [f, i, u, f, p]
    for name, args in (("flash_fwd", attention._FWD_ARGS),
                       ("flash_bwd", attention._BWD_ARGS)):
        src = _build.source_path(name).read_text()
        entry = src.split(f'extern "C" int {name}(')[1].split(")")[0]
        assert entry.count(",") + 1 == len(args), name


def test_nvcc_flags_do_not_link_the_driver():
    """The tensor maps are encoded through the driver entry point that
    the runtime hands out, so no kernel links libcuda."""
    assert not any(flag.startswith("-l") for flag in _build.NVCC_FLAGS)
    assert "-lcuda" not in " ".join(_build.NVCC_FLAGS)
    _, tu = _translation_unit("flash_fwd")
    assert "cudaGetDriverEntryPoint" in tu


def test_tile_sweep_defines_reach_the_sources():
    """Every macro the tile sweep sets is read by its kernel's source,
    and each variant builds into a library of its own."""
    from apex_tpu_torch.tools import flash_tiles

    for name, variants in flash_tiles.VARIANTS.items():
        src = _build.source_path(name).read_text()
        targets = set()
        for _, defines in variants:
            for define in defines:
                assert f"#ifdef {define.split('=')[0]}" in src, define
            flags = _build.NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
            targets.add(_build._target(name, flags))
        assert len(targets) == len(variants)


def _kernel_body(code, name):
    """The text of ``__global__`` function ``name`` in ``code``."""
    start = code.index(name + "(")
    end = code.find("__global__", start)
    return code[start:end if end > 0 else len(code)]


@pytest.mark.parametrize("name", ["flash_f32", "paged_decode"])
def test_k5_f32_and_k6_use_no_float_atomics(name):
    """K5's f32 sums and K6's merge take a fixed order: no float atomic, no
    red. and no bulk reduction.  K6's one atomic is its integer arrival
    counter, whose result picks the CTA that merges."""
    _, tu = _translation_unit(name)
    code = _code(tu)
    assert re.search(r"\bred\.", code) is None
    assert "cp.reduce.async" not in code
    calls = re.findall(r"atomic\w*\(([^,]*),", code)
    if name == "flash_f32":
        assert calls == []
    else:
        assert calls == ["&counters[bh]"]
        assert "int* __restrict__ counters" in code


def test_k5_f32_runs_on_tensor_cores_through_a_cp_async_ring():
    """The redesigned K5 f32: 3xTF32 mma.sync products fed by cp.async,
    and no SIMT FFMA tile loop left."""
    _, tu = _translation_unit("flash_f32")
    code = _code(tu)
    body = _kernel_body(code, "flash_dbias_f32_kernel")
    for call in ("mma3(", "load_a(", "load_bt(", "stage_rows<",
                 "cp_async_wait<", "stage_bias<"):
        assert call in body, call
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in code
    assert "tile_product" not in code and "load_t<" not in code


def test_k6_loads_through_cp_async_and_declares_its_arguments():
    """K6 streams its K and V tiles through cp.async, and the wrapper's
    argument list (the split plan and the workspace included) matches the
    C entry point's."""
    src = _build.source_path("paged_decode").read_text()
    code = _code(src)
    assert "cp.async.cg.shared.global" in code
    assert "cp.async.wait_group" in code
    entry = src.split('extern "C" int paged_decode(')[1].split(")")[0]
    assert entry.count(",") + 1 == len(paged_attention._ARGS)
    assert paged_attention._ARGS[-1] is ctypes.c_void_p  # the stream

"""apex_tpu_torch's structural contracts, checked without a GPU.

- the port and ``chip_smoke.py`` import neither ``jax`` nor ``apex_tpu``
  (AST scan of every module);
- entry points (the GPT and BERT models, the engine, the converters and
  the example trainers) run on the card by default and raise without
  one, unless the caller passes ``device="cpu"``;
- kernel wrappers launch their kernel or raise: handed CPU tensors, a
  kernel entry refuses instead of computing the plain version, and a
  kernel that cannot be built raises; a trainable attention bias on the
  card raises, naming the kernel it needs (K5);
- every kernel source carries its note (what it replaces, its bound on
  the card, what its design does about it).
"""

import ast
from pathlib import Path

import pytest
import torch

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
from apex_tpu_torch.ops.attention import flash_bwd, flash_fwd
from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
from apex_tpu_torch.ops.paged_attention import paged_decode_fwd
from apex_tpu_torch.serve import InferenceEngine, ServeConfig

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
                                   "bert_train"])
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


def test_trainable_bias_on_the_card_raises_naming_k5(monkeypatch):
    # stands in for CUDA operands: the refusal comes before any launch
    monkeypatch.setattr(_dispatch, "on_card", lambda *tensors: True)
    q = torch.zeros(1, 2, 16, 64)
    with pytest.raises(NotImplementedError, match="K5 flash_dbias"):
        attention.flash_attention(q, q, q, torch.zeros(1, 1, 1, 16),
                                  bias_grad=True)


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

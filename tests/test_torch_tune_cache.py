"""The tuning cache (``ops/tune_cache.py``) against the reference's
``apex_tpu/ops/pallas/tune_cache.py`` over the same JSON files, its
variants' route through the dispatch, and ``norm_launch_plan``'s
override."""

from __future__ import annotations

import ctypes
import json

import pytest
import torch

from apex_tpu.ops.pallas import tune_cache as jtc
from apex_tpu_torch.ops import _build, _dispatch
from apex_tpu_torch.ops import attention as attn
from apex_tpu_torch.ops import layer_norm as ln
from apex_tpu_torch.ops import tune_cache as tc

CACHE = {
    "version": 1,
    "flash_attention": [
        {"sq": 2048, "d": 64, "causal": True, "dtype": "bfloat16",
         "backend": "TPU v5", "tiles": {"fwd": [256, 256]}},
        {"sq": 2048, "d": 64, "causal": True, "dtype": "bfloat16",
         "backend": None, "tiles": {"fwd": [128, 64], "bwd": [64, 64]},
         "defines": {"fwd": ["APEX_FLASH_FWD_BLOCK_K=64",
                             "APEX_FLASH_FWD_STAGES=2"]}},
        {"sq": 2048, "d": 64, "causal": True, "dtype": None,
         "backend": None, "tiles": {"bwd_dq": [32, 32]},
         "defines": {"bwd": ["APEX_FLASH_BWD_STAGES=2"]}},
        {"sq": 512, "d": 128, "causal": False, "tiles": {"fwd": [0, 64]}},
        "not an entry",
    ],
    "layer_norm": [
        {"hidden": 1024, "backend": "TPU", "block_rows": 8},
        {"hidden": 1024, "backend": None, "block_rows": 64},
        {"hidden": 4096, "block_rows": -1},
    ],
}

LOOKUPS = [
    ("fwd", 2048, 64, True, "bfloat16"),
    ("fwd", 2048, 64, True, "float32"),
    ("bwd", 2048, 64, True, "bfloat16"),
    ("bwd_dq", 2048, 64, True, None),
    ("fwd", 2048, 64, False, "bfloat16"),
    ("fwd", 512, 128, False, None),
    ("fwd", 1024, 64, True, None),
]


@pytest.fixture
def both(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    path.write_text(json.dumps(CACHE))
    monkeypatch.setenv(tc.ENV_VAR, str(path))
    assert tc.ENV_VAR == jtc.ENV_VAR
    tc.reset()
    jtc.reset()
    yield path
    tc.reset()
    jtc.reset()


@pytest.mark.parametrize("mode,sq,d,causal,dtype", LOOKUPS)
def test_flash_lookups_equal_the_references(both, mode, sq, d, causal,
                                            dtype):
    assert tc.flash_tiles(mode, sq, d, causal, dtype) == \
        jtc.flash_tiles(mode, sq, d, causal, dtype)


@pytest.mark.parametrize("hidden", [1024, 4096, 768])
def test_layer_norm_lookups_equal_the_references(both, hidden):
    assert tc.layer_norm_block_rows(hidden) == \
        jtc.layer_norm_block_rows(hidden)


def test_defines_first_match_and_wildcards(both):
    assert tc.flash_defines("fwd", 2048, 64, True, torch.bfloat16) == (
        "APEX_FLASH_FWD_BLOCK_K=64", "APEX_FLASH_FWD_STAGES=2")
    # the bf16 entry names no bwd variant: the next (any dtype) does
    assert tc.flash_defines("bwd", 2048, 64, True, torch.bfloat16) == (
        "APEX_FLASH_BWD_STAGES=2",)
    assert tc.flash_defines("fwd", 2048, 64, True, torch.float32) == ()
    assert tc.flash_defines("fwd", 1024, 64, True, torch.bfloat16) == ()


def test_the_wrappers_variant_is_only_for_bf16(both):
    q = torch.zeros(1, 2048, 64, dtype=torch.bfloat16)
    assert attn._variant("fwd", q, 2048, 64, True) == {"defines": (
        "APEX_FLASH_FWD_BLOCK_K=64", "APEX_FLASH_FWD_STAGES=2")}
    assert attn._variant("fwd", q.float(), 2048, 64, True) == {}
    assert attn._variant("fwd", q, 1024, 64, True) == {}


@pytest.mark.parametrize("text", ["{not json", "[1, 2]"])
def test_malformed_file_warns_and_is_ignored(tmp_path, monkeypatch, text):
    path = tmp_path / "bad.json"
    path.write_text(text)
    monkeypatch.setenv(tc.ENV_VAR, str(path))
    tc.reset()
    with pytest.warns(UserWarning, match="malformed tuning cache"):
        assert tc.flash_defines("fwd", 2048, 64, True) == ()
    assert tc.layer_norm_block_rows(1024) is None
    tc.reset()


def test_no_file_is_the_default_build(monkeypatch):
    monkeypatch.delenv(tc.ENV_VAR, raising=False)
    tc.reset()
    assert tc.flash_defines("fwd", 2048, 64, True) == ()
    assert tc.layer_norm_block_rows(1024) is None


def test_update_flash_merges_as_the_reference(tmp_path):
    mine, ref = tmp_path / "mine.json", tmp_path / "ref.json"
    for mod, path in ((tc, mine), (jtc, ref)):
        mod.update_flash(str(path), sq=2048, d=64, causal=True,
                         tiles={"fwd": (128, 64)}, dtype="bfloat16")
        mod.update_flash(str(path), sq=2048, d=64, causal=True,
                         tiles={"bwd": (64, 64)}, dtype="bfloat16")
        mod.update_flash(str(path), sq=512, d=64, causal=False,
                         tiles={"fwd": (64, 64)})
        mod.update_layer_norm(str(path), hidden=1024, block_rows=32)
    assert json.loads(mine.read_text()) == json.loads(ref.read_text())
    tc.update_flash(str(mine), sq=2048, d=64, causal=True, dtype="bfloat16",
                    defines={"fwd": ["APEX_FLASH_FWD_STAGES=2"]})
    tc.update_flash(str(mine), sq=2048, d=64, causal=True, dtype="bfloat16",
                    defines={"bwd": ["APEX_FLASH_BWD_STAGES=2"]})
    entry = json.loads(mine.read_text())["flash_attention"][0]
    assert entry["defines"] == {"fwd": ["APEX_FLASH_FWD_STAGES=2"],
                                "bwd": ["APEX_FLASH_BWD_STAGES=2"]}
    assert entry["tiles"] == {"fwd": [128, 64], "bwd": [64, 64]}


def test_block_rows_override_sets_the_grid():
    plan = ln.norm_launch_plan(16384, 1024, 2, sms=132,
                               ctas_per_sm=lambda v, p, w: 8)
    assert plan.grid == min(16384 // (ln.NORM_WARPS * plan.rows_per_warp),
                            132 * 8)
    tuned = ln.norm_launch_plan(16384, 1024, 2, sms=132,
                                ctas_per_sm=lambda v, p, w: 8, block_rows=64)
    assert tuned.grid == 16384 // 64
    assert dataclasses_equal_but_grid(plan, tuned)
    with pytest.raises(ValueError, match="block_rows"):
        ln.norm_launch_plan(16, 64, 2, sms=1, ctas_per_sm=lambda v, p, w: 1,
                            block_rows=0)


def dataclasses_equal_but_grid(a, b):
    return (a.vec, a.per_lane, a.lanes, a.rows_per_warp) == \
        (b.vec, b.per_lane, b.lanes, b.rows_per_warp)


class _FakeLib:
    """Stands in a built library: records which variant each call ran."""

    def __init__(self, key, calls):
        self.key, self.calls = key, calls

        def entry(*args):
            calls.append(key)
            return 0

        entry.argtypes = None
        self.flash_fwd = entry


def test_a_variant_loads_its_own_library_and_is_tallied(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "load",
                        lambda name, defines=(): _FakeLib((name, defines),
                                                          calls))
    monkeypatch.setattr(_build, "check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    _dispatch.reset_launches()
    variant = ("APEX_FLASH_FWD_STAGES=2",)
    _dispatch.launch("flash_fwd", [ctypes.c_int, ctypes.c_void_p], "cuda", 1)
    _dispatch.launch("flash_fwd", [ctypes.c_int, ctypes.c_void_p], "cuda", 1,
                     defines=variant)
    assert calls == [("flash_fwd", ()), ("flash_fwd", variant)]
    assert _dispatch.launches() == {"flash_fwd": 2}
    assert _dispatch.launch_variants() == {"flash_fwd": {variant: 1}}
    _dispatch.reset_launches()
    assert _dispatch.launch_variants() == {}


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Stream:
    cuda_stream = 0


def test_an_unbuildable_variant_raises_without_nvcc(monkeypatch, tmp_path):
    """No fallback: the variant's build raises (here: no toolkit)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_fwd", ("APEX_FLASH_FWD_STAGES=2",))

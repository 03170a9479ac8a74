"""The serving engine's build checks (``ServeConfig(verify=True)``, the
default as in the reference) on the CPU: the same tokens as an unchecked
engine, every program linted from its recorded warm-up, the memory
budget gate, planted faults caught by their rules, ``lint()`` never
raising, and the ``serve_gpt`` example end to end."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from apex_tpu_torch.models.gpt import GptConfig, GptModel
from apex_tpu_torch.observability.metrics import board
from apex_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
    ServeConfig,
    SpecConfig,
)
from apex_tpu_torch.serve import model as model_lib

DIMS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_seq_len=128)
SERVE = dict(page_size=16, num_pages=32, max_batch=2, max_pages_per_seq=4)


def _engine(seed=1, spec=None, **kw):
    cfg = GptConfig(**DIMS, dtype=torch.float32)
    model = GptModel(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    return InferenceEngine(cfg, model, ServeConfig(**SERVE, **kw),
                           spec=spec, device="cpu")


def _serve(engine, temperature=0.0):
    rs = np.random.RandomState(5)
    sched = ContinuousBatchingScheduler(engine)
    reqs = [sched.submit(Request(
        prompt=[int(t) for t in rs.randint(0, 128, size=n)],
        max_new_tokens=6, temperature=temperature, stream_seed=i))
        for i, n in enumerate((5, 20, 33, 17))]
    sched.run()
    assert all(r.status == "done" for r in reqs)
    return [r.tokens for r in reqs]


def test_verify_is_on_by_default():
    assert ServeConfig().verify is True
    assert ServeConfig().hbm_budget_bytes is None


@pytest.mark.parametrize("wire", [{}, {"kv_wire": "int8"},
                                  {"weight_wire": "int8", "top_k": 8}])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_verified_engine_serves_the_same_tokens(wire, temperature):
    checked = _engine(**wire).build()
    plain = _engine(verify=False, **wire).build()
    assert plain.reports == {} and plain.records == {}
    assert set(checked.reports) == {"prefill_16", "prefill_32", "prefill_64",
                                    "decode"}
    assert all(r.findings == [] for r in checked.reports.values())
    assert _serve(checked, temperature) == _serve(plain, temperature)


def test_every_program_is_recorded_and_published():
    engine = _engine().build(chunked=True)
    names = {f"{kind}_{b}" for kind in ("prefill", "chunk_prefill")
             for b in (16, 32, 64)} | {"decode"}
    assert set(engine.reports) == names
    for name, report in engine.reports.items():
        assert {"transfer", "promotion", "donation",
                "memory"} <= set(report.rules_run)
        est = report.sections["peak_hbm_bytes"]
        assert est > engine.kv_pool_bytes()
        assert board.get(f"serve/hbm/{name}/peak_hbm_bytes") == est
    assert board.get("serve/peak_hbm_bytes") == max(
        r.sections["peak_hbm_bytes"] for r in engine.reports.values())
    # the pool is an argument updated in place by every program
    rec = engine.records["decode"]
    pool = {p for p in rec.arguments if p.startswith("kv_cache/")}
    assert pool == {f"kv_cache/{k}" for k in engine.cache}


def test_spec_engine_checks_the_drafts_prefill():
    engine = _engine(spec=SpecConfig(None, k=2)).build()
    assert {"draft_prefill_16", "draft_prefill_64"} <= set(engine.reports)
    assert all(r.findings == [] for r in engine.reports.values())


def test_budget_gate_fails_the_build():
    top = max(r.sections["peak_hbm_bytes"]
              for r in _engine().build().reports.values())
    with pytest.raises(RuntimeError, match="memory-budget"):
        _engine(hbm_budget_bytes=int(top * 0.9)).build()
    ok = _engine(hbm_budget_bytes=int(top * 1.1)).build()
    assert all(r.findings == [] for r in ok.reports.values())


def test_planted_host_read_fails_the_build(monkeypatch):
    real = model_lib.prefill_body

    def body(*a, **k):
        out = real(*a, **k)
        float(out[0].sum())
        return out

    monkeypatch.setattr(model_lib, "prefill_body", body)
    with pytest.raises(RuntimeError, match="transfer-hlo-host"):
        _engine().build()


def test_planted_pool_copy_fails_the_build(monkeypatch):
    real = model_lib.prefill_body

    def body(cfg, weights, kv_pages, *a, **k):
        return real(cfg, weights, {n: t.clone() for n, t in kv_pages.items()},
                    *a, **k)

    monkeypatch.setattr(model_lib, "prefill_body", body)
    with pytest.raises(RuntimeError, match="donation-dropped"):
        _engine().build()


def test_planted_f64_fails_the_build(monkeypatch):
    real = model_lib.prefill_body

    def body(*a, **k):
        out = real(*a, **k)
        return (out[0].double(),) + tuple(out[1:])

    monkeypatch.setattr(model_lib, "prefill_body", body)
    with pytest.raises(RuntimeError, match="promotion-f64"):
        _engine().build()


def test_lint_merges_prefill_and_decode_and_never_raises(monkeypatch):
    engine = _engine(verify=False, hbm_budget_bytes=1)
    report = engine.lint()
    assert report.target == "serve"
    assert set(report.sections["peak_hbm_by_program"]) == {
        "serve/prefill_16", "serve/decode"}
    assert {f.rule for f in report.errors()} == {"memory-budget"}
    clean = _engine().build().lint(32)
    assert clean.findings == []
    assert "serve/prefill_32" in clean.sections["peak_hbm_by_program"]


def test_serve_gpt_runs_end_to_end(tmp_path, capsys):
    from apex_tpu_torch.examples import serve_gpt

    jsonl = tmp_path / "serve.jsonl"
    engine, sched = serve_gpt.main([
        "--device", "cpu", "--dir", str(tmp_path / "run"),
        "--train-steps", "3", "--requests", "3", "--kv-wire", "int8",
        "--metrics-out", str(jsonl)])
    out = capsys.readouterr().out
    assert "restored == trained" in out and "ERRORs per program" in out
    assert len(sched.completed) == 3 and not sched.shed
    assert all(r.findings == [] for r in engine.reports.values())
    records = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert records and all(set(r) >= {"metric", "value", "unit",
                                      "vs_baseline", "step"} for r in records)
    metrics = {r["metric"] for r in records}
    assert {"serve/ttft_ms", "serve/peak_hbm_bytes"} <= metrics

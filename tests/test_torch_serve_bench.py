"""apex_tpu_torch.tools.serve_bench against tools/serve_bench.py.

Both tools drive their own package's engine and scheduler on the same
weights: the reference tool's default widths (vocab 128, hidden 64, 2
layers, 4 heads, FFN 128, max_seq_len 1024, f32), JAX's
``GptModel.init`` carried into the port with ``from_jax_params``.  The
reference tool is imported from its path; its engine is built with
``verify=False`` (its ``main`` builds with ``verify=True``, which the
installed jax cannot run: ROADMAP C3), so its ``run_load``,
``numerics_check``, ``_prefill_flops``, ``prefix_report``,
``prefix_replay_check`` and ``spec_report`` run beside the port's on
the same arguments:

- the drawn workload is equal draw for draw (every ``RandomState``
  call of ``run_load``, recorded on both sides) and request for request;
- at a rate where every request arrives at once and none is shed, every
  completed request's greedy tokens are equal (plain, with the prefix
  cache and 16-token chunks, and speculative with a 1-layer draft);
- ``_prefill_flops`` and the prefix report's saved FLOPs are equal
  exactly, and the cache and spec ledgers are equal;
- both numerics records sit within 2e-4 (f32 pages) and 5e-2 (int8
  pages), and both replays are bit-identical;
- the port's ``--json`` artifact carries every key of the reference's
  ``artifact = {...}`` literal (read with ``ast``), and a prefix cache
  that hands out a wrong page makes the port's tool exit 1 with the
  reference's failure message.
"""

import ast
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.observability as jax_obs
import apex_tpu.serve as jax_serve
from apex_tpu.models.gpt import GptConfig as JaxGptConfig
from apex_tpu.models.gpt import GptModel as JaxGptModel
from apex_tpu_torch import observability as port_obs
from apex_tpu_torch import serve as port_serve
from apex_tpu_torch.models import from_jax_params
from apex_tpu_torch.tools import serve_bench

ROOT = Path(__file__).resolve().parents[1]
REF_PATH = ROOT / "tools" / "serve_bench.py"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ref_serve_bench", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(*argv):
    return serve_bench.build_parser().parse_args(["--device", "cpu", *argv])


@pytest.fixture(scope="module")
def models():
    """The reference tool's model at its default widths (its own init
    keys), and the port's copy of the same weights."""
    args = _args()
    cfg = serve_bench.model_config(args)
    jcfg = JaxGptConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        max_seq_len=cfg.max_seq_len, dtype=jnp.float32)
    jmodel = JaxGptModel(jcfg)
    ids = jax.random.randint(jax.random.PRNGKey(0), (32, 1), 0,
                             jcfg.vocab_size)
    params = jmodel.init(jax.random.PRNGKey(1), ids)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, jmodel, params, cfg, model


class Recording(np.random.RandomState):
    """A RandomState that logs each draw of the workload generator."""

    log = None

    def _rec(self, name, out):
        if Recording.log is not None:
            Recording.log.append((name, np.array(out).tolist()))
        return out

    def exponential(self, *a, **k):
        return self._rec("exponential", super().exponential(*a, **k))

    def choice(self, *a, **k):
        return self._rec("choice", super().choice(*a, **k))

    def randint(self, *a, **k):
        return self._rec("randint", super().randint(*a, **k))

    def rand(self, *a, **k):
        return self._rec("rand", super().rand(*a, **k))


def _jax_sched(models, args):
    jcfg, _, params, _, _ = models
    spec = None
    if args.speculate:
        import dataclasses

        spec = jax_serve.SpecConfig(
            draft_params=jax_serve.draft_from_params(params,
                                                     args.draft_layers),
            k=args.speculate,
            draft_cfg=dataclasses.replace(jcfg,
                                          num_layers=args.draft_layers))
    registry = jax_obs.MetricRegistry(fetch_every=1)
    eng = jax_serve.InferenceEngine(jcfg, params, jax_serve.ServeConfig(
        page_size=args.page_size, num_pages=args.pages,
        max_batch=args.batch, max_pages_per_seq=args.pages_per_seq,
        kv_wire=args.kv_wire, weight_wire=args.weight_wire, verify=False),
        spec=spec, registry=registry)
    return jax_serve.ContinuousBatchingScheduler(
        eng, registry=registry, prefix_cache=args.prefix_cache,
        prefill_chunk_tokens=args.chunk_tokens), registry


def _port_sched(models, args):
    _, _, _, cfg, model = models
    spec = None
    if args.speculate:
        spec = port_serve.SpecConfig(
            port_serve.draft_from_params(model, args.draft_layers),
            k=args.speculate)
    registry = port_obs.MetricRegistry(fetch_every=1)
    eng = port_serve.InferenceEngine(cfg, model, port_serve.ServeConfig(
        page_size=args.page_size, num_pages=args.pages,
        max_batch=args.batch, max_pages_per_seq=args.pages_per_seq,
        kv_wire=args.kv_wire, weight_wire=args.weight_wire, verify=False),
        spec=spec, registry=registry, device="cpu")
    return port_serve.ContinuousBatchingScheduler(
        eng, registry=registry, prefix_cache=args.prefix_cache,
        prefill_chunk_tokens=args.chunk_tokens), registry


def _both_loads(ref, models, args, monkeypatch):
    """Each tool's run_load on its own scheduler, with every draw of
    the workload recorded."""
    monkeypatch.setattr(np.random, "RandomState", Recording)
    out = {}
    for side, make, tool in (("ref", _jax_sched, ref),
                             ("port", _port_sched, serve_bench)):
        sched, registry = make(models, args)
        Recording.log = []
        load = tool.run_load(sched, args)
        out[side] = dict(load=load, draws=Recording.log, sched=sched,
                         registry=registry)
        Recording.log = None
    monkeypatch.undo()
    return out["ref"], out["port"]


def _requests(load):
    return [dict(prompt=[int(t) for t in r.prompt],
                 max_new=int(r.max_new_tokens), status=r.status,
                 tokens=[int(t) for t in r.tokens])
            for r in load["_requests"]]


#: every request arrives before the first step; none is shed
ALL_AT_ONCE = ("--rate", "1e9")


@pytest.mark.parametrize("case", ["plain", "prefix", "spec"])
def test_workload_and_greedy_tokens_equal_the_reference(ref, models, case,
                                                        monkeypatch):
    extra = {
        "plain": (),
        "prefix": ("--prefix-cache", "--shared-prefix-tokens", "32",
                   "--chunk-tokens", "16"),
        "spec": ("--speculate", "2", "--draft-layers", "1"),
    }[case]
    args = _args(*ALL_AT_ONCE, *extra)
    jside, pside = _both_loads(ref, models, args, monkeypatch)
    assert jside["draws"] == pside["draws"]
    names = [name for name, _ in pside["draws"]]
    assert names[0] == "exponential" and names.count("choice") == 2
    jreqs, preqs = _requests(jside["load"]), _requests(pside["load"])
    assert len(preqs) == args.requests
    assert all(r["status"] == "done" for r in jreqs + preqs)
    assert preqs == jreqs
    for key in ("requests", "tokens"):
        want = {k: v for k, v in jside["load"][key].items()
                if k != "throughput_per_s"}
        got = {k: v for k, v in pside["load"][key].items()
               if k != "throughput_per_s"}
        assert got == want, key

    if case == "prefix":
        jcfg = models[0]
        cfg = models[3]
        jrep = ref.prefix_report(jside["sched"], jcfg, args, jside["load"])
        prep = serve_bench.prefix_report(pside["sched"], cfg, args,
                                         pside["load"])
        for rep in (jrep, prep):
            for k in ("hit_ttft_ms", "miss_ttft_ms"):
                rep.pop(k)
        assert prep == jrep
        assert prep["hit_requests"] > 0
        assert prep["prefill_flops_saved_pct"] > 0
        for rp in (ref.prefix_replay_check(jcfg, models[2], args,
                                           jside["sched"].completed),
                   serve_bench.prefix_replay_check(
                       cfg, models[4], args, pside["sched"].completed)):
            assert rp["bit_identical"] and rp["replayed"] == args.requests
    if case == "spec":
        jrep = ref.spec_report(jside["sched"], jside["registry"], args)
        prep = serve_bench.spec_report(pside["sched"], pside["registry"],
                                       args)
        assert prep == jrep
        assert prep["rounds"] > 0 and prep["drafted"] > 0
        rp = serve_bench.prefix_replay_check(models[3], models[4], args,
                                             pside["sched"].completed)
        assert rp["bit_identical"]


def test_prefill_flops_equal_the_reference(ref, models):
    jcfg, cfg = models[0], models[3]
    for n in (1, 16, 17, 48, 300, 1024):
        for start in sorted({0, 1, n // 2, n - 1}):
            assert serve_bench._prefill_flops(cfg, n, start) == \
                ref._prefill_flops(jcfg, n, start)


def test_numerics_within_the_pinned_tolerances(ref, models):
    jcfg, jmodel, params, cfg, model = models
    args = _args()
    port = serve_bench.numerics_check(cfg, model, args)
    jax_rec = ref.numerics_check(jcfg, jmodel, params, args)
    assert (serve_bench.TOL_F32, serve_bench.TOL_INT8_KV) == (
        ref.TOL_F32, ref.TOL_INT8_KV) == (2e-4, 5e-2)
    for rec in (port, jax_rec):
        assert set(rec) == {"f32", "int8"}
        for wire, tol in (("f32", 2e-4), ("int8", 5e-2)):
            assert rec[wire]["tolerance"] == tol
            assert rec[wire]["ok"], rec
    # the int8 pages' quantization shows; f32 pages agree to rounding
    assert port["f32"]["max_abs_logit_diff"] < 1e-5
    assert port["int8"]["max_abs_logit_diff"] > \
        port["f32"]["max_abs_logit_diff"]


def _artifact_keys():
    """The reference's ``artifact = {...}`` literal: its top-level keys
    and the config tuple's names."""
    tree = ast.parse(REF_PATH.read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "artifact"
                        for t in node.targets)):
            keys = [k.value for k in node.value.keys]
            config = node.value.values[keys.index("config")]
            names = [e.value for e in config.generators[0].iter.elts]
            return keys, names
    raise AssertionError("no artifact literal in tools/serve_bench.py")


def test_port_artifact_carries_the_reference_keys(models, tmp_path,
                                                  capsys):
    keys, config_names = _artifact_keys()
    assert len(keys) == 13 and "load" in keys and "memstats" in keys
    out = tmp_path / "sb.json"
    spans = tmp_path / "spans.json"
    rc = serve_bench.main([
        "--device", "cpu", "--json", str(out), "--spans", str(spans),
        "--ops-port", "0", "--slo-ttft-ms", "1000", "--prefix-cache",
        "--shared-prefix-tokens", "32", "--chunk-tokens", "16",
        "--speculate", "2", "--draft-layers", "1"], model=models[4])
    text = capsys.readouterr().out
    assert rc == 0, text
    art = json.loads(out.read_text())
    assert set(keys) <= set(art)
    assert set(config_names) <= set(art["config"])
    assert art["failures"] == [] and art["ops"]["scrape"]["ok"]
    assert art["memstats"]["provider"] == "fake"
    assert {"prefix", "spec"} <= set(art["load"])
    assert art["load"]["prefix"]["replay"]["bit_identical"]
    assert art["load"]["spec"]["replay"]["bit_identical"]
    assert "decode" in art["graph_lint_errors"]
    assert spans.is_file()
    for line in ("== serve_bench: 12 requests, Poisson 100.0/s",
                 "TTFT ms: p50=", "per-token ms: p50=", "batch fill: mean=",
                 "numerics [f32 KV vs unpaged f32]",
                 "prefix replay: 12 requests vs uncached reference — "
                 "BIT-IDENTICAL", "spec replay: 12 requests",
                 "graph lint ERRORs: {", "memstats [fake]", "ops scrape: "):
        assert line in text, line


def test_wrong_page_from_the_prefix_cache_fails_the_tool(models, monkeypatch,
                                                         capsys):
    """A planted fault: the cache hands out a wrong page — a hit's
    second page is its first again (a page order alone would not show:
    the whole cached run precedes every new position, and attention is
    blind to the order of the keys it sees).  The replay catches the
    corrupted decode, and the tool exits 1 with the reference's
    message."""
    match = port_serve.PrefixCache.match

    def swapped(self, prompt):
        pages, tokens = match(self, prompt)
        if len(pages) >= 2:
            pages = [pages[0], pages[0], *pages[2:]]
        return pages, tokens

    monkeypatch.setattr(port_serve.PrefixCache, "match", swapped)
    rc = serve_bench.main([
        "--device", "cpu", "--prefix-cache", "--shared-prefix-tokens",
        "32", "--chunk-tokens", "16"], model=models[4])
    err = capsys.readouterr().err
    assert rc == 1
    assert "FAIL prefix cache broke decode bit-identity: rids [" in err
    assert "diverged from the uncached reference" in err


def test_the_tool_defaults_to_the_card():
    args = serve_bench.build_parser().parse_args([])
    assert args.device == "cuda" and args.intermediate is None
    assert serve_bench.model_config(args).intermediate_size == 128
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_bench.main([])

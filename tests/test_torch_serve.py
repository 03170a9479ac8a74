"""apex_tpu_torch serving slice vs the JAX package.

A tiny f32 GPT (vocab 128, hidden 64, 2 layers, 4 heads, page 16) is
initialised by the JAX ``GptModel.init`` and carried into the port with
``from_jax_params``.  Then the port's ``prefill_body`` and three
``decode_body`` steps are held against ``apex_tpu.serve.model``'s on the
same inputs (logits and the written KV pages), and a whole scheduler
run against the JAX ``ContinuousBatchingScheduler`` over its
``InferenceEngine`` (``verify=False``: the build-time analysis is not
part of the serving numerics).  Greedy token streams must be identical.
Tolerance on f32 logits and KV: 1e-4 absolute/relative — XLA and
PyTorch's CPU kernels sum the matmuls in different orders, and the
difference grows through the layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GptConfig as JaxGptConfig
from apex_tpu.models.gpt import GptModel as JaxGptModel
from apex_tpu.serve import ContinuousBatchingScheduler as JaxScheduler
from apex_tpu.serve import InferenceEngine as JaxEngine
from apex_tpu.serve import Request as JaxRequest
from apex_tpu.serve import ServeConfig as JaxServeConfig
from apex_tpu.serve import cache as jax_cache
from apex_tpu.serve import model as jax_serve_model
from apex_tpu_torch.models import GptConfig, GptModel, from_jax_params
from apex_tpu_torch.serve import (
    NULL_PAGE,
    ContinuousBatchingScheduler,
    InferenceEngine,
    PagePool,
    Request,
    ServeConfig,
    decode_body,
    init_kv_pages,
    prefill_body,
)

TOL = dict(atol=1e-4, rtol=1e-4)
PAGE = 16
NUM_PAGES = 32
DIMS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_seq_len=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs several workers
    at once, and some of their tests time the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxGptConfig(**DIMS, dtype=jnp.float32)
    params = JaxGptModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((8, 1), jnp.int32)
    )
    cfg = GptConfig(**DIMS, dtype=torch.float32)
    model = from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu"
    )
    return jcfg, params, cfg, model


def _pools(cfg):
    jkv = jax_cache.init_kv_pages(
        cfg.num_layers, NUM_PAGES, cfg.num_heads, PAGE, cfg.head_dim,
        dtype=jnp.float32,
    )
    kv = init_kv_pages(
        cfg.num_layers, NUM_PAGES, cfg.num_heads, PAGE, cfg.head_dim,
        dtype=torch.float32, device="cpu",
    )
    return jkv, kv


def _prefill_both(models, prompt, page_ids, bucket):
    jcfg, params, cfg, model = models
    jkv, kv = _pools(cfg)
    tokens = np.zeros((bucket, 1), np.int32)
    tokens[: len(prompt), 0] = prompt
    ids = np.full((bucket // PAGE,), NULL_PAGE, np.int32)
    ids[: len(page_ids)] = page_ids
    j_logits, j_tok, j_fin, jkv = jax_serve_model.prefill_body(
        jcfg, params, jkv, jnp.asarray(tokens), jnp.asarray(len(prompt)),
        jnp.asarray(ids), page_size=PAGE,
    )
    logits, tok, fin, kv = prefill_body(
        cfg, model, kv, torch.from_numpy(tokens), len(prompt),
        torch.from_numpy(ids), page_size=PAGE,
    )
    return (j_logits, j_tok, j_fin, jkv), (logits, tok, fin, kv)


def _assert_pages_match(jkv, kv, pages):
    for name in ("k", "v"):
        np.testing.assert_allclose(
            kv[name][:, pages].numpy(), np.asarray(jkv[name])[:, pages],
            **TOL,
        )


def test_prefill_body_matches_jax(models):
    rs = np.random.RandomState(3)
    prompt = rs.randint(0, DIMS["vocab_size"], size=21)
    pages = [3, 7]
    (j_logits, j_tok, j_fin, jkv), (logits, tok, fin, kv) = _prefill_both(
        models, prompt, pages, bucket=32
    )
    assert logits.shape == (DIMS["vocab_size"],)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    assert int(tok) == int(j_tok) and bool(fin) and bool(j_fin)
    _assert_pages_match(jkv, kv, pages)


def test_decode_body_matches_jax_three_steps(models):
    jcfg, params, cfg, model = models
    rs = np.random.RandomState(4)
    prompt = rs.randint(0, DIMS["vocab_size"], size=30)
    pages = [5, 2]
    (_, j_tok, _, jkv), (_, tok, _, kv) = _prefill_both(
        models, prompt, pages, bucket=32
    )
    assert int(tok) == int(j_tok)
    cur = int(tok)
    ctx = len(prompt)
    table = np.zeros((2, 4), np.int32)
    table[0, :2] = pages
    for step in range(3):
        if ctx // PAGE >= len(pages):
            pages.append(9)
            table[0, : len(pages)] = pages
        tokens = np.array([cur, 0], np.int32)
        lengths = np.array([ctx + 1, 0], np.int32)
        j_logits, j_next, j_fin, jkv = jax_serve_model.decode_body(
            jcfg, params, jkv, jnp.asarray(tokens), jnp.asarray(lengths),
            jnp.asarray(table), page_size=PAGE,
        )
        logits, nxt, fin, kv = decode_body(
            cfg, model, kv, torch.from_numpy(tokens),
            torch.from_numpy(lengths), torch.from_numpy(table),
            page_size=PAGE,
        )
        np.testing.assert_allclose(
            logits.numpy(), np.asarray(j_logits), **TOL
        )
        assert nxt.tolist() == np.asarray(j_next).tolist()
        assert fin.tolist() == np.asarray(j_fin).tolist() == [True, True]
        cur = int(nxt[0])
        ctx += 1
    _assert_pages_match(jkv, kv, pages)


def test_scheduler_streams_match_jax(models):
    """End to end: 4 prompts, 8 new tokens each, 2 decode slots — the
    same admission order and the same greedy token streams."""
    jcfg, params, cfg, model = models
    rs = np.random.RandomState(5)
    prompts = [
        [int(t) for t in rs.randint(0, DIMS["vocab_size"], size=n)]
        for n in (5, 20, 33, 17)
    ]
    serve_kw = dict(page_size=PAGE, num_pages=NUM_PAGES, max_batch=2,
                    max_pages_per_seq=8)
    jsched = JaxScheduler(JaxEngine(
        jcfg, params, JaxServeConfig(**serve_kw, verify=False)
    ))
    sched = ContinuousBatchingScheduler(
        InferenceEngine(cfg, model, ServeConfig(**serve_kw), device="cpu")
    )
    jreqs = [jsched.submit(JaxRequest(prompt=p, max_new_tokens=8))
             for p in prompts]
    reqs = [sched.submit(Request(prompt=p, max_new_tokens=8))
            for p in prompts]
    jsched.run()
    sched.run()
    for jr, r in zip(jreqs, reqs):
        assert jr.status == r.status == "done"
        assert r.tokens == jr.tokens
    assert sched.pool.in_use == 0 and sched.leak_checks_run == 4
    sched.leak_check()


def _tiny_engine(num_pages=NUM_PAGES, seed=1):
    cfg = GptConfig(**DIMS, dtype=torch.float32)
    model = GptModel(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    return InferenceEngine(
        cfg, model,
        ServeConfig(page_size=PAGE, num_pages=num_pages, max_batch=2,
                    max_pages_per_seq=4),
        device="cpu",
    )


def test_engine_serves_its_own_compute_dtype_copy():
    """The engine casts the matmul and embedding weights to cfg.dtype
    once, when it is built, keeps the LayerNorm affines f32, and leaves
    the (f32, trainable) model it was given alone."""
    cfg = GptConfig(**DIMS, dtype=torch.bfloat16)
    model = GptModel(cfg, device="cpu")
    eng = InferenceEngine(cfg, model, ServeConfig(page_size=PAGE,
                                                  num_pages=NUM_PAGES),
                          device="cpu")
    blk = eng.model.layers[0]
    assert eng.model is not model
    assert blk.qkv.weight.dtype == blk.fc2.bias.dtype == torch.bfloat16
    assert eng.model.word_embeddings.weight.dtype == torch.bfloat16
    assert blk.ln_attn.scale.dtype == eng.model.ln_f.bias.dtype == torch.float32
    assert not any(p.requires_grad for p in eng.model.parameters())
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    torch.testing.assert_close(blk.qkv.weight,
                               model.layers[0].qkv.weight.to(torch.bfloat16),
                               atol=0, rtol=0)


def test_growth_victim_is_youngest():
    """A pool that cannot grow sheds the youngest running request."""
    eng = _tiny_engine(num_pages=5)
    sched = ContinuousBatchingScheduler(eng)
    old = sched.submit(Request(prompt=list(range(32)), max_new_tokens=4))
    young = sched.submit(Request(prompt=list(range(31)), max_new_tokens=4))
    sched.run()
    assert old.status == "done" and len(old.tokens) == 4
    assert young.status == "shed" and young.shed_reason == "growth_victim"
    assert eng.pool.in_use == 0


def test_eos_and_oversize():
    eng = _tiny_engine()
    probe = ContinuousBatchingScheduler(eng)
    first = probe.submit(Request(prompt=[3, 1, 4], max_new_tokens=3))
    probe.run()
    eos = first.tokens[1]
    sched = ContinuousBatchingScheduler(eng)
    stops = sched.submit(
        Request(prompt=[3, 1, 4], max_new_tokens=3, eos_token=eos)
    )
    big = sched.submit(Request(prompt=[0] * 65, max_new_tokens=3))
    sched.run()
    assert stops.status == "done" and stops.tokens == first.tokens[:2]
    assert big.status == "shed" and big.shed_reason == "oversize"
    assert eng.pool.in_use == 0


def test_non_finite_logits_shed_only_that_request():
    eng = _tiny_engine()
    with torch.no_grad():
        eng.model.ln_f.scale.fill_(float("nan"))
    sched = ContinuousBatchingScheduler(eng)
    req = sched.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
    sched.run()
    assert req.status == "shed" and req.shed_reason == "poisoned"
    assert eng.pool.in_use == 0 and sched.leak_checks_run == 1


class TestPagePool:
    def test_alloc_free_roundtrip(self):
        pool = PagePool(num_pages=8, page_size=4)
        got = pool.alloc(3)
        assert len(got) == 3 and NULL_PAGE not in got and pool.in_use == 3
        pool.free(got)
        assert pool.available == 7 and pool.occupancy() == 0.0

    def test_alloc_is_all_or_nothing(self):
        pool = PagePool(num_pages=4, page_size=4)
        assert pool.alloc(5) is None and pool.available == 3
        assert len(pool.alloc(3)) == 3 and pool.alloc(1) is None

    def test_double_free_and_bad_ids_raise(self):
        pool = PagePool(num_pages=8, page_size=4)
        got = pool.alloc(2)
        pool.free(got)
        with pytest.raises(ValueError, match="double free"):
            pool.free([got[0]])
        with pytest.raises(ValueError):
            pool.free([NULL_PAGE])

    def test_refcount_and_leak_check(self):
        pool = PagePool(num_pages=8, page_size=4)
        a = pool.alloc(2)
        assert [pool.refcount(p) for p in a] == [1, 1]
        pool.leak_check([a])
        with pytest.raises(ValueError, match="leaked"):
            pool.leak_check([a[:1]])
        with pytest.raises(ValueError, match="more than one request"):
            pool.leak_check([a, a[:1]])
        with pytest.raises(ValueError, match="foreign"):
            pool.leak_check([a, [6]])
        pool.free(a)
        assert pool.refcount(a[0]) == 0 and pool.in_use == 0
        pool.leak_check([])

    def test_pages_for(self):
        pool = PagePool(num_pages=8, page_size=4)
        assert [pool.pages_for(n) for n in (0, 1, 4, 5)] == [0, 1, 1, 2]

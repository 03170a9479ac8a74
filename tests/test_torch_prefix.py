"""apex_tpu_torch's prefix cache and chunked-prefill scheduling vs the JAX
package.

- ``prefix_keys``: byte for byte the reference's chained blake2b keys;
- ``PagePool``: shares, refcounts, namespaces and the cached arm of the
  leak check, as the reference's ``TestPagePoolRefcounts``;
- ``PrefixCache``: the operation sequences of the reference's
  ``TestPrefixCache`` replayed on both implementations, with equal
  results at every step;
- the scheduler with ``prefix_cache=True`` and 32-token chunks: token
  streams, cache hits and cache ledgers equal the JAX scheduler's
  (``verify=False``) on both KV wires; then the hit (one tail chunk),
  the copy-on-write fork (also on the int8 tail), eviction under
  pressure, a shed borrower that never frees shared pages, chunked
  against monolithic prefill, and the chunk grain's page rule.

Tiny f32 GPT (vocab 128, hidden 64, 2 layers, 4 heads) carried from a
JAX ``GptModel.init`` by ``from_jax_params``; page 8.
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
from apex_tpu_torch.models import GptConfig, from_jax_params
from apex_tpu_torch.serve import (
    NULL_PAGE,
    ContinuousBatchingScheduler,
    InferenceEngine,
    PagePool,
    Request,
    ServeConfig,
)
from apex_tpu_torch.serve import cache as cache_lib

PAGE = 8
DIMS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_seq_len=128)
SERVE = dict(page_size=PAGE, num_pages=32, max_batch=2, max_pages_per_seq=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _engine(models, **kw):
    _, _, cfg, model = models
    serve = dict(SERVE)
    serve.update(kw)
    return InferenceEngine(cfg, model, ServeConfig(**serve), device="cpu")


def _prompt(rs, n):
    return [int(t) for t in rs.randint(0, 128, size=n)]


# ---------------------------------------------------------------------------
# keys, pool, cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,page", [(0, 4), (1, 4), (6, 4), (8, 4),
                                    (19, 8), (100, 16), (33, 1)])
def test_prefix_keys_byte_equal_to_jax(n, page):
    prompt = _prompt(np.random.RandomState(n + page), n)
    assert cache_lib.prefix_keys(prompt, page) == jax_cache.prefix_keys(
        prompt, page)
    big = [2 ** 31 - 1, -5, 70000] * 3  # int32 bytes, as the reference
    assert cache_lib.prefix_keys(big, page) == jax_cache.prefix_keys(
        big, page)


def test_prefix_keys_chain_and_tail_commitment():
    a = cache_lib.prefix_keys([1, 2, 3, 4, 5, 6], 4)
    b = cache_lib.prefix_keys([1, 2, 3, 4, 9, 9], 4)
    assert [end for _, end in a] == [4, 6]
    assert a[0][0] == b[0][0] and a[1][0] != b[1][0]
    assert all(len(k) == 16 for k, _ in a)
    c = cache_lib.prefix_keys([1, 2, 3, 4, 5, 6, 7, 8], 4)
    assert c[0][0] == a[0][0] and c[1][0] != a[1][0]


class TestPagePoolRefcounts:
    def test_share_free_roundtrip(self):
        pool = PagePool(num_pages=8, page_size=4)
        got = pool.alloc(2)
        pool.share(got)
        assert pool.refcount(got[0]) == 2
        pool.free(got)
        assert pool.in_use == 2 and pool.refcount(got[0]) == 1
        pool.free(got)
        assert pool.in_use == 0 and pool.refcount(got[0]) == 0

    def test_share_unallocated_raises(self):
        pool = PagePool(num_pages=8, page_size=4)
        with pytest.raises(ValueError, match="unallocated"):
            pool.share([3])
        with pytest.raises(ValueError):
            pool.share([NULL_PAGE])

    def test_double_free_still_loud_after_shares(self):
        pool = PagePool(num_pages=8, page_size=4)
        got = pool.alloc(1)
        pool.share(got)
        pool.free(got)
        pool.free(got)
        with pytest.raises(ValueError, match="double free"):
            pool.free(got)

    def test_leak_check_cached_arm(self):
        pool = PagePool(num_pages=8, page_size=4)
        mine = pool.alloc(2)
        cached = pool.alloc(1)
        pool.share(cached)
        pool.leak_check([mine, cached], cached=cached)
        pool.free(cached)
        pool.leak_check([mine], cached=cached)
        with pytest.raises(ValueError, match="leaked"):
            pool.leak_check([mine])
        with pytest.raises(ValueError, match="more than one request"):
            pool.leak_check([mine, cached, cached], cached=cached)

    def test_namespaces_and_draft_pages_in_the_cache(self):
        pool = PagePool(num_pages=8, page_size=4)
        kv, draft = pool.alloc(1), pool.alloc(1, ns="draft")
        assert pool.namespace(kv[0]) == "kv"
        assert pool.namespace(draft[0]) == "draft"
        pool.share(draft)
        with pytest.raises(ValueError, match="draft-namespace"):
            pool.leak_check([kv, draft], cached=draft)
        pool.free(draft)
        pool.free(draft)
        assert pool.namespace(draft[0]) is None


def _scenario_commit_match_borrow(lib):
    pool = lib.PagePool(num_pages=16, page_size=4)
    cache = lib.PrefixCache(pool)
    prompt = list(range(10))
    pages = pool.alloc(3)
    out = [cache.commit(prompt, pages), cache.commits]
    hit, tokens = cache.match(prompt)
    cache.borrow(hit)
    out += [hit, tokens, pool.refcount(pages[0])]
    out += [cache.match(list(range(8)) + [63, 62, 61]), cache.hits,
            cache.misses, cache.hit_tokens, sorted(cache.cached_pages())]
    return out


def _scenario_miss_and_peek(lib):
    pool = lib.PagePool(num_pages=16, page_size=4)
    cache = lib.PrefixCache(pool)
    out = [cache.match([1, 2, 3]), cache.misses]
    cache.commit([1, 2, 3, 4], pool.alloc(1))
    tick = cache._tick
    out += [cache.peek_tokens([1, 2, 3, 4]), cache.peek_tokens([9, 9]),
            cache._tick == tick, len(cache)]
    return out


def _scenario_incumbent(lib):
    pool = lib.PagePool(num_pages=16, page_size=4)
    cache = lib.PrefixCache(pool)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    a = pool.alloc(2)
    out = [cache.commit(prompt, a)]
    b = pool.alloc(2)
    out += [cache.commit(prompt, b), cache.match(prompt)]
    # a diverging run chains only as far as the incumbent agrees
    c = pool.alloc(2)
    out += [cache.commit([1, 2, 3, 4, 0, 0, 0, 0], [a[0], c[1]]),
            cache.commit([1, 2, 3, 4, 9, 9], c)]
    pool.free(a)
    pool.free(b)
    pool.free(c)
    out += [cache.flush(), pool.in_use, cache.evictions]
    return out


def _scenario_evict(lib):
    pool = lib.PagePool(num_pages=16, page_size=4)
    cache = lib.PrefixCache(pool)
    a = pool.alloc(2)
    cache.commit([1, 2, 3, 4, 5, 6, 7, 8], a)
    pool.free(a)
    b = pool.alloc(1)
    cache.commit([9, 9, 9, 9], b)
    pool.free(b)
    out = [cache.evict(need=1), cache.peek_tokens([1, 2, 3, 4, 5, 6, 7, 8])]
    hit, _ = cache.match([9, 9, 9, 9])
    cache.borrow(hit)
    out += [cache.evict(), cache.peek_tokens([9, 9, 9, 9]),
            sorted(cache.cached_pages())]
    pool.free(hit)
    out += [cache.flush(), pool.in_use, cache.evictions]
    return out


def _scenario_flush(lib):
    pool = lib.PagePool(num_pages=16, page_size=4)
    cache = lib.PrefixCache(pool)
    pages = pool.alloc(1)
    cache.commit([1, 2, 3, 4], pages)
    out = [cache.flush(), pool.refcount(pages[0])]
    pool.free(pages)
    return out + [pool.in_use]


@pytest.mark.parametrize("scenario", [
    _scenario_commit_match_borrow, _scenario_miss_and_peek,
    _scenario_incumbent, _scenario_evict, _scenario_flush,
], ids=lambda f: f.__name__.removeprefix("_scenario_"))
def test_prefix_cache_sequences_equal_jax(scenario):
    assert scenario(cache_lib) == scenario(jax_cache)


def test_prefix_cache_pins_and_evicts_as_the_reference_says():
    out = _scenario_evict(cache_lib)
    # A's leaf went first, its parent stayed; the borrowed run survived
    # the full sweep
    assert out[:2] == [1, 4] and out[2:4] == [1, 4]


# ---------------------------------------------------------------------------
# the scheduler against the JAX scheduler
# ---------------------------------------------------------------------------


def _shared_prompts(rs):
    system = _prompt(rs, 40)
    return ([system + _prompt(rs, n) for n in (3, 17, 24)]
            + [_prompt(rs, 13), system + _prompt(rs, 9)])


@pytest.mark.parametrize("kv_wire", ["f32", "int8"])
def test_scheduler_streams_match_jax_with_cache_and_chunks(models, kv_wire):
    """Prefix cache on, 32-token chunks, 2 slots: five prompts (four
    sharing a 40-token system prompt) served twice; the greedy streams,
    the hits and the cache's ledger equal the JAX scheduler's."""
    jcfg, params, cfg, model = models
    jsched = JaxScheduler(
        JaxEngine(jcfg, params, JaxServeConfig(**SERVE, kv_wire=kv_wire,
                                               verify=False)),
        prefix_cache=True, prefill_chunk_tokens=32)
    sched = ContinuousBatchingScheduler(
        _engine(models, kv_wire=kv_wire), prefix_cache=True,
        prefill_chunk_tokens=32)
    prompts = _shared_prompts(np.random.RandomState(20))
    for _ in range(2):
        jreqs = [jsched.submit(JaxRequest(prompt=list(p), max_new_tokens=6))
                 for p in prompts]
        reqs = [sched.submit(Request(prompt=list(p), max_new_tokens=6))
                for p in prompts]
        jsched.run()
        sched.run()
        for jr, r in zip(jreqs, reqs):
            assert r.status == jr.status == "done"
            assert r.tokens == jr.tokens
            assert r.cache_hit_tokens == jr.cache_hit_tokens
            assert r.cache_hit_pages == jr.cache_hit_pages
    for name in ("hits", "misses", "hit_tokens", "commits", "evictions"):
        assert getattr(sched.prefix, name) == getattr(jsched.prefix, name)
    assert sched.prefix.hits >= 5  # every prompt of the second round
    assert sorted(sched.prefix.cached_pages()) == sorted(
        jsched.prefix.cached_pages())
    assert sched.engine.prefill_calls == jsched.engine.prefill_calls
    sched.leak_check()
    assert sched.pool.in_use == len(sched.prefix)


def test_hit_runs_one_tail_chunk_and_streams_identically(models):
    eng = _engine(models)
    sched = ContinuousBatchingScheduler(eng, prefix_cache=True)
    prompt = _prompt(np.random.RandomState(50), 19)
    cold = sched.submit(Request(prompt=list(prompt), max_new_tokens=4))
    sched.run()
    calls = eng.prefill_calls
    warm = sched.submit(Request(prompt=list(prompt), max_new_tokens=4))
    sched.run()
    # 3 pages borrowed; the partial tail forked at the first append
    assert warm.cache_hit_tokens == 19 and warm.cache_hit_pages == 2
    assert sched.forks == 2  # the committer's append, then the hit's
    assert eng.prefill_calls == calls + 1
    assert warm.tokens == cold.tokens
    assert sched.prefix.hits == 1 and sched.prefix.misses == 1
    sched.prefix.flush()
    assert eng.pool.in_use == 0 and sched.leak_checks_run > 0


@pytest.mark.parametrize("kv_wire", ["f32", "int8"])
def test_cow_fork_diverges_without_corrupting_cache(models, kv_wire):
    """The committer appends into its own committed tail page (refcount
    2: it forks); later hits borrow the pristine run and see the
    prompt's KV, codes and scale planes alike under int8."""
    eng = _engine(models, kv_wire=kv_wire)
    sched = ContinuousBatchingScheduler(eng, prefix_cache=True)
    prompt = _prompt(np.random.RandomState(51), 12)  # a half-full tail
    cached = None
    streams = []
    for _ in range(3):
        r = sched.submit(Request(prompt=list(prompt), max_new_tokens=6))
        sched.run()
        streams.append(r.tokens)
        snapshot = {k: t[:, sched.prefix.cached_pages()].clone()
                    for k, t in eng.cache.items()}
        if cached is not None:
            for k in snapshot:
                assert torch.equal(snapshot[k], cached[k]), k
        cached = snapshot
    assert streams[1] == streams[0] and streams[2] == streams[0]
    assert sched.forks >= 3  # one per request's first append
    sched.prefix.flush()
    assert eng.pool.in_use == 0


def test_fork_page_copies_every_plane_in_place(models):
    eng = _engine(models, kv_wire="int8")
    ptrs = {k: t.data_ptr() for k, t in eng.cache.items()}
    for k, t in eng.cache.items():
        t[:, 3] = (torch.arange(t[:, 3].numel()) % 100).reshape(
            t[:, 3].shape).to(t.dtype)
    eng.fork_page(3, 5)
    for k, t in eng.cache.items():
        assert torch.equal(t[:, 5], t[:, 3]) and t.data_ptr() == ptrs[k]


def test_eviction_under_pressure_admits_new_work(models):
    eng = _engine(models, num_pages=5, max_pages_per_seq=4)
    sched = ContinuousBatchingScheduler(eng, prefix_cache=True)
    rs = np.random.RandomState(53)
    a = sched.submit(Request(prompt=_prompt(rs, 16), max_new_tokens=2))
    sched.run()
    assert a.status == "done" and len(sched.prefix) == 2
    b = sched.submit(Request(prompt=_prompt(rs, 16), max_new_tokens=2))
    sched.run()
    assert b.status == "done"
    assert sched.prefix.evictions >= 1
    sched.leak_check()
    sched.prefix.flush()
    assert eng.pool.in_use == 0


def test_shed_borrower_decrements_never_frees_shared(models):
    """A cache-hit request shed in its prefill (a planted non-finite
    screen) releases its borrowed references only: the cached run stays
    intact, and a later hit decodes the cold run's stream."""
    eng = _engine(models)
    sched = ContinuousBatchingScheduler(eng, prefix_cache=True)
    prompt = _prompt(np.random.RandomState(55), 19)
    cold = sched.submit(Request(prompt=list(prompt), max_new_tokens=4))
    sched.run()
    cached = sorted(sched.prefix.cached_pages())
    refs = [eng.pool.refcount(p) for p in cached]
    chunk_prefill = eng.chunk_prefill

    def poisoned(*a, **k):
        out = chunk_prefill(*a, **k)
        eng.last_prefill_finite = False
        return out

    eng.chunk_prefill = poisoned
    doomed = sched.submit(Request(prompt=list(prompt), max_new_tokens=4))
    sched.run()
    eng.chunk_prefill = chunk_prefill
    assert doomed.status == "shed" and doomed.shed_reason == "poisoned"
    assert doomed.cache_hit_tokens == 19
    assert sorted(sched.prefix.cached_pages()) == cached
    assert [eng.pool.refcount(p) for p in cached] == refs
    sched.leak_check()
    warm = sched.submit(Request(prompt=list(prompt), max_new_tokens=4))
    sched.run()
    assert warm.status == "done" and warm.cache_hit_tokens == 19
    assert warm.tokens == cold.tokens
    sched.prefix.flush()
    assert eng.pool.in_use == 0


def test_chunked_prefill_matches_monolithic(models):
    prompt = _prompt(np.random.RandomState(56), 22)
    mono = ContinuousBatchingScheduler(_engine(models))
    a = mono.submit(Request(prompt=list(prompt), max_new_tokens=5))
    mono.run()
    eng = _engine(models)
    chunked = ContinuousBatchingScheduler(eng, prefill_chunk_tokens=8)
    b = chunked.submit(Request(prompt=list(prompt), max_new_tokens=5))
    chunked.run()
    assert a.status == b.status == "done"
    assert b.tokens == a.tokens
    assert eng.prefill_calls == 3 and eng.pool.in_use == 0


def test_chunk_grain_must_be_page_multiple(models):
    eng = _engine(models)
    with pytest.raises(ValueError, match="page"):
        ContinuousBatchingScheduler(eng, prefill_chunk_tokens=12)
    with pytest.raises(ValueError):
        ContinuousBatchingScheduler(eng, prefill_chunk_tokens=0)


def test_reset_cache_in_place_and_refused_with_pages_in_use(models):
    eng = _engine(models, kv_wire="int8")
    ptrs = {k: t.data_ptr() for k, t in eng.cache.items()}
    pages = eng.pool.alloc(1)
    eng.prefill([1, 2, 3], pages)
    with pytest.raises(RuntimeError, match="in use"):
        eng.reset_cache()
    eng.pool.free(pages)
    eng.reset_cache()
    for k, t in eng.cache.items():
        assert t.data_ptr() == ptrs[k]
        assert bool((t == (1 if k.endswith("_scale") else 0)).all()), k

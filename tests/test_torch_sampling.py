"""apex_tpu_torch's fused sampler vs the JAX package's ``sample_tokens``.

The port cannot reproduce JAX's threefry bits, so the sampler is split:
``_sample_with_noise(logits, temps, gumbel, top_k)`` is the reference's
formula (argmax of ``logits / max(temp, 1e-6) + gumbel`` after the top-k
mask, greedy where ``temp <= 0``), and the noise comes from a
counter-based hash of (seed, per-row words, vocab index).

- fed ``jax.random.gumbel``'s noise for the key JAX draws with (one key,
  and a per-slot key batch), ``_sample_with_noise`` gives JAX's tokens,
  with and without ``top_k``;
- greedy rows are the argmax exactly; the top-k support holds;
  determinism and variation as in the reference's ``TestFusedSampling``;
- the hash noise is Gumbel: a chi-square test on a seeded 16-token
  vocabulary that 40000 draws follow ``softmax(logits / temp)``;
- the engine and scheduler: a sampled stream with a ``stream_seed``
  re-draws the same tokens under another scheduler (its prefill token
  too: the port keys it by the stream, ROADMAP C4), two seeds differ,
  and the sampled tokens lie in the top k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.serve import model as jax_serve_model
from apex_tpu_torch.models import GptConfig, GptModel
from apex_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
    ServeConfig,
)
from apex_tpu_torch.serve import model as serve_model

DIMS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_seq_len=128, dtype=torch.float32)
#: chi-square critical value, 15 degrees of freedom, p = 0.001
CHI2_15_P001 = 37.697


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _keys(seed, rows, domain=7, col=0):
    words = torch.zeros((rows, 3), dtype=torch.int64)
    words[:, 0] = domain
    words[:, 1] = torch.arange(rows)
    words[:, 2] = col
    return serve_model.sample_keys(seed, words)


@pytest.mark.parametrize("top_k", [0, 5])
def test_core_with_jax_noise_gives_jax_tokens(top_k):
    logits = _normal(1, (16, 64))
    temps = np.array([0.0, 0.7, 1.0, 3.0] * 4, np.float32)
    key = jax.random.PRNGKey(3)
    want = jax_serve_model.sample_tokens(jnp.asarray(logits), temps, key,
                                         top_k=top_k)
    gumbel = jax.random.gumbel(key, logits.shape, dtype=jnp.float32)
    got = serve_model._sample_with_noise(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(np.array(gumbel)), top_k=top_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_core_with_jax_per_slot_noise_gives_jax_tokens():
    """The per-slot key batch of the JAX engine's streams."""
    logits = _normal(2, (8, 64))
    temps = np.full(8, 0.9, np.float32)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(4), jnp.arange(8, dtype=jnp.uint32))
    want = jax_serve_model.sample_tokens(jnp.asarray(logits), temps, keys,
                                         top_k=10)
    gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (64,), jnp.float32))(
        keys)
    got = serve_model._sample_with_noise(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(np.array(gumbel)), top_k=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_rows_are_argmax():
    logits = torch.from_numpy(_normal(5, (8, 64)))
    out = serve_model.sample_tokens(logits, torch.zeros(8), _keys(0, 8))
    torch.testing.assert_close(out, torch.argmax(logits, -1), atol=0, rtol=0)


def test_mixed_batch_keeps_greedy_rows_exact():
    logits = torch.from_numpy(_normal(6, (8, 64)))
    temps = torch.tensor([0.0, 1.0] * 4)
    out = serve_model.sample_tokens(logits, temps, _keys(1, 8))
    greedy = torch.argmax(logits, -1)
    assert torch.equal(out[temps == 0], greedy[temps == 0])


def test_temperature_draws_are_deterministic_and_vary():
    logits = torch.from_numpy(_normal(7, (32, 64)))
    temps = torch.full((32,), 5.0)
    a = serve_model.sample_tokens(logits, temps, _keys(2, 32))
    b = serve_model.sample_tokens(logits, temps, _keys(2, 32))
    c = serve_model.sample_tokens(logits, temps, _keys(3, 32))
    assert torch.equal(a, b)                       # same keys, same draw
    assert (a != c).any()                          # new seed, new draw
    assert (a != torch.argmax(logits, -1)).any()   # hot draws wander
    d = serve_model.sample_tokens(logits, temps, _keys(2, 32, col=1))
    assert (a != d).any()                          # another word, new draw


def test_top_k_bounds_the_support():
    logits = torch.from_numpy(_normal(8, (64, 32)))
    temps = torch.full((64,), 10.0)  # hot enough to wander without a mask
    out = serve_model.sample_tokens(logits, temps, _keys(4, 64), top_k=4)
    top4 = torch.topk(logits, 4, dim=-1).indices
    assert all(int(out[i]) in top4[i].tolist() for i in range(64))
    free = serve_model.sample_tokens(logits, temps, _keys(4, 64))
    assert any(int(free[i]) not in top4[i].tolist() for i in range(64))


def test_noise_is_a_function_of_key_and_index_only():
    keys = _keys(5, 3)
    a = serve_model.gumbel_noise(keys, 50)
    b = serve_model.gumbel_noise(keys[[2, 0]], 80)
    torch.testing.assert_close(b[:, :50], a[[2, 0]], atol=0, rtol=0)
    assert torch.isfinite(a).all() and a.dtype == torch.float32


def test_noise_stays_finite_at_the_extreme_hashes():
    """The uniform never reaches 0 or 1, so the Gumbel is finite: a +inf
    draw outside the top-k mask turns -inf + inf into NaN, which argmax
    picks."""
    h = torch.tensor([0, 1, 255, 256, 2 ** 31 - 257, 2 ** 31 - 1])
    u = serve_model._uniform(h)
    assert bool(((u > 0) & (u < 1)).all())
    assert float(u[-1]) == 1 - 2 ** -24 and float(u[0]) == 2 ** -24
    g = -torch.log(-torch.log(u))
    assert bool(torch.isfinite(g).all())
    # the sampler at the top hash: a masked-out token cannot win
    logits = torch.tensor([[5.0, 4.0, -3.0, 1.0]])
    gumbel = torch.tensor([[0.0, 0.0, float(g[-1]), 0.0]])
    out = serve_model._sample_with_noise(logits, torch.tensor([1.0]),
                                         gumbel, top_k=2)
    assert int(out[0]) in (0, 1)


def test_hash_noise_follows_softmax_chi_square():
    """40000 draws on a seeded 16-token vocabulary at temperature 0.7:
    the counts against softmax(logits / 0.7) pass a chi-square test at
    p = 0.001 (15 degrees of freedom), and a sampler that ignores the
    temperature fails it."""
    n, vocab, temp = 40000, 16, 0.7
    row = torch.from_numpy(_normal(9, (vocab,)))
    logits = row.expand(n, vocab)
    out = serve_model.sample_tokens(logits, torch.full((n,), temp),
                                    _keys(6, n))
    counts = torch.bincount(out, minlength=vocab).double()
    p = torch.softmax(row.double() / temp, dim=0)
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < CHI2_15_P001, chi2
    wrong = torch.softmax(row.double(), dim=0)
    chi2_wrong = float(((counts - n * wrong) ** 2 / (n * wrong)).sum())
    assert chi2_wrong > 10 * CHI2_15_P001, chi2_wrong


# ---------------------------------------------------------------------------
# the engine and the scheduler
# ---------------------------------------------------------------------------


def _engine(seed=1, **serve_kw):
    cfg = GptConfig(**DIMS)
    model = GptModel(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    kw = dict(page_size=16, num_pages=32, max_batch=2, max_pages_per_seq=4)
    kw.update(serve_kw)
    return InferenceEngine(cfg, model, ServeConfig(**kw), device="cpu")


def _serve(eng, reqs):
    sched = ContinuousBatchingScheduler(eng)
    for r in reqs:
        sched.submit(r)
    sched.run()
    return [r.tokens for r in reqs]


def _requests(seeds, temperature=1.5):
    rs = np.random.RandomState(10)
    prompt = [int(t) for t in rs.randint(0, 128, size=20)]
    return [Request(prompt=list(prompt), max_new_tokens=12,
                    temperature=temperature, stream_seed=s) for s in seeds]


def test_sampled_streams_reproduce_across_schedulers():
    eng = _engine(sample_seed=3)
    first = _serve(eng, _requests([11, 12]))
    # another engine call history: a greedy request first
    _serve(eng, [Request(prompt=[1, 2, 3], max_new_tokens=3)])
    again = _serve(eng, _requests([12, 11]))
    assert first == [again[1], again[0]]
    assert first[0] != first[1]           # two seeds, two streams
    other = _serve(_engine(sample_seed=4), _requests([11, 12]))
    assert other != first                 # the engine's seed matters
    assert eng.pool.in_use == 0


def test_sampled_tokens_lie_in_the_top_k():
    eng = _engine(top_k=3)
    rs = np.random.RandomState(12)
    prompt = [int(t) for t in rs.randint(0, 128, size=9)]
    pages = eng.pool.alloc(1)
    logits, first = eng.prefill(prompt, pages, temperature=50.0, stream=5)
    assert first in torch.topk(logits, 3).indices.tolist()
    table = np.zeros((2, 4), np.int32)
    table[0, 0] = pages[0]
    seen = set()
    for gen in range(16):
        lg, nxt = eng.decode(np.array([first, 0]), np.array([10, 0]), table,
                             np.array([50.0, 0.0], np.float32),
                             streams=np.array([5, 0]),
                             gens=np.array([gen, 0]))
        assert int(nxt[0]) in torch.topk(lg[0], 3).indices.tolist()
        assert int(nxt[1]) == int(torch.argmax(lg[1]))
        seen.add(int(nxt[0]))
    assert len(seen) > 1
    # the same (stream, generation) re-draws the same token
    _, again = eng.decode(np.array([first, 0]), np.array([10, 0]), table,
                          np.array([50.0, 0.0], np.float32),
                          streams=np.array([5, 0]), gens=np.array([3, 0]))
    _, once = eng.decode(np.array([first, 0]), np.array([10, 0]), table,
                         np.array([50.0, 0.0], np.float32),
                         streams=np.array([5, 0]), gens=np.array([3, 0]))
    assert int(again[0]) == int(once[0])


def test_serve_config_validates_sampling_and_wires():
    ServeConfig(kv_wire="int8", weight_wire="int8", top_k=50, sample_seed=7)
    with pytest.raises(ValueError, match="top_k"):
        ServeConfig(top_k=-1)
    with pytest.raises(ValueError, match="kv_wire"):
        ServeConfig(kv_wire="bf16")
    with pytest.raises(ValueError, match="weight_wire"):
        ServeConfig(weight_wire="int4")

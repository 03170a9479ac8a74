"""apex_tpu_torch's speculative decoding vs the JAX package.

A tiny f32 GPT (vocab 128, hidden 64, 2 layers, 4 heads) is initialised
by the JAX ``GptModel.init`` and carried into the port with
``from_jax_params``; drafts are the target itself (self-draft) or its
first layer (``draft_from_params``).

- **Greedy streams**: the port's speculative scheduler emits exactly the
  tokens of its plain decode, and of the JAX engine's greedy decode
  (``ServeConfig(verify=False)``, as the port's serving tests build it),
  with a self-draft and a 1-layer draft, on the f32 and the int8 KV
  wires, and under a copy-on-write fork of a prefix-cache hit.  Token
  streams are compared for equality (no tolerance).
- **The acceptance rule**: ``verify_with_noise`` fed ``jax.random``'s
  acceptance uniforms and Gumbel draws gives the JAX
  ``speculative_verify``'s tokens and ``n_accept`` exactly.
- **The emitted distribution**: the first token of a round follows the
  target softmax (chi-square at 7 degrees of freedom, p = 0.001,
  threshold 24.322, the reference's test), and a rule that accepts every
  proposal fails it.
- **Rollback and pages**: rolled-back rows read 0 (int8 scales 1.0),
  other rows keep their bits; no draft page enters the prefix cache; the
  pool ends empty.
- **The acceptance fallback** trips when the rate over a full window is
  below ``min_accept_rate`` (strictly), as the reference states it.
- **Randomness**: a ``k = 0`` sampled stream equals plain decode's; a
  sampled spec stream repeats under another scheduler history.
- **The int8 weight wire**: a separate draft is packed from its own
  stacked tree, leaf by leaf as the JAX ``quantize_params`` of the JAX
  draft tree (codes equal but at exact ties, scales within one ulp).
"""

import dataclasses

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
from apex_tpu.serve import SpecConfig as JaxSpecConfig
from apex_tpu.serve import model as jax_serve_model
from apex_tpu.serve import spec as jax_spec
from apex_tpu_torch.models import GptConfig, from_jax_params, gpt_param_tree
from apex_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    PackedWeight,
    Request,
    ServeConfig,
    SpecConfig,
    draft_from_params,
    init_kv_pages,
    quantize_params,
    rope_tables,
)
from apex_tpu_torch.serve import spec as spec_lib

DIMS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_seq_len=128)
SERVE = dict(page_size=8, num_pages=64, max_batch=2, max_pages_per_seq=16)
#: chi-square critical value, 7 degrees of freedom, p = 0.001
CHI2_7_P001 = 24.322


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs several workers
    at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxGptConfig(**DIMS, dtype=jnp.float32)
    params = JaxGptModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((8, 1), jnp.int32))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    cfg = GptConfig(**DIMS, dtype=torch.float32)
    model = from_jax_params(params_np, cfg, device="cpu")
    return jcfg, params, params_np, cfg, model


def _engine(models, spec=None, **kw):
    cfg, model = models[3], models[4]
    return InferenceEngine(cfg, model, ServeConfig(**dict(SERVE, **kw)),
                           spec=spec, device="cpu")


def _draft(models, layers=1, **spec_kw):
    return SpecConfig(draft_from_params(models[4], layers), **spec_kw)


def _prompts(seed, lens):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(0, DIMS["vocab_size"], size=n)]
            for n in lens]


def _serve(engine, prompts, max_new=10, sched=None, **req_kw):
    sched = sched or ContinuousBatchingScheduler(engine)
    reqs = [sched.submit(Request(prompt=list(p), max_new_tokens=max_new,
                                 **req_kw)) for p in prompts]
    sched.run()
    assert all(r.status == "done" for r in reqs), [
        (r.status, r.shed_reason) for r in reqs]
    return [r.tokens for r in reqs], sched


def _jax_serve(models, prompts, max_new=10, **kw):
    jcfg, params = models[0], models[1]
    jsched = JaxScheduler(JaxEngine(
        jcfg, params, JaxServeConfig(**SERVE, verify=False, **kw)))
    reqs = [jsched.submit(JaxRequest(prompt=list(p), max_new_tokens=max_new))
            for p in prompts]
    jsched.run()
    assert all(r.status == "done" for r in reqs)
    return [r.tokens for r in reqs]


# ---------------------------------------------------------------------------
# the configuration and the draft
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(k=-1), "k must be"), (dict(mode="beam"), "mode"),
    (dict(min_accept_rate=1.5), "min_accept_rate"), (dict(window=0), "window"),
])
def test_spec_config_validates_as_the_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        JaxSpecConfig(draft_params=None, **kw)
    with pytest.raises(ValueError, match=match):
        SpecConfig(None, **kw)


def test_draft_from_params_shares_and_converts(models):
    """The port's truncated draft shares the target's first block,
    embeddings and final LayerNorm; the same draft comes from the JAX
    ``draft_from_params`` tree carried across by ``from_jax_params``, and
    from the port's function on the port's JAX-layout tree."""
    jcfg, params, params_np, cfg, model = models
    draft = draft_from_params(model, 1)
    assert draft.cfg == dataclasses.replace(cfg, num_layers=1)
    assert draft.layers[0] is model.layers[0] and len(draft.layers) == 1
    assert draft.word_embeddings is model.word_embeddings
    assert draft.ln_f is model.ln_f
    jdraft = jax.tree_util.tree_map(
        np.asarray, jax_spec.draft_from_params(params, 1))
    carried = from_jax_params(jdraft, draft.cfg, device="cpu")
    want = dict(draft.named_parameters())
    got = dict(carried.named_parameters())
    assert sorted(want) == sorted(got)
    for name, p in got.items():
        assert torch.equal(p, want[name]), name
    tree = draft_from_params(gpt_param_tree(model), 1)
    for path, leaf in _leaves(tree):
        np.testing.assert_array_equal(leaf.numpy(), _get(jdraft, path))
    with pytest.raises(ValueError, match=">= 1 layer"):
        draft_from_params(model, 0)
    with pytest.raises(ValueError, match="target of 2"):
        draft_from_params(model, 3)


def test_rope_tables_match_jax(models):
    jcfg, _, _, cfg, _ = models
    jcos, jsin = jax_serve_model.rope_tables(jcfg)
    cos, sin = rope_tables(cfg, device="cpu")
    assert cos.shape == (DIMS["max_seq_len"], cfg.head_dim)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    flat = dataclasses.replace(cfg, rotary=False)
    assert rope_tables(flat, device="cpu") == (None, None)
    assert jax_serve_model.rope_tables(
        dataclasses.replace(jcfg, rotary=False)) == (None, None)


# ---------------------------------------------------------------------------
# the acceptance rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_k", [0, 5])
def test_target_probs_match_jax(top_k):
    rs = np.random.RandomState(top_k)
    logits = (rs.randn(3, 6, 40) * 2).astype(np.float32)
    temps = np.array([0.0, 0.5, 1.0, 1.7, 0.8, 2.5], np.float32)
    want = jax_spec.target_probs(jnp.asarray(logits), jnp.asarray(temps),
                                 top_k=top_k)
    got = spec_lib.target_probs(torch.from_numpy(logits),
                                torch.from_numpy(temps), top_k=top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def _jax_noise(stream_keys, gens, k, vocab):
    """JAX's draws of one round: the acceptance uniforms (ACCEPT_TAG
    sub-stream) and the residual/bonus Gumbel noise at each index."""
    uniforms = [
        jax.vmap(lambda kk: jax.random.uniform(kk, ()))(
            jax_spec._fold_each(jax_spec._fold_each(stream_keys, gens + j),
                                jax_spec.ACCEPT_TAG))
        for j in range(k)
    ]
    gumbel = [
        jax.vmap(lambda kk: jax.random.gumbel(kk, (vocab,), jnp.float32))(
            jax_spec._fold_each(stream_keys, gens + j))
        for j in range(k + 1)
    ]
    b = stream_keys.shape[0]
    u = np.stack([np.asarray(x) for x in uniforms]) if k else np.zeros(
        (0, b), np.float32)
    return u, np.stack([np.asarray(g) for g in gumbel])


@pytest.mark.parametrize("k,top_k", [(0, 0), (1, 0), (3, 0), (3, 7)])
def test_core_with_jax_noise_gives_jax_tokens(k, top_k):
    """64 slots, half greedy and half at temperatures 0.6..1.6, logits
    close enough to the draft's that proposals are accepted and rejected
    both: the port's rule on JAX's noise emits JAX's tokens and counts."""
    b, vocab = 64, 24
    rs = np.random.RandomState(10 * k + top_k)
    base = rs.randn(b, vocab).astype(np.float32)
    ver = np.stack([base + 0.6 * rs.randn(b, vocab).astype(np.float32)
                    for _ in range(k + 1)])
    temps = np.where(np.arange(b) % 2, rs.uniform(0.6, 1.6, b), 0.0
                     ).astype(np.float32)
    q = np.asarray(jax_spec.target_probs(
        jnp.asarray(np.stack([base] * k) if k else np.zeros((0, b, vocab),
                                                            np.float32)),
        jnp.asarray(temps), top_k=top_k))
    q = q / q.sum(-1, keepdims=True)
    d = np.zeros((b, k), np.int32)
    for j in range(k):
        for s in range(b):
            d[s, j] = rs.choice(vocab, p=q[j, s].astype(np.float64)
                                / q[j, s].astype(np.float64).sum())
    # a quarter of the slots (all greedy) propose the argmax chain
    greedy = temps <= 0
    chain = np.arange(b) % 4 == 0
    for j in range(k):
        d[chain, j] = ver[j, chain].argmax(-1)
    stream_keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(3), jnp.arange(b, dtype=jnp.uint32))
    gens = jnp.asarray(rs.randint(0, 50, b), jnp.int32)
    jout, jacc = jax_spec.speculative_verify(
        jnp.asarray(ver), jnp.asarray(d), jnp.asarray(q), jnp.asarray(temps),
        stream_keys, gens, top_k=top_k)
    u, g = _jax_noise(stream_keys, gens, k, vocab)
    out, acc = spec_lib.verify_with_noise(
        torch.from_numpy(ver), torch.from_numpy(d).long(),
        torch.from_numpy(q), torch.from_numpy(temps), torch.from_numpy(u),
        torch.from_numpy(g), top_k=top_k)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    if k:
        sampled = ~greedy
        assert 0 < acc.numpy()[sampled].sum() < k * sampled.sum()
        assert 0 < acc.numpy()[greedy].sum() < k * greedy.sum()


def _first_token_chi2(accept_all: bool):
    """The reference's chi-square set-up (V 8, N 4096, k 1): proposals
    drawn from a mismatched q, judged against p with the port's hashed
    noise; returns (chi2, accepted)."""
    vocab, n, k = 8, 4096, 1
    rs = np.random.RandomState(0)
    p_logits = (rs.randn(vocab) * 1.5).astype(np.float32)
    q_logits = (rs.randn(vocab) * 1.5).astype(np.float32)
    p = np.exp(p_logits - p_logits.max())
    p /= p.sum()
    q = np.exp(q_logits - q_logits.max())
    q /= q.sum()
    d = torch.from_numpy(rs.choice(vocab, size=(n, k), p=q))
    ver = torch.from_numpy(p_logits).expand(k + 1, n, vocab)
    qt = torch.from_numpy(q.astype(np.float32)).expand(k, n, vocab)
    temps = torch.ones(n)
    streams = torch.arange(n, dtype=torch.int64)
    gens = torch.zeros(n, dtype=torch.int64)
    if accept_all:
        # the planted fault: uniforms of 0 accept every proposal
        gumbel = torch.stack([
            spec_lib.model_lib.gumbel_noise(spec_lib.emission_keys(
                0, spec_lib.DOMAIN_DECODE_STREAM, streams, gens + j), vocab)
            for j in range(k + 1)])
        out, acc = spec_lib.verify_with_noise(
            ver, d, qt, temps, torch.zeros(k, n), gumbel)
    else:
        out, acc = spec_lib.speculative_verify(ver, d, qt, temps, 0,
                                               streams, gens)
    counts = np.bincount(out[:, 0].numpy(), minlength=vocab)
    expected = p * n
    return float(((counts - expected) ** 2 / expected).sum()), acc


def test_emitted_first_token_follows_the_target_softmax():
    chi2, acc = _first_token_chi2(accept_all=False)
    assert chi2 < CHI2_7_P001, chi2
    assert 0 < int(acc.sum()) < acc.numel()  # accepts and rejections both
    chi2_fault, _ = _first_token_chi2(accept_all=True)
    assert chi2_fault > CHI2_7_P001, chi2_fault


# ---------------------------------------------------------------------------
# greedy streams: spec = plain decode = JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_wire", ["f32", "int8"])
def test_greedy_spec_streams_equal_plain_decode_and_jax(models, kv_wire):
    prompts = _prompts(60, (6, 11, 19))
    want = _jax_serve(models, prompts, kv_wire=kv_wire)
    plain, _ = _serve(_engine(models, kv_wire=kv_wire), prompts)
    assert plain == want
    for spec in (SpecConfig(None, k=4), _draft(models, k=3)):
        eng = _engine(models, spec, kv_wire=kv_wire)
        got, sched = _serve(eng, prompts)
        assert got == want, spec.draft_params is None
        assert sched.spec_rounds > 0 and eng.pool.in_use == 0
        assert eng.draft_prefill_calls == len(prompts)
        assert eng.prefill_calls == len(prompts)  # the target's own count
        sched.leak_check()
        if spec.draft_params is None:
            # a self-draft proposes the target's own argmax chain
            assert sched.spec_accepted == sched.spec_drafted > 0
            assert sched.spec_rollbacks == 0
        else:
            assert sched.spec_accepted < sched.spec_drafted
            assert sched.spec_rollbacks > 0


def test_greedy_spec_under_a_cow_fork_of_a_cached_prefix(models):
    """A hit borrows the prompt's partial tail page; the spec round writes
    positions on it, so the scheduler forks the whole span first: the
    warm streams equal the cold one, the cached copy never drifts, and no
    draft page is ever in the cache."""
    prompt = _prompts(62, (12,))[0]  # 12 tokens: a half-full tail page
    want = _jax_serve(models, [prompt], max_new=6)
    eng = _engine(models, _draft(models, k=3))
    sched = ContinuousBatchingScheduler(eng, prefix_cache=True)
    cold, _ = _serve(eng, [prompt], max_new=6, sched=sched)
    warm, _ = _serve(eng, [prompt], max_new=6, sched=sched)
    warm2, _ = _serve(eng, [prompt], max_new=6, sched=sched)
    assert cold == warm == warm2 == want
    assert sched.prefix.hits == 2 and sched.forks >= 2
    assert all(eng.pool.namespace(p) == "kv"
               for p in sched.prefix.cached_pages())
    sched.leak_check()
    assert eng.pool.in_use == len(sched.prefix)


def test_mixed_batch_of_spec_and_demoted_requests(models):
    """A request whose draft state is unusable (``spec_ok`` False) rides
    plain decode beside spec rounds: every stream still equals plain
    decode, and the demoted request never holds a draft page."""
    prompts = _prompts(63, (9, 14))
    want, _ = _serve(_engine(models), prompts)
    eng = _engine(models, _draft(models, k=2))
    sched = ContinuousBatchingScheduler(eng)
    reqs = [sched.submit(Request(prompt=p, max_new_tokens=10))
            for p in prompts]
    reqs[1].spec_ok = False
    seen = []
    while sched.pending:
        sched.step()
        seen.append(list(reqs[1].draft_pages))
    assert [r.tokens for r in reqs] == want
    assert not any(seen) and sched.spec_rounds > 0
    assert eng.pool.in_use == 0


def test_round_emits_plain_decodes_tokens(models):
    """One engine-level round with a self-draft: the k + 1 emitted tokens
    are the next k + 1 tokens of plain decode from the same prefill."""
    prompt = _prompts(64, (10,))[0]
    k = 3
    outs = {}
    for name, spec in (("plain", None), ("spec", SpecConfig(None, k=k))):
        eng = _engine(models, spec)
        pages = eng.pool.alloc(3)
        _, tok = eng.prefill(prompt, pages[:2])
        table = np.zeros((2, SERVE["max_pages_per_seq"]), np.int32)
        table[0, :3] = pages
        lengths = np.array([len(prompt) + 1, 0], np.int32)
        if spec is None:
            toks = []
            for j in range(k + 1):
                _, nxt = eng.decode([tok, 0], lengths + [j, 0], table)
                toks.append(int(nxt[0]))
                tok = int(nxt[0])
            outs[name] = toks
        else:
            dpages = eng.pool.alloc(3, ns="draft")
            dtable = np.zeros_like(table)
            dtable[0, :3] = dpages
            eng.draft_prefill(prompt, dpages[:2])
            out, acc, fin = eng.spec_step(
                [tok, 0], lengths, table, dtable, None, [0, 0], [0, 0])
            assert int(acc[0]) == k and bool(fin[0])
            outs[name] = [int(t) for t in out[0]]
            assert eng.spec_rounds == 1 and eng.decode_iters == 1
    assert outs["spec"] == outs["plain"]


# ---------------------------------------------------------------------------
# rollback and the fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_wire", ["f32", "int8"])
def test_rollback_zeroes_exactly_the_rejected_rows(kv_wire):
    page, width = 4, 5
    kv = init_kv_pages(2, 12, 3, page, 8, dtype=torch.float32,
                       device="cpu", kv_wire=kv_wire)
    gen = torch.Generator().manual_seed(0)
    for t in kv.values():
        t.copy_(torch.randint(1, 100, t.shape, generator=gen).to(t.dtype))
    before = {n: t.clone() for n, t in kv.items()}
    tables = torch.tensor([[3, 5, 7, 0, 0], [2, 4, 0, 0, 0],
                           [9, 10, 11, 0, 0]])
    starts = torch.tensor([6, 3, 0])   # slot 2: idle (start 0)
    counts = torch.tensor([3, 2, 4])
    spec_lib.rollback_body(kv, starts, counts, tables, k=4,
                           page_size=page)
    hit = torch.zeros(12, page, dtype=torch.bool)
    for b, (s0, c) in enumerate(zip(starts.tolist(), counts.tolist())):
        if s0 == 0:
            continue
        for pos in range(s0, s0 + c):
            hit[tables[b, pos // page], pos % page] = True
    hit[0] = True  # masked rows land on the null page
    for name, t in kv.items():
        fill = 1.0 if name.endswith("_scale") else 0
        for p in range(1, 12):
            for s in range(page):
                got = t[:, p, :, s]
                if hit[p, s]:
                    assert torch.all(got == fill), (name, p, s)
                else:
                    assert torch.equal(got, before[name][:, p, :, s])


def test_acceptance_fallback_rule():
    """The rule as the reference states it: once the window holds
    ``window`` rounds, a rate (accepted / drafted) strictly below
    ``min_accept_rate`` trips the fallback; at the rate it does not."""
    from collections import deque

    class Stub:
        spec = SpecConfig(None, min_accept_rate=0.5, window=3)

    sched = ContinuousBatchingScheduler.__new__(ContinuousBatchingScheduler)
    sched.engine = Stub()
    sched._spec_window = deque(maxlen=3)
    for drafted, accepted in ((4, 0), (4, 0)):
        sched._spec_window.append((drafted, accepted, 1, 1))
        assert not sched._acceptance_collapsed()  # window not full
    sched._spec_window.append((4, 6, 1, 1))  # 6 / 12 = 0.5: at the floor
    assert not sched._acceptance_collapsed()
    sched._spec_window.append((4, 5, 1, 1))  # 11 / 12: the first drops out
    assert not sched._acceptance_collapsed()
    sched._spec_window.extend([(4, 0, 1, 1)] * 2)  # 5 / 12 < 0.5
    assert sched._acceptance_collapsed()
    sched._spec_window.extend([(0, 0, 1, 1)] * 3)  # nothing drafted
    assert not sched._acceptance_collapsed()


def test_acceptance_collapse_falls_back_to_plain(models):
    """The reference's test: a 1-layer draft at ``min_accept_rate`` 0.95
    over 2 rounds trips the fallback; later steps decode plain and the
    streams still equal plain decode."""
    prompts = _prompts(66, (8, 8))
    want, _ = _serve(_engine(models), prompts, max_new=12)
    eng = _engine(models, _draft(models, k=4, min_accept_rate=0.95,
                                 window=2))
    got, sched = _serve(eng, prompts, max_new=12)
    assert got == want
    assert sched.spec_fallbacks == 1 and sched._spec_fallback
    assert sched.spec_rounds == 2
    assert eng.pool.in_use == 0


# ---------------------------------------------------------------------------
# sampled streams
# ---------------------------------------------------------------------------


def test_k0_sampled_stream_equals_plain_decode(models):
    prompts = _prompts(67, (7, 10))
    kw = dict(temperature=0.7, stream_seed=99)
    want, _ = _serve(_engine(models, top_k=20), prompts, **kw)
    got, sched = _serve(_engine(models, _draft(models, k=0), top_k=20),
                        prompts, **kw)
    assert got == want and sched.spec_rounds > 0


def test_sampled_spec_stream_repeats_under_another_history(models):
    """A stream is a function of (seed, stream, index): served alone or
    beside another request (other batch slots, other rounds, other
    rollbacks), a seeded request draws the same tokens."""
    prompts = _prompts(68, (9, 15))
    spec = _draft(models, k=3)
    kw = dict(temperature=0.9, stream_seed=5)
    alone, _ = _serve(_engine(models, spec), prompts[:1], **kw)
    eng = _engine(models, spec)
    sched = ContinuousBatchingScheduler(eng)
    other = sched.submit(Request(prompt=prompts[1], max_new_tokens=14,
                                 temperature=1.3, stream_seed=8))
    mine = sched.submit(Request(prompt=prompts[0], max_new_tokens=10, **kw))
    sched.run()
    assert other.status == mine.status == "done"
    assert mine.tokens == alone[0]
    assert sched.spec_rollbacks > 0


# ---------------------------------------------------------------------------
# the engine's draft weights
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_int8_draft_is_packed_from_its_own_tree_as_jax(models):
    """Under the int8 weight wire the draft's leaves are packed over the
    draft's own stacked tree (1 layer), not the target's first layer of
    its tree: the codes and scales of the JAX ``quantize_params`` of the
    JAX draft tree (codes equal but at exact .5 ties, scales within one
    ulp), dequantizing to the same values."""
    params = models[1]
    eng = _engine(models, _draft(models), weight_wire="int8")
    is_packed = lambda x: isinstance(x, jax_serve_model.PackedWeight)  # noqa: E731
    jtree = jax_serve_model.quantize_params(jax_spec.draft_from_params(
        params, 1))
    jleaves = dict(_leaves(jax.tree_util.tree_map(
        lambda x: x, jtree, is_leaf=is_packed)))
    leaves = dict(_leaves(eng.draft_weights.tree))
    assert sorted(leaves) == sorted(jleaves)
    n_packed = 0
    for path, leaf in leaves.items():
        jleaf = jleaves[path]
        if not is_packed(jleaf):
            assert not isinstance(leaf, PackedWeight)
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
            continue
        n_packed += 1
        assert leaf.shape == jleaf.shape and leaf.n == jleaf.n
        np.testing.assert_array_max_ulp(leaf.scale.numpy(),
                                        np.asarray(jleaf.scale), maxulp=1)
        diff = leaf.codes.numpy().astype(np.int32) - np.asarray(
            jleaf.codes).astype(np.int32)
        assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 1e-3
        np.testing.assert_allclose(leaf.unpack().numpy(),
                                   np.asarray(jleaf.unpack()), atol=1e-6)
    assert n_packed == 5
    # the draft's stacked leaves hold 1 layer: not the target's packing
    target = quantize_params(gpt_param_tree(models[4]))
    qkv = leaves[("params", "layers", "block", "qkv", "weight")]
    assert qkv.shape[0] == 1 and target["params"]["layers"]["block"][
        "qkv"]["weight"].shape[0] == 2


@pytest.mark.parametrize("weight_wire", ["f32", "int8"])
def test_update_draft_params_writes_in_place(models, weight_wire):
    cfg, model = models[3], models[4]
    eng = _engine(models, _draft(models), weight_wire=weight_wire)
    if weight_wire == "int8":
        before = [t.codes if isinstance(t, PackedWeight) else t
                  for t in eng.draft_weights.leaves()]
    else:
        before = list(eng.draft_weights.parameters())
    ptrs = [t.data_ptr() for t in before]
    fresh = dataclasses.replace(cfg, num_layers=1)
    from apex_tpu_torch.models import GptModel

    new = GptModel(fresh, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    eng.update_draft_params(new)
    if weight_wire == "int8":
        after = [t.codes if isinstance(t, PackedWeight) else t
                 for t in eng.draft_weights.leaves()]
        want = spec_lib.model_lib.PackedParams(fresh, new)
        for a, w in zip(eng.draft_weights.leaves(), want.leaves()):
            if isinstance(a, PackedWeight):
                assert torch.equal(a.codes, w.codes)
            else:
                assert torch.equal(a, w)
    else:
        after = list(eng.draft_weights.parameters())
        src = dict(new.named_parameters())
        for name, p in eng.draft_weights.named_parameters():
            assert torch.equal(p, src[name].to(p.dtype)), name
    assert [t.data_ptr() for t in after] == ptrs
    eng.update_draft_params(None)  # no new draft: nothing changes
    with pytest.raises(ValueError, match="self-draft"):
        _engine(models, SpecConfig(None)).update_draft_params(new)
    with pytest.raises(ValueError, match="config differs"):
        eng.update_draft_params(model)


def test_engine_validates_the_draft(models):
    cfg, model = models[3], models[4]
    from apex_tpu_torch.models import GptModel

    wrong_vocab = GptModel(dataclasses.replace(cfg, vocab_size=64,
                                               num_layers=1), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        _engine(models, SpecConfig(wrong_vocab))
    short = GptModel(dataclasses.replace(cfg, max_seq_len=64, num_layers=1),
                     device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        _engine(models, SpecConfig(short))
    with pytest.raises(ValueError, match="differs"):
        _engine(models, SpecConfig(draft_from_params(model, 1),
                                   draft_cfg=cfg))
    with pytest.raises(ValueError, match="no speculative config"):
        _engine(models).spec_step([0, 0], [0, 0], None, None, None, [0, 0],
                                  [0, 0])

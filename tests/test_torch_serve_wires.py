"""apex_tpu_torch's int8 wires and chunked prefill vs the JAX package.

- **The codec** (``apex_tpu_torch.parallel.comm``): codes equal to
  ``apex_tpu.parallel.comm.quantize_blocks``'s except at exact .5 ties of
  ``x / scale``, where they may differ by one (XLA's CPU division and
  PyTorch's can round a quotient to the other side of a tie; both round
  half to even, which the exact-tie case pins); scales within one f32
  ulp; zero blocks, tails and the round trip as a fixed point.
- **The packed weights**: ``encode_kv``, and ``quantize_params`` /
  ``dequantize_params`` leaf by leaf, the port's tree made by
  ``gpt_param_tree`` from weights carried over by ``from_jax_params``.
- **The engine** at f32 (vocab 128, hidden 64, 2 layers, 4 heads, page
  16): a prefill and 5 decode steps on the int8 KV wire, and a prefill on
  the int8 weight wire, against the JAX engine (``verify=False``): logits
  within 1e-4, greedy tokens identical; and on the KV wire against the
  unpaged forward within ``TOL_INT8_KV`` (5e-2, the reference's pin).
- **Chunked prefill**: ``chunk_prefill_body`` against JAX's on both KV
  wires (logits within 1e-4; the pages written within 1e-4, int8 codes
  within one step at the few elements a 1e-7 difference puts across a
  rounding edge), and two chunks against the monolithic prefill.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GptConfig as JaxGptConfig
from apex_tpu.models.gpt import GptModel as JaxGptModel
from apex_tpu.models.gpt import _tied_vocab_logits
from apex_tpu.parallel import comm as jax_comm
from apex_tpu.serve import InferenceEngine as JaxEngine
from apex_tpu.serve import ServeConfig as JaxServeConfig
from apex_tpu.serve import cache as jax_cache
from apex_tpu.serve import model as jax_serve_model
from apex_tpu_torch.models import GptConfig, from_jax_params, gpt_param_tree
from apex_tpu_torch.parallel import comm
from apex_tpu_torch.serve import (
    NULL_PAGE,
    InferenceEngine,
    PackedParams,
    PackedWeight,
    ServeConfig,
    chunk_prefill_body,
    dequantize_params,
    encode_kv,
    init_kv_pages,
    prefill_body,
    quantize_params,
)

TOL = dict(atol=1e-4, rtol=1e-4)
TOL_INT8_KV = 5e-2
PAGE = 16
NUM_PAGES = 32
DIMS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_seq_len=128)
SERVE = dict(page_size=PAGE, num_pages=NUM_PAGES, max_batch=2,
             max_pages_per_seq=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxGptConfig(**DIMS, dtype=jnp.float32)
    jmodel = JaxGptModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((8, 1), jnp.int32))
    cfg = GptConfig(**DIMS, dtype=torch.float32)
    model = from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu"
    )
    return jcfg, jmodel, params, cfg, model


def _unpaged_logits(jmodel, params, token_ids):
    ids = jnp.asarray(np.asarray(token_ids, np.int32)[:, None])
    h = jmodel.apply(params, ids)
    return np.asarray(
        _tied_vocab_logits(params, jmodel, h, sp_gathered=False)[:, 0]
    )


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def _codec_both(x, block):
    jq, js = jax_comm.quantize_blocks(jnp.asarray(x), block=block)
    q, s = comm.quantize_blocks(torch.from_numpy(x), block=block)
    return np.asarray(jq), np.asarray(js), q.numpy(), s.numpy()


def _check_codes(x, block, jq, js, q, s):
    """Scales within one ulp; codes equal but at exact ties of the
    port's quotient, where they may differ by one.  Returns the number
    of ties and of differing codes."""
    np.testing.assert_array_max_ulp(s, js, maxulp=1)
    n = x.shape[-1]
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, q.shape[-1] - n)])
    quot = (torch.from_numpy(xp).reshape(*x.shape[:-1], -1, block)
            / torch.from_numpy(s)[..., None]).reshape(q.shape).numpy()
    tie = np.abs(quot - np.trunc(quot)) == 0.5
    diff = q.astype(np.int32) - jq.astype(np.int32)
    assert np.all(np.abs(diff) <= 1)
    assert not np.any((diff != 0) & ~tie), "codes differ off a tie"
    return int(tie.sum()), int((diff != 0).sum())


@pytest.mark.parametrize("shape,block", [
    ((4, 1024), 256), ((3, 1000), 256), ((7, 64), 64), ((2, 5, 33), 16),
    ((1, 300), 128),
])
def test_codec_matches_jax(shape, block):
    rs = np.random.RandomState(sum(shape) + block)
    x = (rs.randn(*shape) * rs.choice([1e-3, 1.0, 50.0], shape[:-1] + (1,))
         ).astype(np.float32)
    jq, js, q, s = _codec_both(x, block)
    assert q.shape == jq.shape and q.dtype == np.int8
    assert s.shape == js.shape and s.dtype == np.float32
    ties, diffs = _check_codes(x, block, jq, js, q, s)
    assert diffs <= ties


def test_codec_zero_blocks_tails_and_ties():
    block = 8
    x = np.zeros((3, 20), np.float32)
    x[1, :12] = np.arange(12) - 5.5       # a zero-padded tail block
    x[2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]  # scale 1: ties
    jq, js, q, s = _codec_both(x, block)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    # all-zero blocks get scale 1.0 and zero codes
    assert s[0].tolist() == [1.0, 1.0, 1.0] and not q[0].any()
    assert s[1, 2] == 1.0 and not q[1, 16:].any()
    # round half to even, as jnp.round
    assert q[2, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]


def test_codec_round_trip_is_a_fixed_point():
    rs = np.random.RandomState(11)
    x = torch.from_numpy(rs.randn(6, 777).astype(np.float32))
    q, s = comm.quantize_blocks(x)
    y = comm.dequantize_blocks(q, s, n=777)
    assert y.shape == x.shape
    assert float((y - x).abs().max()) <= float(s.max()) / 2 * (1 + 1e-6)
    q2, s2 = comm.quantize_blocks(y)
    torch.testing.assert_close(comm.dequantize_blocks(q2, s2, n=777), y,
                               atol=0, rtol=0)
    jy = jax_comm.dequantize_blocks(jnp.asarray(q.numpy()),
                                    jnp.asarray(s.numpy()), n=777)
    np.testing.assert_array_equal(np.asarray(jy), y.numpy())


def test_encode_kv_matches_jax():
    rs = np.random.RandomState(12)
    x = rs.randn(3, 4, 16, 24).astype(np.float32)
    x[0, 1] = 0.0  # a zero row: scale 1
    jc, js = jax_cache.encode_kv(jnp.asarray(x))
    c, s = encode_kv(torch.from_numpy(x))
    assert c.shape == x.shape and s.shape == x.shape[:-1]
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    _check_codes(x, 24, np.asarray(jc), np.asarray(js)[..., None],
                 c.numpy(), s.numpy()[..., None])
    assert (s[0, 1] == 1.0).all()


# ---------------------------------------------------------------------------
# the packed weights
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_quantize_params_matches_jax_leaf_by_leaf(models):
    jcfg, jmodel, params, cfg, model = models
    is_packed = lambda x: isinstance(x, jax_serve_model.PackedWeight)  # noqa: E731
    jpacked = dict(_leaves(jax.tree_util.tree_map(
        lambda x: x, jax_serve_model.quantize_params(params),
        is_leaf=is_packed)))
    tree = gpt_param_tree(model)
    dense_in = dict(_leaves(tree))
    packed = dict(_leaves(quantize_params(tree)))
    assert sorted(jpacked) == sorted(packed)
    n_packed = 0
    for name, leaf in packed.items():
        jleaf = jpacked[name]
        if is_packed(jleaf):
            n_packed += 1
            assert isinstance(leaf, PackedWeight), name
            assert leaf.shape == jleaf.shape and leaf.n == jleaf.n
            _check_codes(
                dense_in[name].reshape(1, -1).numpy(), leaf.block,
                np.asarray(jleaf.codes)[None], np.asarray(jleaf.scale)[None],
                leaf.codes.numpy()[None], leaf.scale.numpy()[None])
        else:
            assert not isinstance(leaf, PackedWeight), name
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    # the embedding table and the four stacked matrices (>= 1024 elements)
    assert n_packed == 5
    jdense = dict(_leaves(jax_serve_model.dequantize_params(
        jax_serve_model.quantize_params(params))))
    dense = dict(_leaves(dequantize_params(quantize_params(tree))))
    for name, leaf in dense.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jdense[name]),
                                   atol=1e-6, rtol=0, err_msg=name)


def test_packed_layer_slices_equal_the_whole_leaf():
    """A leaf stacked on its first axis whose per-layer size is not a
    block multiple: each layer's slice dequantizes only its blocks and
    equals the whole leaf's row."""
    rs = np.random.RandomState(13)
    leaf = torch.from_numpy(rs.randn(3, 5, 77).astype(np.float32))
    (packed,) = quantize_params({"w": leaf}).values()
    whole = packed.unpack()
    for i in range(3):
        torch.testing.assert_close(packed.layer(i), whole[i], atol=0, rtol=0)
    small = quantize_params({"b": leaf[0, 0]})["b"]
    assert small is leaf[0, 0] or torch.equal(small, leaf[0, 0])


def test_packed_params_hold_codes_not_dense_weights(models):
    _, _, _, cfg, model = models
    packed = PackedParams(cfg, model)
    dense = sum(p.numel() * 4 for p in model.parameters())
    assert packed.nbytes() < 0.3 * dense
    eng = InferenceEngine(cfg, model, ServeConfig(**SERVE,
                                                  weight_wire="int8"),
                          device="cpu")
    assert eng.model is None and eng.params is not None
    assert eng.weight_bytes() == eng.params.nbytes()


# ---------------------------------------------------------------------------
# the engine on the int8 wires
# ---------------------------------------------------------------------------


def _engines(models, **kw):
    jcfg, _, params, cfg, model = models
    jeng = JaxEngine(jcfg, params, JaxServeConfig(**SERVE, **kw,
                                                  verify=False))
    eng = InferenceEngine(cfg, model, ServeConfig(**SERVE, **kw),
                          device="cpu")
    return jeng, eng


def test_int8_kv_prefill_and_decode_match_jax(models):
    """A prefill and 5 decode steps on the int8 KV wire: logits within
    1e-4 of the JAX engine's, greedy tokens identical, and within
    TOL_INT8_KV of the unpaged f32 forward."""
    _, jmodel, params, cfg, _ = models
    jeng, eng = _engines(models, kv_wire="int8")
    assert eng.cache["k"].dtype == torch.int8
    assert eng.cache["k_scale"].shape == (2, NUM_PAGES, 4, PAGE)
    rs = np.random.RandomState(4)
    prompt = [int(t) for t in rs.randint(0, cfg.vocab_size, size=13)]
    pages = [3, 7]
    jl, jt = jeng.prefill(prompt, pages[:1])
    lg, tok = eng.prefill(prompt, pages[:1])
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    assert tok == jt
    cur, ctx = list(prompt), len(prompt)
    table = np.zeros((2, 8), np.int32)
    table[0, :2] = pages
    for _ in range(5):
        jl, jn = jeng.decode(np.array([tok, 0]), np.array([ctx + 1, 0]),
                             table)
        lg, nxt = eng.decode(np.array([tok, 0]), np.array([ctx + 1, 0]),
                             table)
        np.testing.assert_allclose(lg[0].numpy(), np.asarray(jl)[0], **TOL)
        assert int(nxt[0]) == int(jn[0])
        cur.append(tok)
        ref = _unpaged_logits(jmodel, params, cur)[-1]
        assert np.abs(lg[0].numpy() - ref).max() <= TOL_INT8_KV
        assert eng.last_decode_finite.tolist() == [True, True]
        ctx += 1
        tok = int(nxt[0])
    for name in ("k", "v"):
        codes = eng.cache[name][:, pages].numpy().astype(np.int32)
        jcodes = np.asarray(jeng.cache[name])[:, pages].astype(np.int32)
        assert np.abs(codes - jcodes).max() <= 1
        assert (codes != jcodes).mean() < 1e-3
        np.testing.assert_allclose(
            eng.cache[name + "_scale"][:, pages].numpy(),
            np.asarray(jeng.cache[name + "_scale"])[:, pages], **TOL)


def test_int8_weight_wire_prefill_matches_jax(models):
    _, jmodel, params, cfg, _ = models
    jeng, eng = _engines(models, weight_wire="int8")
    rs = np.random.RandomState(5)
    prompt = [int(t) for t in rs.randint(0, cfg.vocab_size, size=9)]
    jl, jt = jeng.prefill(prompt, [2])
    lg, tok = eng.prefill(prompt, [2])
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    assert tok == jt
    # the wire moves the logits off the dense weights' a little, as in
    # the reference
    ref = _unpaged_logits(jmodel, params, prompt)[-1]
    assert 0 < np.abs(lg.numpy() - ref).max() <= TOL_INT8_KV
    # and a decode step on the packed weights
    table = np.zeros((2, 8), np.int32)
    table[0, 0] = 2
    jl, jn = jeng.decode(np.array([tok, 0]), np.array([10, 0]), table)
    lg, nxt = eng.decode(np.array([tok, 0]), np.array([10, 0]), table)
    np.testing.assert_allclose(lg[0].numpy(), np.asarray(jl)[0], **TOL)
    assert int(nxt[0]) == int(jn[0])


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------


def _pools(cfg, kv_wire):
    jkv = jax_cache.init_kv_pages(
        cfg.num_layers, NUM_PAGES, cfg.num_heads, PAGE, cfg.head_dim,
        dtype=jnp.float32, kv_wire=kv_wire,
    )
    kv = init_kv_pages(
        cfg.num_layers, NUM_PAGES, cfg.num_heads, PAGE, cfg.head_dim,
        dtype=torch.float32, device="cpu", kv_wire=kv_wire,
    )
    return jkv, kv


def _chunk_both(models, jkv, kv, chunk, offset, chunk_pages, table, bucket,
                kv_wire):
    jcfg, _, params, cfg, model = models
    tokens = np.zeros((bucket, 1), np.int32)
    tokens[: len(chunk), 0] = chunk
    ids = np.full((bucket // PAGE,), NULL_PAGE, np.int32)
    ids[: len(chunk_pages)] = chunk_pages
    row = np.full((8,), NULL_PAGE, np.int32)
    row[: len(table)] = table
    jl, jt, jf, jkv = jax_serve_model.chunk_prefill_body(
        jcfg, params, jkv, jnp.asarray(tokens), jnp.asarray(len(chunk)),
        jnp.asarray(offset), jnp.asarray(ids), jnp.asarray(row),
        page_size=PAGE, kv_wire=kv_wire,
    )
    lg, tok, fin, kv = chunk_prefill_body(
        cfg, model, kv, torch.from_numpy(tokens).long(), len(chunk), offset,
        torch.from_numpy(ids), torch.from_numpy(row), page_size=PAGE,
        kv_wire=kv_wire,
    )
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    assert int(tok) == int(jt) and bool(fin) and bool(jf)
    return jkv, kv, lg


def _assert_pages(jkv, kv, pages, kv_wire):
    for name in ("k", "v"):
        got = kv[name][:, pages].numpy()
        want = np.asarray(jkv[name])[:, pages]
        if kv_wire == "f32":
            np.testing.assert_allclose(got, want, **TOL)
            continue
        diff = got.astype(np.int32) - want.astype(np.int32)
        assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 1e-3
        np.testing.assert_allclose(kv[name + "_scale"][:, pages].numpy(),
                                   np.asarray(jkv[name + "_scale"])[:, pages],
                                   **TOL)


@pytest.mark.parametrize("kv_wire", ["f32", "int8"])
def test_chunk_prefill_body_matches_jax(models, kv_wire):
    """A 45-token prompt in chunks of 32 and 13: the second chunk reads
    the first's pages through the cache wire."""
    _, _, _, cfg, model = models
    rs = np.random.RandomState(6)
    prompt = rs.randint(0, cfg.vocab_size, size=45)
    pages = [4, 9, 2]
    jkv, kv = _pools(cfg, kv_wire)
    jkv, kv, _ = _chunk_both(models, jkv, kv, prompt[:32], 0, pages[:2],
                             pages, 32, kv_wire)
    _assert_pages(jkv, kv, pages[:2], kv_wire)
    jkv, kv, _ = _chunk_both(models, jkv, kv, prompt[32:], 32, pages[2:],
                             pages, 16, kv_wire)
    _assert_pages(jkv, kv, pages, kv_wire)


def test_chunked_prefill_equals_monolithic(models):
    """At f32 the two chunks' last logits and pages equal the monolithic
    prefill's (within 1e-4)."""
    _, _, _, cfg, model = models
    rs = np.random.RandomState(7)
    prompt = rs.randint(0, cfg.vocab_size, size=45)
    pages = [4, 9, 2]
    _, kv = _pools(cfg, "f32")
    row = torch.tensor(pages + [0] * 5)
    for start, stop, bucket in ((0, 32, 32), (32, 45, 16)):
        tokens = torch.zeros((bucket, 1), dtype=torch.long)
        tokens[: stop - start, 0] = torch.from_numpy(prompt[start:stop])
        ids = torch.tensor(pages[start // PAGE: -(-stop // PAGE)]
                           + [0] * (bucket // PAGE - len(
                               pages[start // PAGE: -(-stop // PAGE)])))
        lg, tok, _, kv = chunk_prefill_body(
            cfg, model, kv, tokens, stop - start, start, ids, row,
            page_size=PAGE)
    _, mono = _pools(cfg, "f32")
    tokens = torch.zeros((64, 1), dtype=torch.long)
    tokens[:45, 0] = torch.from_numpy(prompt)
    ml, mt, _, mono = prefill_body(cfg, model, mono, tokens, 45,
                                   torch.tensor(pages + [0]), page_size=PAGE)
    torch.testing.assert_close(lg, ml, **TOL)
    assert int(tok) == int(mt)
    for name in ("k", "v"):
        # positions 0..44 (the monolithic prefill's padded tail differs)
        got = kv[name][:, pages].transpose(2, 3).reshape(2, -1, 4, 16)[:, :45]
        want = mono[name][:, pages].transpose(2, 3).reshape(
            2, -1, 4, 16)[:, :45]
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("kv_wire,tol", [("f32", 1e-4),
                                         ("int8", TOL_INT8_KV)])
def test_chunk_past_the_rope_table(models, kv_wire, tol):
    """A chunk whose padded bucket runs past ``max_seq_len`` (a 111-token
    chunk at offset 16, bucket 128).  The reference's ``jnp.take`` fills
    the RoPE rows past the table with NaN; the padded rows carry it into
    the next layer's V, and ``0 * NaN`` turns the live logits NaN (a
    fault of the reference, ROADMAP C5).  The port reads the table's last
    row there: its logits equal the JAX monolithic prefill's (within
    1e-4 at f32, ``TOL_INT8_KV`` when the first chunk is read back
    through the int8 wire) and its pool stays finite."""
    jcfg, _, params, cfg, model = models
    rs = np.random.RandomState(8)
    prompt = rs.randint(0, cfg.vocab_size, size=127)
    pages = [5, 6, 7, 8, 9, 10, 11, 12]
    jkv, kv = _pools(cfg, kv_wire)
    row = np.array(pages, np.int32)
    for start, stop, bucket in ((0, 16, 16), (16, 127, 128)):
        tokens = np.zeros((bucket, 1), np.int32)
        tokens[: stop - start, 0] = prompt[start:stop]
        ids = np.full((bucket // PAGE,), NULL_PAGE, np.int32)
        own = pages[start // PAGE: -(-stop // PAGE)]
        ids[: len(own)] = own
        jl, _, jf, jkv = jax_serve_model.chunk_prefill_body(
            jcfg, params, jkv, jnp.asarray(tokens), jnp.asarray(stop - start),
            jnp.asarray(start), jnp.asarray(ids), jnp.asarray(row),
            page_size=PAGE, kv_wire=kv_wire)
        lg, tok, fin, kv = chunk_prefill_body(
            cfg, model, kv, torch.from_numpy(tokens).long(), stop - start,
            start, torch.from_numpy(ids), torch.from_numpy(row),
            page_size=PAGE, kv_wire=kv_wire)
    assert not bool(jf) and np.isnan(np.asarray(jl)).all()
    assert bool(fin)
    for t in kv.values():
        assert bool(torch.isfinite(t.float()).all())
    mono = np.zeros((128, 1), np.int32)
    mono[:127, 0] = prompt
    ml, mt, _, _ = jax_serve_model.prefill_body(
        jcfg, params, _pools(cfg, "f32")[0], jnp.asarray(mono),
        jnp.asarray(127), jnp.asarray(row), page_size=PAGE)
    np.testing.assert_allclose(lg.numpy(), np.asarray(ml), atol=tol,
                               rtol=tol)
    if kv_wire == "f32":
        assert int(tok) == int(mt)

"""K6's split-KV plan and its split-and-merge arithmetic, on the CPU.

K6 (``csrc/paged_decode.cu``) spreads each sequence's page-table row over
``n_split`` CTAs of ``split_pages`` pages, from the plan
``decode_split_plan`` makes of the shapes alone; each split keeps an
online-softmax state (m, l, acc) over 32-token tiles and the last CTA to
arrive merges the splits in split order.

- The plan: every live page of every length is walked by exactly one
  split, no split starts past the row, the grid is a function of the
  shapes (the lengths are not an argument), and at the serving shape
  (B 8, H 16, NP 128, page 16) it covers the SMs with splits of a few
  pages.
- A plain PyTorch mirror of the kernel's arithmetic (per-split states
  over 32-token tiles, then the merge in split order), at lengths that
  straddle a split (0, 1, a split exactly, a split + 1, NP * page and
  others), with bf16-valued f32 pages and with int8 pages and their
  scales, with the fused RoPE, at D 32 and 160: held against the JAX
  package's ``paged_decode_attention`` on its Pallas kernel in interpret
  mode and against the port's unsplit twin; tolerance 2e-6, as
  ``test_torch_paged_attention.py``.

The mirror stands alone here: it is not a feature of the port.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _dispatch as jax_dispatch
from apex_tpu.ops.paged_attention import paged_decode_attention as jax_paged
from apex_tpu.serve.cache import encode_kv
from apex_tpu_torch.ops.paged_attention import (
    SPLIT_MAX,
    SPLIT_MIN_TOKENS,
    decode_split_plan,
    paged_decode_attention_reference,
)
from apex_tpu_torch.ops.rope import rotate_half

PAGED_TOL = dict(atol=2e-6, rtol=2e-6)
TILE = 32  # the kernel's tokens a tile at these head dims


@pytest.fixture
def force_pallas():
    jax_dispatch.set_use_pallas(True)
    yield
    jax_dispatch.set_use_pallas(None)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _splits_of(length, page, np_, split, n_split):
    """The page ranges the live splits of a sequence of ``length`` walk,
    as the kernel bounds them."""
    live = min(-(-length // page), np_)
    n_live = max(1, -(-live // split))
    assert n_live <= n_split
    return [range(s * split, min((s + 1) * split, live)) for s in range(n_live)]


SHAPES = [(8, 16, 128, 16, 132), (3, 4, 3, 8, 132), (1, 1, 4096, 16, 132),
          (256, 32, 512, 16, 132), (4, 2, 9, 1, 132), (2, 3, 7, 64, 8)]


@pytest.mark.parametrize("batch,heads,np_,page,sms", SHAPES)
def test_plan_walks_every_live_page_once(batch, heads, np_, page, sms):
    split, n_split = decode_split_plan(batch, heads, np_, page, sms)
    assert 1 <= split <= np_ and 1 <= n_split <= SPLIT_MAX
    assert n_split * split >= np_ > (n_split - 1) * split
    rs = np.random.RandomState(np_)
    lengths = [0, 1, page, split * page, split * page + 1, np_ * page,
               np_ * page + 5] + list(rs.randint(0, np_ * page + 1, 20))
    for length in lengths:
        walked = [p for r in _splits_of(length, page, np_, split, n_split)
                  for p in r]
        assert walked == list(range(min(-(-length // page), np_)))


@pytest.mark.parametrize("batch,heads,np_,page,sms", SHAPES)
def test_plan_depends_on_shapes_only(batch, heads, np_, page, sms):
    """The plan is a pure function of the shapes: same shapes, same grid,
    whatever the lengths; splits walk at least SPLIT_MIN_TOKENS tokens
    unless the row is shorter."""
    plan = decode_split_plan(batch, heads, np_, page, sms)
    assert all(decode_split_plan(batch, heads, np_, page, sms) == plan
               for _ in range(3))
    split, _ = plan
    assert split * page >= min(SPLIT_MIN_TOKENS, np_ * page)


def test_plan_at_the_serving_shape_covers_the_card():
    """B 8, H 16, NP 128, page 16: 4-page splits, 32 a row, 4096 CTAs, so
    the 2048-token sequences spread over 32 CTAs each."""
    split, n_split = decode_split_plan(8, 16, 128, 16, 132)
    assert (split, n_split) == (4, 32)
    assert 8 * 16 * n_split >= 2 * 132


def test_plan_refuses_empty_shapes():
    for args in ((0, 1, 1, 1, 1), (1, 0, 1, 1, 1), (1, 1, 0, 1, 1),
                 (1, 1, 1, 0, 1), (1, 1, 1, 1, 0)):
        with pytest.raises(ValueError):
            decode_split_plan(*args)


# ---------------------------------------------------------------------------
# the split-and-merge arithmetic
# ---------------------------------------------------------------------------


def split_merge_decode(q, k_pages, v_pages, page_table, lengths, *, scale,
                       split_pages, n_split, k_scale=None, v_scale=None,
                       rope_cos=None, rope_sin=None):
    """K6's arithmetic in plain PyTorch, f32: each split's online softmax
    over TILE-token tiles of its pages (rows past the length weigh 0),
    then the splits' states merged in split order; one live split writes
    acc / l directly, an idle slot zeros."""
    b, h, d = q.shape
    page = k_pages.shape[2]
    np_ = page_table.shape[1]
    qf = q.float()
    if rope_cos is not None:
        qf = (qf * rope_cos.float()[:, None] +
              rotate_half(qf) * rope_sin.float()[:, None])
    out = torch.zeros(b, h, d)
    for bi in range(b):
        length = int(lengths[bi])
        live = min(-(-length // page), np_)
        n_live = max(1, -(-live // split_pages))
        assert n_live <= n_split
        for hi in range(h):
            states = []
            for s in range(n_live):
                tok0 = s * split_pages * page
                tok_end = min(length, np_ * page, (s + 1) * split_pages * page)
                m, l, acc = -math.inf, torch.tensor(0.0), torch.zeros(d)
                for t0 in range(tok0, tok_end, TILE):
                    toks = range(t0, min(t0 + TILE, tok_end))
                    pid = [int(page_table[bi, t // page]) for t in toks]
                    slot = [t % page for t in toks]
                    k = k_pages[pid, hi, slot].float()
                    v = v_pages[pid, hi, slot].float()
                    sc = (k @ qf[bi, hi]) * scale
                    w = None
                    if k_scale is not None:
                        sc = sc * k_scale[pid, hi, slot]
                        w = v_scale[pid, hi, slot]
                    m_new = max(m, float(sc.max()))
                    alpha = math.exp(m - m_new) if m > -math.inf else 0.0
                    p = torch.exp(sc - m_new)
                    l = l * alpha + p.sum()
                    acc = acc * alpha + (p if w is None else p * w) @ v
                    m = m_new
                states.append((m, l, acc))
            if n_live == 1:
                m, l, acc = states[0]
                out[bi, hi] = acc / l if l > 0 else 0.0
                continue
            mm = max(st[0] for st in states)
            ll = sum(st[1] * math.exp(st[0] - mm) for st in states)
            oo = sum(st[2] * math.exp(st[0] - mm) for st in states)
            out[bi, hi] = oo / ll
    return out


def _case(d, int8, seed):
    """Pages, table and lengths that straddle a split: (B 6, H 2, page 16,
    NP 12) gives 4-page (64-token) splits, 3 a row."""
    rs = np.random.RandomState(seed)
    b, h, page, np_, pool = 6, 2, 16, 12, 80
    kp = rs.randn(pool, h, page, d).astype(np.float32)
    vp = rs.randn(pool, h, page, d).astype(np.float32)
    q = rs.randn(b, h, d).astype(np.float32)
    table = (rs.permutation(pool - 1)[: b * np_].reshape(b, np_) + 1).astype(
        np.int32)
    lengths = np.asarray([0, 1, 64, 65, np_ * page, 100], np.int32)
    kw = dict(rope_cos=rs.randn(b, d).astype(np.float32),
              rope_sin=rs.randn(b, d).astype(np.float32))
    if int8:
        kp, ks = (np.array(a) for a in encode_kv(jnp.asarray(kp)))
        vp, vs = (np.array(a) for a in encode_kv(jnp.asarray(vp)))
        kw.update(k_scale=ks, v_scale=vs)
    return q, kp, vp, table, lengths, kw


@pytest.mark.parametrize("d", [32, 160])
@pytest.mark.parametrize("int8", [False, True])
def test_split_merge_matches_jax_kernel_and_the_unsplit_twin(force_pallas, d,
                                                             int8):
    q, kp, vp, table, lengths, kw = _case(d, int8, 90 + d + int8)
    b, h, _ = q.shape
    page, np_ = kp.shape[2], table.shape[1]
    split, n_split = decode_split_plan(b, h, np_, page, 132)
    assert (split, n_split) == (4, 3)
    scale = d ** -0.5
    ref = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(table), jnp.asarray(lengths),
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    assert jax_dispatch.last_paths()["paged_decode_attention"] == "pallas"
    ts = [torch.from_numpy(a) for a in (q, kp, vp, table, lengths)]
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    got = split_merge_decode(*ts, scale=scale, split_pages=split,
                             n_split=n_split, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PAGED_TOL)
    twin = paged_decode_attention_reference(*ts, scale=scale, **tkw)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), **PAGED_TOL)
    # one split a row (the whole row in one CTA) gives the same output
    whole = split_merge_decode(*ts, scale=scale, split_pages=np_, n_split=1,
                               **tkw)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **PAGED_TOL)
    assert float(got[0].abs().max()) == 0.0  # the idle slot

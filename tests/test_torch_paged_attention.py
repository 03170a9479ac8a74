"""apex_tpu_torch paged decode attention vs the JAX package.

The port's gather-based plain version (what its CUDA kernel K6 is held
against on the card) against ``apex_tpu.ops.paged_attention.
paged_decode_attention`` forced onto its Pallas kernel in interpret
mode, on the case shapes of ``tests/test_attention.py``'s paged tests
(3 sequences, 4 heads, D = 32, page 8, lengths 17 / 9 / 0): plain, with
the fused query RoPE, on int8 pages with per-row scales, and the idle
slot.  Tolerance 2e-6, the JAX package's own kernel-vs-reference pin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _dispatch as jax_dispatch
from apex_tpu.ops.paged_attention import paged_decode_attention as jax_paged
from apex_tpu.serve.cache import encode_kv
from apex_tpu_torch.ops import _dispatch
from apex_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_reference,
)

TOL = dict(atol=2e-6, rtol=2e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs several workers
    at once, and some of their tests time the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def force_pallas():
    jax_dispatch.set_use_pallas(True)
    yield
    jax_dispatch.set_use_pallas(None)


def _paged_case(seed, b=3, h=4, d=32, page=8, pool=12, np_=3,
                lengths=(17, 9, 0)):
    rs = np.random.RandomState(seed)
    k_pages = rs.randn(pool, h, page, d).astype(np.float32)
    v_pages = rs.randn(pool, h, page, d).astype(np.float32)
    q = rs.randn(b, h, d).astype(np.float32)
    table = (rs.permutation(pool - 1)[: b * np_].reshape(b, np_) + 1).astype(
        np.int32
    )
    cos = rs.randn(b, d).astype(np.float32)
    sin = rs.randn(b, d).astype(np.float32)
    return q, k_pages, v_pages, table, np.asarray(lengths, np.int32), cos, sin


def _both(q, kp, vp, table, lengths, **kw):
    ref = jax_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths),
        **{k: jnp.asarray(v) for k, v in kw.items()},
    )
    out = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lengths),
        **{k: torch.from_numpy(v) for k, v in kw.items()},
    )
    assert jax_dispatch.last_paths()["paged_decode_attention"] == "pallas"
    assert _dispatch.last_paths()["paged_decode_attention"] == "torch"
    return out, np.asarray(ref)


@pytest.mark.parametrize("rope", [False, True])
def test_matches_jax_kernel(force_pallas, rope):
    q, kp, vp, table, lengths, cos, sin = _paged_case(0)
    kw = dict(rope_cos=cos, rope_sin=sin) if rope else {}
    out, ref = _both(q, kp, vp, table, lengths, **kw)
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_int8_pages_match_jax_kernel(force_pallas):
    q, kp, vp, table, lengths, cos, sin = _paged_case(3)
    kq, ks = (np.array(a) for a in encode_kv(jnp.asarray(kp)))
    vq, vs = (np.array(a) for a in encode_kv(jnp.asarray(vp)))
    out, ref = _both(
        q, kq, vq, table, lengths, k_scale=ks, v_scale=vs,
        rope_cos=cos, rope_sin=sin,
    )
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_idle_slot_returns_exact_zeros(force_pallas):
    q, kp, vp, table, lengths, _, _ = _paged_case(4)
    out, ref = _both(q, kp, vp, table, lengths)
    assert lengths[2] == 0
    assert float(out[2].abs().max()) == 0.0 and np.abs(ref[2]).max() == 0.0


def test_matches_contiguous_attention():
    """Paging is layout, not math: sequence 0 equals plain attention over
    its pages gathered back into a contiguous history."""
    from apex_tpu_torch.ops.attention import mha_reference

    q, kp, vp, table, lengths, _, _ = _paged_case(1)
    out = paged_decode_attention_reference(*(
        torch.from_numpy(a) for a in (q, kp, vp, table, lengths)
    ))
    s0 = int(lengths[0])
    kc = torch.from_numpy(kp[table[0]]).movedim(0, 1).reshape(4, -1, 32)
    vc = torch.from_numpy(vp[table[0]]).movedim(0, 1).reshape(4, -1, 32)
    ref = mha_reference(
        torch.from_numpy(q[0])[None, :, None, :], kc[None, :, :s0],
        vc[None, :, :s0],
    )
    np.testing.assert_allclose(out[0].numpy(), ref[0, :, 0].numpy(), **TOL)


def test_runs_without_autograd():
    q, kp, vp, table, lengths, _, _ = _paged_case(2)
    qt = torch.from_numpy(q).requires_grad_()
    out = paged_decode_attention(qt, *(
        torch.from_numpy(a) for a in (kp, vp, table, lengths)
    ))
    assert not out.requires_grad

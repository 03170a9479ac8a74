"""apex_tpu_torch flash attention (and the RoPE it rides with) vs the
JAX package.

The port's plain version (what its CUDA kernel K3 is held against on
the card) against ``apex_tpu.ops.attention.flash_attention`` forced onto
its Pallas kernel in interpret mode, on the same seeded numpy inputs,
f32, D = 64.  Tolerance 2e-5: the Pallas kernel runs an online softmax
over key blocks, the port one softmax over the row, so the two sum in
different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _dispatch as jax_dispatch
from apex_tpu.ops import attention as jax_attn
from apex_tpu_torch.ops import _dispatch
from apex_tpu_torch.ops import attention as port_attn

TOL = dict(atol=2e-5, rtol=2e-5)


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


def _qkv(sq, sk, b=1, h=2, d=64, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(
        rs.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk)
    )


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("sq,sk,causal", [
    (128, 128, True),    # the prefill shape class: causal, Sq = Sk
    (200, 200, True),    # ragged: the JAX kernel pads, the port masks
    (128, 128, False),
    (64, 192, True),     # bottom-right causal alignment, Sq < Sk
])
def test_flash_matches_jax_pallas(force_pallas, sq, sk, causal):
    q, k, v = _qkv(sq, sk)
    ref = jax_attn.flash_attention(*_j(q, k, v), causal=causal, scale=0.125)
    out = port_attn.flash_attention(*_t(q, k, v), causal=causal, scale=0.125)
    assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    assert _dispatch.last_paths()["flash_attention"] == "torch"
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("s", [128, 200])
def test_lse_matches_jax(force_pallas, s):
    q, k, v = _qkv(s, s, seed=1)
    o_j, lse_j = jax_attn.flash_attention_with_lse(
        *_j(q, k, v), causal=True, scale=0.125
    )
    o, lse = port_attn.flash_attention_with_lse(
        *_t(q, k, v), causal=True, scale=0.125
    )
    assert lse.shape == (1, 2, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)


def test_reference_matches_jax_reference():
    q, k, v = _qkv(96, 96, seed=2)
    ref = jax_attn.mha_reference(*_j(q, k, v), causal=True)
    out = port_attn.mha_reference(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_fully_masked_rows_average_v():
    """Sq > Sk bottom-right causal: rows that see no key average V
    uniformly (finite MASK_VALUE), as the JAX reference does."""
    q, k, v = _qkv(24, 8, seed=3)
    ref = jax_attn.mha_reference(*_j(q, k, v), causal=True)
    out = port_attn.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        out[0, :, 0].numpy(), v[0].mean(axis=1), **TOL
    )


def test_additive_bias_on_plain_path():
    q, k, v = _qkv(32, 32, seed=4)
    bias = np.random.RandomState(5).randn(1, 1, 1, 32).astype(np.float32)
    ref = jax_attn.mha_reference(*_j(q, k, v), jnp.asarray(bias))
    out = port_attn.flash_attention(*_t(q, k, v), torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("rot_dim", [64, 32])
def test_rope_matches_jax(rot_dim):
    """The f32 rotate_half rotation the prefill applies to q and k,
    including a partial rotary dim that passes the tail through."""
    from apex_tpu.models.gpt import _rope_cos_sin
    from apex_tpu.ops.rope import fused_apply_rotary_pos_emb_cached as jax_rope
    from apex_tpu_torch.models import rope_cos_sin
    from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb_cached

    (x,) = _qkv(48, 48, seed=6)[:1]
    cos_j, sin_j = _rope_cos_sin(48, rot_dim)
    cos, sin = rope_cos_sin(48, rot_dim)
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_j), **TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_j), **TOL)
    ref = jax_rope(jnp.asarray(x), cos_j, sin_j)
    out = fused_apply_rotary_pos_emb_cached(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)

"""apex_tpu_torch LayerNorm/RMSNorm forward vs the JAX package.

The same seeded numpy inputs go through ``apex_tpu.ops.layer_norm``
(forced onto its Pallas kernel in interpret mode where the hidden size
is lane-aligned, and through its jnp path) and through the port's plain
version — the function the port's CUDA kernel K1 is held against on the
card.  Tolerances: f32 1e-5 absolute/relative (the two frameworks sum
the row in different orders); bf16 outputs one bf16 step (2**-7
relative), since each side rounds its own f32 result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _dispatch as jax_dispatch
from apex_tpu.ops import layer_norm as jax_ln
from apex_tpu.ops.pallas import layer_norm as jax_ln_kernel
from apex_tpu_torch.ops import _dispatch
from apex_tpu_torch.ops import layer_norm as port_ln

F32_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs several workers
    at once, and some of their tests time the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_path(request):
    jax_dispatch.set_use_pallas(request.param == "pallas")
    yield request.param
    jax_dispatch.set_use_pallas(None)


def _inputs(rows, hidden, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(rows, hidden) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rs.randn(hidden)).astype(np.float32)
    b = (0.1 * rs.randn(hidden)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("jax_path,hidden", [
    ("pallas", 256), ("jnp", 256), ("jnp", 200), ("jnp", 96),
], indirect=["jax_path"])
@pytest.mark.parametrize("rms", [False, True])
def test_affine_matches_jax(jax_path, hidden, rms):
    x, w, b = _inputs(3 * 4, hidden)
    x3 = x.reshape(3, 4, hidden)
    if rms:
        ref = jax_ln.fused_rms_norm_affine(
            jnp.asarray(x3), jnp.asarray(w), (hidden,), eps=1e-5
        )
        out = port_ln.fused_rms_norm_affine(
            torch.from_numpy(x3), torch.from_numpy(w), (hidden,), eps=1e-5
        )
    else:
        ref = jax_ln.fused_layer_norm_affine(
            jnp.asarray(x3), jnp.asarray(w), jnp.asarray(b), (hidden,),
            eps=1e-5,
        )
        out = port_ln.fused_layer_norm_affine(
            torch.from_numpy(x3), torch.from_numpy(w), torch.from_numpy(b),
            (hidden,), eps=1e-5,
        )
    assert out.shape == x3.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
    op = "rms_norm" if rms else "layer_norm"
    assert _dispatch.last_paths()[op] == "torch"
    expect = "pallas" if jax_path == "pallas" else "jnp"
    assert jax_dispatch.last_paths()[op] == expect


@pytest.mark.parametrize("rms", [False, True])
def test_reference_matches_pallas_kernel_stats(rms):
    """The port's plain version returns what the Pallas K1 returns:
    y, and mu/rstd in f32 (the kernel's (rows, 1) become (rows,))."""
    x, w, b = _inputs(16, 256, seed=1)
    y_j, mu_j, rstd_j = jax_ln_kernel.layer_norm_fwd(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps=1e-5, rms=rms
    )
    y, mu, rstd = port_ln.layer_norm_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        1e-5, rms,
    )
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **F32_TOL)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j)[:, 0], **F32_TOL)
    np.testing.assert_allclose(
        rstd.numpy(), np.asarray(rstd_j)[:, 0], **F32_TOL
    )
    assert mu.dtype == rstd.dtype == torch.float32


@pytest.mark.parametrize("x_is_output", [False, True])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("hidden", [4096, 8192])
def test_wide_rows_match_pallas_kernels(hidden, rms, x_is_output):
    """Rows of K1/K2's wide-row instance: the port's plain K1 and K2 (the
    functions the card's kernels are held against) against the Pallas
    K1 and K2 in interpret mode, the backward on the Pallas forward's
    saved statistics (and its output with ``x_is_output``).  F32_TOL on
    every output: y, mu, rstd and dx come from row sums over 4096 or
    8192 values taken in another order (a few ulps), dw and db from sums
    over the 8 rows."""
    x, w, b = _inputs(8, hidden, seed=4)
    g = np.random.RandomState(5).randn(8, hidden).astype(np.float32)
    y_j, mu_j, rstd_j = jax_ln_kernel.layer_norm_fwd(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps=1e-5, rms=rms)
    y, mu, rstd = port_ln.layer_norm_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        1e-5, rms)
    for got, want in ((y, y_j), (mu, mu_j[:, 0]), (rstd, rstd_j[:, 0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    saved = np.array(y_j) if x_is_output else x
    mu_s, rstd_s = np.array(mu_j), np.array(rstd_j)
    ref = jax_ln_kernel.layer_norm_bwd(
        jnp.asarray(saved), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(mu_s), jnp.asarray(rstd_s), jnp.asarray(g), rms=rms,
        x_is_output=x_is_output)
    out = port_ln.layer_norm_bwd_reference(
        torch.from_numpy(saved), torch.from_numpy(w), torch.from_numpy(b),
        torch.from_numpy(mu_s[:, 0]), torch.from_numpy(rstd_s[:, 0]),
        torch.from_numpy(g), rms, x_is_output)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("rms", [False, True])
def test_non_affine_matches_jax(rms):
    x, _, _ = _inputs(8, 200, seed=2)
    if rms:
        ref = jax_ln.fused_rms_norm(jnp.asarray(x), 200, eps=1e-6)
        out = port_ln.fused_rms_norm(torch.from_numpy(x), 200, eps=1e-6)
    else:
        ref = jax_ln.fused_layer_norm(jnp.asarray(x), 200, eps=1e-6)
        out = port_ln.fused_layer_norm(torch.from_numpy(x), 200, eps=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


def test_bf16_input_matches_jax_within_one_step():
    x, w, b = _inputs(8, 256, seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = port_ln.fused_layer_norm_affine(
        xb, torch.from_numpy(w), torch.from_numpy(b), (256,), eps=1e-5
    )
    ref = jax_ln.fused_layer_norm_affine(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(w), jnp.asarray(b), (256,), eps=1e-5,
    )
    assert out.dtype == torch.bfloat16
    ref_f = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(
        out.float().numpy(), ref_f, atol=2.0 ** -7, rtol=2.0 ** -7
    )


def test_shape_mismatch_raises():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="normalized_shape"):
        port_ln.fused_layer_norm(x, (16,))

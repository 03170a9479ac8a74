"""apex_tpu_torch's fused multihead attention modules and fmha vs the JAX
package.

``SelfMultiheadAttn`` and ``EncdecMultiheadAttn`` at E 64, H 4 (S 16,
enc-dec Sq 16 against Sk 20, batch 3) carry the JAX module's parameters
across (``from_jax_params``) and give its output and ``jax.vjp``'s
gradients (parameters, query, key) on the same seeded inputs: with and
without projection biases and ``include_norm_add``, a ragged boolean
key-padding mask, an additive one (``mask_additive``), an (Sq, Sk)
boolean or additive ``attn_mask`` merged into the padding bias, causal.
The JAX side runs its jnp path there (what its CPU run takes).  Dropout
(p 0.1 and 0.5) runs the JAX kernels in interpret mode (the jnp path's
mask is ``jax.random``'s, not the kernels' hash) with the int32 seed the
JAX module derives from its ``make_rng("dropout")`` key, read off its
``flash_attention`` call and fed to the port's ``dropout_seed``.  A batch
element whose every key is masked is held to the JAX jnp path: the
Pallas backward is wrong on such rows (ROADMAP C1).

``fmha`` (B 2, S 40, H 2, D 16) against the JAX ``fmha`` with ``seqlens``
drawn from 1..S, comparing only the rows inside each sequence (the rows
past it are values the caller masks, as the reference's docstring says);
a 0 length against autodiff of the JAX ``mha_reference``.

Tolerance ``TOL`` (f32; the projections and the softmax sum in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import fmha as jfmha
from apex_tpu.contrib.multihead_attn import modules as jmods
from apex_tpu.ops import _dispatch as jax_dispatch
from apex_tpu.ops import attention as jax_attn
from apex_tpu_torch.contrib import fmha as pfmha
from apex_tpu_torch.contrib.multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
    from_jax_params,
    to_jax_params,
)
from apex_tpu_torch.contrib.multihead_attn import modules as pmods
from apex_tpu_torch.ops import attention as port_attn

TOL = dict(atol=3e-5, rtol=3e-5)
E, H, B, S, SK = 64, 4, 3, 16, 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def force_pallas():
    jax_dispatch.set_use_pallas(True)
    yield
    jax_dispatch.set_use_pallas(None)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _lengths(b, s, seed=5, low=1):
    return np.random.RandomState(seed).randint(low, s + 1, size=b)


def _padding(lengths, s, additive):
    masked = np.arange(s)[None, :] >= lengths[:, None]
    return np.where(masked, -1e4, 0.0).astype(np.float32) if additive \
        else masked


def _attn_mask(sq, sk, kind):
    causal_shape = np.arange(sk)[None, :] > np.arange(sq)[:, None] + (sk - sq)
    if kind == "bool":
        return causal_shape
    return np.where(causal_shape, -1e9, 0.0).astype(np.float32)


def _jax_module(encdec, **kw):
    cls = jmods.EncdecMultiheadAttn if encdec else jmods.SelfMultiheadAttn
    m = cls(embed_dim=E, num_heads=H, **kw)
    q = jnp.zeros((S, B, E))
    args = (q, jnp.zeros((SK, B, E))) if encdec else (q,)
    params = m.init(jax.random.PRNGKey(7), *args)
    rs = np.random.RandomState(8)
    # biases and norm parameters moved off their initial values
    params = jax.tree.map(
        lambda a: np.asarray(a + (0.1 * rs.randn(*a.shape) if a.ndim == 1
                                  else 0.0), np.float32), params)
    return m, params


def _port_module(encdec, params, **kw):
    cls = EncdecMultiheadAttn if encdec else SelfMultiheadAttn
    return from_jax_params(cls(E, H, device="cpu", **kw), params)


def _run_both(encdec, kw, inputs, jax_call_kw=None, port_call_kw=None,
              rngs=None):
    """The JAX and the port module's outputs and gradients (parameters
    in the JAX layout, query, key) for the cotangent ``g``."""
    jm, params = _jax_module(encdec, **kw)
    q, k, kpm, am, g = inputs
    jkw = dict(jax_call_kw or {})

    def jf(p, q_, k_):
        args = (q_, k_) if encdec else (q_,)
        return jm.apply(p, *args,
                        None if kpm is None else jnp.asarray(kpm),
                        None if am is None else jnp.asarray(am),
                        rngs=rngs, **jkw)

    out_j, vjp = jax.vjp(jf, params, jnp.asarray(q), jnp.asarray(k))
    dp_j, dq_j, dk_j = vjp(jnp.asarray(g))
    pm = _port_module(encdec, params, **kw)
    qt = torch.from_numpy(q).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    args = (qt, kt) if encdec else (qt,)
    out = pm(*args, None if kpm is None else torch.from_numpy(kpm),
             None if am is None else torch.from_numpy(am),
             **(port_call_kw or {}))
    out.backward(torch.from_numpy(g))
    grads = to_jax_params(pm, {n: p.grad for n, p in pm.named_parameters()})
    return ((out.detach().numpy(), grads, qt.grad.numpy(),
             None if kt.grad is None else kt.grad.numpy()),
            (np.asarray(out_j), jax.tree.map(np.asarray, dp_j["params"]),
             np.asarray(dq_j), np.asarray(dk_j)))


def _assert_close(got, want, tol=TOL, k_grad=True):
    out, grads, dq, dk = got
    out_j, grads_j, dq_j, dk_j = want
    np.testing.assert_allclose(out, out_j, **tol)
    np.testing.assert_allclose(dq, dq_j, **tol)
    if k_grad:
        np.testing.assert_allclose(dk, dk_j, **tol)
    assert sorted(grads) == sorted(grads_j)
    for name in grads:
        got_t, want_t = grads[name], grads_j[name]
        if isinstance(got_t, dict):
            for leaf in got_t:
                np.testing.assert_allclose(got_t[leaf], want_t[leaf], **tol,
                                           err_msg=f"{name}/{leaf}")
        else:
            np.testing.assert_allclose(got_t, want_t, **tol, err_msg=name)


def _inputs(encdec, mask, attn_mask, seed=0):
    q = _x(S, B, E, seed=seed)
    k = _x(SK, B, E, seed=seed + 1) if encdec else q
    sk = SK if encdec else S
    kpm = None if mask is None else _padding(_lengths(B, sk), sk,
                                              mask == "additive")
    am = None if attn_mask is None else _attn_mask(S, sk, attn_mask)
    g = _x(S, B, E, seed=seed + 2)
    return q, k, kpm, am, g


SELF_CASES = [
    # (bias, include_norm_add, mask, attn_mask, causal)
    (False, False, None, None, False),
    (True, False, "bool", None, False),
    (False, True, "bool", None, False),
    (True, True, "additive", None, False),
    (True, False, "bool", "bool", False),
    (False, True, "bool", "additive", False),
    (True, True, None, None, True),
]


@pytest.mark.parametrize("bias,norm_add,mask,attn_mask,causal", SELF_CASES)
def test_self_attn_matches_jax(bias, norm_add, mask, attn_mask, causal):
    kw = dict(bias=bias, include_norm_add=norm_add,
              mask_additive=mask == "additive")
    got, want = _run_both(False, kw, _inputs(False, mask, attn_mask),
                          dict(causal=causal), dict(causal=causal))
    _assert_close(got, want, k_grad=False)


ENCDEC_CASES = [
    (False, False, None, None),
    (True, False, "bool", "additive"),
    (False, True, "additive", "bool"),
    (True, True, "bool", None),
]


@pytest.mark.parametrize("bias,norm_add,mask,attn_mask", ENCDEC_CASES)
def test_encdec_attn_matches_jax(bias, norm_add, mask, attn_mask):
    kw = dict(bias=bias, include_norm_add=norm_add,
              mask_additive=mask == "additive")
    got, want = _run_both(True, kw, _inputs(True, mask, attn_mask))
    _assert_close(got, want)


@pytest.mark.parametrize("encdec", [False, True], ids=["self", "encdec"])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_through_the_derived_seed(force_pallas, monkeypatch,
                                          encdec, p):
    """The JAX module's dropout key, as its ``flash_attention`` receives
    it, gives the int32 seed the kernels hash (``_derive_dropout_seed``);
    the port's module at that ``dropout_seed`` drops the same
    probabilities."""
    seen = []
    orig = jmods.flash_attention

    def spy(*args, **kwargs):
        seen.append(kwargs["dropout_rng"])
        return orig(*args, **kwargs)

    monkeypatch.setattr(jmods, "flash_attention", spy)
    jm, params = _jax_module(encdec, dropout=p, include_norm_add=True)
    q, k, kpm, am, g = _inputs(encdec, "bool", None, seed=3)
    rngs = {"dropout": jax.random.PRNGKey(11)}
    args = (jnp.asarray(q), jnp.asarray(k)) if encdec else (jnp.asarray(q),)
    jm.apply(params, *args, jnp.asarray(kpm), deterministic=False, rngs=rngs)
    assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    seed = np.asarray(jax_attn._derive_dropout_seed(seen[-1], p))
    got, want = _run_both(
        encdec, dict(dropout=p, include_norm_add=True), (q, k, kpm, am, g),
        dict(deterministic=False),
        dict(deterministic=False, dropout_seed=torch.from_numpy(seed)),
        rngs=rngs)
    _assert_close(got, want, k_grad=encdec)
    other = _run_both(
        encdec, dict(dropout=p, include_norm_add=True), (q, k, kpm, am, g),
        dict(deterministic=False),
        dict(deterministic=False, dropout_seed=torch.from_numpy(seed + 1)),
        rngs=rngs)[0]
    assert np.abs(other[0] - want[0]).max() > 1e-2  # the seed matters
    # deterministic: the module's eval() drops nothing
    pm = _port_module(encdec, params, dropout=p, include_norm_add=True)
    pm.eval()
    pargs = (torch.from_numpy(q), torch.from_numpy(k)) if encdec else (
        torch.from_numpy(q),)
    out = pm(*pargs, torch.from_numpy(kpm))
    out_j = jm.apply(params, *args, jnp.asarray(kpm))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    pm.train()
    with pytest.raises(ValueError, match="requires a generator"):
        pm(*pargs, torch.from_numpy(kpm))


@pytest.mark.parametrize("encdec", [False, True], ids=["self", "encdec"])
def test_fully_masked_batch_element(encdec):
    """Batch element 1 masks every key: held to the JAX jnp path (its CPU
    route; the Pallas backward is wrong there, ROADMAP C1)."""
    q, k, kpm, am, g = _inputs(encdec, "bool", None, seed=6)
    kpm[1] = True
    got, want = _run_both(encdec, dict(bias=True), (q, k, kpm, am, g))
    assert jax_dispatch.last_paths()["flash_attention"] == "jnp"
    _assert_close(got, want, k_grad=encdec)


def test_merged_mask_keeps_one_row_block_a_batch_element():
    """(B, 1, 1, Sk) padding + (Sq, Sk) attn_mask -> (B, 1, Sq, Sk), which
    the kernels take as G = B, RS = Sq (never expanded to B·H)."""
    kpm = _padding(_lengths(B, SK), SK, False)
    am = _attn_mask(S, SK, "additive")
    bias = pmods._merge_attn_mask(
        pmods._padding_bias(torch.from_numpy(kpm), False),
        torch.from_numpy(am))
    bias_j = jmods._merge_attn_mask(
        jmods._padding_bias(jnp.asarray(kpm), False), jnp.asarray(am))
    assert tuple(bias.shape) == (B, 1, S, SK)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(bias_j))
    assert tuple(port_attn._format_bias(bias, B, H, S, SK).shape) == (
        B, S, SK)
    add = pmods._padding_bias(torch.from_numpy(_padding(
        _lengths(B, SK), SK, True)), True)
    assert add.dtype == torch.float32 and tuple(add.shape) == (B, 1, 1, SK)
    assert pmods._merge_attn_mask(None, None) is None


def test_params_round_trip_and_checks():
    for encdec in (False, True):
        _, params = _jax_module(encdec, bias=True, include_norm_add=True)
        pm = _port_module(encdec, params, bias=True, include_norm_add=True)
        back = to_jax_params(pm)
        for name, leaf in params["params"].items():
            if isinstance(leaf, dict):
                for k_, a in leaf.items():
                    np.testing.assert_array_equal(back[name][k_], a)
            else:
                np.testing.assert_array_equal(back[name], leaf)
    with pytest.raises(ValueError, match="divisible"):
        SelfMultiheadAttn(60, 8, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        SelfMultiheadAttn(64, 4, impl="cuda", device="cpu")
    assert SelfMultiheadAttn(64, 4, impl="default", device="cpu").impl == \
        "default"


FB, FS, FH, FD = 2, 40, 2, 16


def _fmha_inputs(seed=20):
    qkv = _x(FB, FS, 3, FH, FD, seed=seed)
    g = _x(FB, FS, FH, FD, seed=seed + 1)
    return qkv, g


def _valid_rows(a, lengths):
    return [a[b, :n] for b, n in enumerate(lengths)]


@pytest.mark.parametrize("causal", [False, True])
def test_fmha_matches_jax(causal):
    qkv, g = _fmha_inputs()
    lengths = _lengths(FB, FS, seed=21)
    gm = g.copy()
    for b, n in enumerate(lengths):
        gm[b, n:] = 0.0  # the rows past a sequence carry no cotangent
    out_j, vjp = jax.vjp(
        lambda a: jfmha.fmha(a, jnp.asarray(lengths), causal=causal),
        jnp.asarray(qkv))
    (dqkv_j,) = vjp(jnp.asarray(gm))
    qt = torch.from_numpy(qkv).requires_grad_(True)
    out = pfmha.fmha(qt, torch.from_numpy(lengths), causal=causal)
    out.backward(torch.from_numpy(gm))
    for a, b in zip(_valid_rows(out.detach().numpy(), lengths),
                    _valid_rows(np.asarray(out_j), lengths)):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(dqkv_j), **TOL)
    np.testing.assert_array_equal(
        pfmha.padding_bias_from_seqlens(torch.from_numpy(lengths), FS).numpy(),
        np.asarray(jfmha.padding_bias_from_seqlens(jnp.asarray(lengths), FS)))


def test_fmha_zero_length_matches_reference_autodiff():
    """A 0-length sequence masks every key of its rows: against
    ``jax.vjp`` of ``mha_reference`` on the same bias."""
    qkv, g = _fmha_inputs(seed=30)
    lengths = np.array([0, 17])
    bias = np.asarray(jfmha.padding_bias_from_seqlens(jnp.asarray(lengths),
                                                      FS))

    def ref(a):
        q, k, v = (jnp.swapaxes(a[:, :, i], 1, 2) for i in range(3))
        return jnp.swapaxes(jax_attn.mha_reference(q, k, v, jnp.asarray(bias)),
                            1, 2)

    out_j, vjp = jax.vjp(ref, jnp.asarray(qkv))
    (dqkv_j,) = vjp(jnp.asarray(g))
    qt = torch.from_numpy(qkv).requires_grad_(True)
    out = pfmha.fmha(qt, torch.from_numpy(lengths))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(dqkv_j), **TOL)
    assert pfmha.fmha_qkvpacked is port_attn.fmha_qkvpacked

"""apex_tpu_torch.amp's frontend (``initialize``, ``AmpHandle``,
``AmpState``, the free functions) and the amp piece of checkpoints vs
the JAX package.

- ``initialize`` at O0-O3 (bf16 and f16 halves), with overrides and a
  bad level: the resolved properties and the parameters' dtypes;
- the reference's L1 harness (``tests/test_amp.py`` ``_train_trajectory``):
  40 FusedAdam steps of a linear regression at every level and under
  static and dynamic loss scales, the port's losses and final f32
  weights against JAX's (``TRAJ_TOL_F32`` at O0, ``TRAJ_TOL_HALF`` at
  the half levels);
- an O2 step with an inf planted in one gradient: skipped, parameters,
  masters and optimizer state bit-identical, the scale backed off and
  the growth tracker reset, as the reference's; the next clean step
  applies;
- ``state_dict`` / ``load_state_dict`` round trips and
  ``master_params``;
- a tiny GPT (2 layers, hidden 64) under O1 through
  ``handle.patch_functions()``: with ``remat=True`` it equals itself
  without remat bit for bit (the backward, and so the recompute, runs
  outside the block), and it matches the JAX GPT under ``o1_patch``
  with the Pallas attention in interpret mode (``GPT_O1_LOSS_TOL``,
  ``GPT_O1_GRAD_TOL``);
- the checkpoint's ``amp`` piece: ``snapshot_training_state(...,
  amp_handle=, amp_state=)`` saved, restored into a template and
  unpacked by ``restore_training_state``; an O2 run of 2 + restore + 2
  steps equals 4 uninterrupted steps bit for bit (loss scale, growth
  tracker, hysteresis, masters, parameters, moments).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.amp import lists as jlists
from apex_tpu.models.gpt import GptConfig as JaxGptConfig
from apex_tpu.models.gpt import GptModel as JaxGptModel
from apex_tpu.models.gpt import gpt_lm_loss as jax_gpt_lm_loss
from apex_tpu.ops import _dispatch as jax_dispatch
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu_torch import amp
from apex_tpu_torch import checkpoint as port_ckpt
from apex_tpu_torch.models import (
    GptConfig,
    from_jax_params,
    gpt_lm_loss,
    to_jax_params,
)
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.train import module_loss, module_params

#: 40 steps of the toy regression against the reference's.  O0 is f32
#: end to end (read 2.1e-7 relative on the losses, 1.2e-7 on the
#: weights); the half levels run their products in bf16, which PyTorch's
#: and XLA's CPU kernels round apart now and then, and Adam carries each
#: such step on (read up to 3.5e-3 relative on the losses and 4.5e-3 on
#: the weights, about half a bf16 ulp at 1.0)
TRAJ_TOL_F32 = dict(rtol=1e-6, atol=1e-6)
TRAJ_TOL_HALF = dict(rtol=1e-2, atol=1e-2)
#: the O1 GPT against JAX's: the loss, and each gradient's max |diff|
#: over its max |value| (bf16 attention: the Pallas kernel rounds p to
#: bf16 before the PV product, the port's CPU twin multiplies in f32).
#: Read: 6.6e-5 and 5.5e-3 for the f32 GPT, 6.2e-5 and 1.5e-2 for the
#: bf16 GPT; without O1 the f32 GPTs agree to 9.5e-7 and 7.8e-7
GPT_O1_LOSS_TOL = 3e-4
GPT_O1_GRAD_TOL = 3e-2

DIMS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_seq_len=64)
SEQ, BATCH = 32, 2


def _dt(d):
    return str(d).replace("torch.", "") if d is not None else None


def toy_np():
    return {"w": np.random.RandomState(0).randn(8, 4).astype(np.float32),
            "b": np.zeros((4,), np.float32)}


def toy_params():
    return {k: torch.from_numpy(v.copy()) for k, v in toy_np().items()}


# ---------------------------------------------------------------------------
# initialize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
@pytest.mark.parametrize("over", [{}, {"loss_scale": "dynamic"},
                                  {"master_weights": True,
                                   "loss_scale": 128.0},
                                  {"keep_batchnorm_fp32": False}])
def test_initialize_equals_the_reference(level, half, over):
    tdt, jdt = getattr(torch, half), getattr(jnp, half)
    params, handle = amp.initialize(toy_params(), fused_adam(1e-3), level,
                                    half_dtype=tdt, **over)
    jparams, jhandle = jamp.initialize(
        {k: jnp.asarray(v) for k, v in toy_np().items()},
        jax_fused_adam(1e-3), level, half_dtype=jdt, **over)
    p, r = handle.properties, jhandle.properties
    assert p.opt_level == r.opt_level
    assert _dt(p.cast_model_type) == (None if r.cast_model_type is None
                                      else jnp.dtype(r.cast_model_type).name)
    assert _dt(p.compute_dtype) == jnp.dtype(r.compute_dtype).name
    assert (p.keep_batchnorm_fp32, p.master_weights, p.loss_scale) == (
        r.keep_batchnorm_fp32, r.master_weights, r.loss_scale)
    for k in params:
        assert _dt(params[k].dtype) == str(jparams[k].dtype)
    assert type(handle.scaler).__name__ == type(jhandle.scaler).__name__
    state = handle.init(params)
    assert (state.master_params is None) == (not p.master_weights)
    if level == "O1":
        with handle.patch_functions():
            assert amp.lists.active_policy().half_dtype == tdt
    else:
        with pytest.raises(RuntimeError, match="O1 mechanism"):
            handle.patch_functions()


def test_initialize_rejects_a_bad_level():
    with pytest.raises(ValueError, match="Unexpected optimization level"):
        amp.initialize(toy_params(), fused_adam(1e-3), opt_level="O4")


# ---------------------------------------------------------------------------
# the L1 harness: trajectories at every level against the reference's
# ---------------------------------------------------------------------------


def _data():
    x = np.random.RandomState(1).randn(16, 8).astype(np.float32)
    y = np.random.RandomState(2).randn(16, 4).astype(np.float32)
    return x, y


def _port_trajectory(opt_level, loss_scale=None, steps=40):
    params, handle = amp.initialize(toy_params(), fused_adam(5e-2),
                                    opt_level=opt_level,
                                    half_dtype=torch.bfloat16,
                                    loss_scale=loss_scale)
    state = handle.init(params)
    x, y = (torch.from_numpy(a) for a in _data())
    losses = []
    for _ in range(steps):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        cp = handle.policy.cast_to_compute(leaves)
        cx = handle.policy.cast_to_compute(x)
        pred = cx @ cp["w"] + cp["b"]
        loss = torch.mean((pred.float() - y) ** 2)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        scaled = {k: handle.scale_loss(g, state) for k, g in grads.items()}
        params, state, _ = handle.step(params, scaled, state)
        losses.append(float(loss.detach()))
    final = amp.master_params(params, state)
    return (np.asarray(losses),
            {k: v.float().numpy() for k, v in final.items()}, params, state)


def _jax_trajectory(opt_level, loss_scale=None, steps=40):
    params, handle = jamp.initialize(
        {k: jnp.asarray(v) for k, v in toy_np().items()}, jax_fused_adam(5e-2),
        opt_level=opt_level, half_dtype=jnp.bfloat16, loss_scale=loss_scale)
    state = handle.init(params)
    x, y = (jnp.asarray(a) for a in _data())

    def loss_fn(p):
        cp = handle.policy.cast_to_compute(p)
        cx = handle.policy.cast_to_compute(x)
        pred = cx @ cp["w"] + cp["b"]
        return jnp.mean((pred.astype(jnp.float32) - y) ** 2)

    losses = []
    for _ in range(steps):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        scaled = jax.tree_util.tree_map(
            lambda g: handle.scale_loss(g, state), grads)
        params, state, _ = handle.step(params, scaled, state)
        losses.append(float(loss))
    final = jamp.master_params(params, state)
    return np.asarray(losses), {k: np.asarray(v, np.float32)
                                for k, v in final.items()}


@pytest.mark.parametrize("level,loss_scale", [
    ("O0", None), ("O1", None), ("O2", None), ("O3", None),
    ("O2", 2.0 ** 10), ("O2", "dynamic"), ("O1", "dynamic")])
def test_trajectory_equals_the_reference(level, loss_scale):
    losses, final, params, state = _port_trajectory(level, loss_scale)
    ref_losses, ref_final = _jax_trajectory(level, loss_scale)
    tol = TRAJ_TOL_F32 if level == "O0" else TRAJ_TOL_HALF
    np.testing.assert_allclose(losses, ref_losses, **tol)
    for k in final:
        np.testing.assert_allclose(final[k], ref_final[k], **tol)
    assert losses[-1] < 0.5 * losses[0]
    if level in ("O2", "O3"):
        assert params["w"].dtype == torch.bfloat16
    if level == "O2":
        assert state.master_params["w"].dtype == torch.float32


def test_loss_scale_does_not_change_the_math():
    """≙ the reference's cross-run check: powers of two scale exactly, so
    O2 under static 2**10, static 2**4 and dynamic scaling agree."""
    base, base_w, _, _ = _port_trajectory("O2", 2.0 ** 10)
    for ls in (2.0 ** 4, "dynamic"):
        li, wi, _, _ = _port_trajectory("O2", ls)
        np.testing.assert_allclose(li, base, rtol=1e-5, atol=1e-7)
        for k in wi:
            np.testing.assert_allclose(wi[k], base_w[k], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# a skipped step, the state dict
# ---------------------------------------------------------------------------


def test_overflow_step_is_skipped_bit_for_bit():
    """O2, dynamic scale (2**16, hysteresis 1): an inf in one gradient
    leaves parameters, masters and moments bit-identical, halves the
    scale and resets the growth tracker, as the reference does; the
    next clean step applies."""
    params, handle = amp.initialize(toy_params(), fused_adam(1e-2), "O2",
                                    loss_scale="dynamic")
    jparams, jhandle = jamp.initialize(
        {k: jnp.asarray(v) for k, v in toy_np().items()}, jax_fused_adam(1e-2),
        "O2", loss_scale="dynamic")
    state, jstate = handle.init(params), jhandle.init(jparams)
    rs = np.random.RandomState(9)
    for step in range(3):
        g = {k: rs.randn(*v.shape).astype(np.float32) * 100.0
             for k, v in toy_np().items()}
        if step == 1:
            g["w"][2, 1] = np.inf
        before = (params, state)
        params, state, found = handle.step(
            params, {k: torch.from_numpy(v).to(torch.bfloat16)
                     for k, v in g.items()}, state)
        jparams, jstate, jfound = jhandle.step(
            jparams, {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()},
            jstate)
        assert float(found) == float(jfound) == float(step == 1)
        sc, jsc = state.scaler_state, jstate.scaler_state
        assert (float(sc.loss_scale), int(sc.growth_tracker),
                int(sc.hysteresis)) == (float(jsc.loss_scale),
                                        int(jsc.growth_tracker),
                                        int(jsc.hysteresis))
        if step == 1:
            bp, bs = before
            for k in params:
                assert torch.equal(params[k], bp[k])
                assert torch.equal(state.master_params[k],
                                   bs.master_params[k])
                assert torch.equal(state.opt_state.m[k], bs.opt_state.m[k])
                assert torch.equal(state.opt_state.v[k], bs.opt_state.v[k])
            assert int(state.opt_state.count) == int(bs.opt_state.count) == 1
            assert float(sc.loss_scale) == 2.0 ** 15
            assert int(sc.growth_tracker) == 0
        for k in params:
            np.testing.assert_allclose(
                state.master_params[k].numpy(),
                np.asarray(jstate.master_params[k]), rtol=1e-6, atol=1e-7)
    assert int(state.opt_state.count) == 2
    assert not torch.equal(params["w"], before[0]["w"])


def test_state_dict_round_trip_and_master_params():
    params, handle = amp.initialize(toy_params(), fused_adam(1e-3), "O2",
                                    half_dtype=torch.float16)
    state = handle.init(params)
    sd = handle.state_dict(state)
    assert float(sd["loss_scale"]) == 2.0 ** 16
    state2 = handle.load_state_dict(state, {"loss_scale": 42.0,
                                            "growth_tracker": 7,
                                            "hysteresis": 1})
    assert float(state2.scaler_state.loss_scale) == 42.0
    assert int(state2.scaler_state.growth_tracker) == 7
    assert state2.scaler_state.growth_tracker.dtype == torch.int32
    back = amp.load_state_dict(handle, state2, amp.state_dict(handle, state))
    assert float(back.scaler_state.loss_scale) == 2.0 ** 16
    assert amp.master_params(params, state)["w"].dtype == torch.float32
    p0, h0 = amp.initialize(toy_params(), fused_adam(1e-3), "O0")
    s0 = h0.init(p0)
    assert amp.master_params(p0, s0) is p0
    loss = torch.tensor(1.5)
    assert float(amp.scale_loss(loss, handle, state)) == 1.5 * 2.0 ** 16


# ---------------------------------------------------------------------------
# O1 on a tiny GPT: remat, and the JAX GPT under o1_patch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_gpt():
    jmodel = JaxGptModel(JaxGptConfig(**DIMS, dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((SEQ, BATCH), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    ids = np.random.RandomState(7).randint(
        0, DIMS["vocab_size"], size=(SEQ, BATCH)).astype(np.int32)
    return jmodel, params, ids


def _o1_grads(params, ids, remat, dtype):
    """The loss and gradients (as the JAX tree) of the port's GPT under
    O1 through the frontend, the backward outside the block."""
    model = from_jax_params(params, GptConfig(**DIMS, dtype=dtype,
                                              remat=remat), device="cpu")
    flat, handle = amp.initialize(module_params(model), fused_adam(1e-3),
                                  "O1", loss_scale="dynamic")
    state = handle.init(flat)
    loss_fn = module_loss(model, lambda m, b: gpt_lm_loss(m, b))
    leaves = {k: p.detach().requires_grad_() for k, p in flat.items()}
    with handle.patch_functions():
        loss = loss_fn(leaves, torch.from_numpy(ids))
        scaled = handle.scale_loss(loss, state)
    grads = torch.autograd.grad(scaled, list(leaves.values()))
    scale = float(state.scaler_state.loss_scale)
    named = {k.replace("/", "."): g / scale for k, g in zip(leaves, grads)}
    return loss.detach(), named, model


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_o1_gpt_remat_equals_no_remat(jax_gpt, dtype):
    _, params, ids = jax_gpt
    loss0, g0, _ = _o1_grads(params, ids, False, dtype)
    loss1, g1, _ = _o1_grads(params, ids, True, dtype)
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_o1_gpt_matches_jax(jax_gpt, dtype):
    jmodel, params, ids = jax_gpt
    jmodel = JaxGptModel(dataclasses.replace(jmodel.cfg,
                                             dtype=getattr(jnp, dtype)))
    jax_dispatch.set_use_pallas(True)
    try:
        with jlists.o1_patch(jnp.bfloat16):
            loss_j, grads_j = jax.value_and_grad(
                lambda p: jax_gpt_lm_loss(p, jmodel, jnp.asarray(ids)))(params)
        assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    finally:
        jax_dispatch.set_use_pallas(None)
    loss, named, model = _o1_grads(params, ids, True, getattr(torch, dtype))
    assert abs(float(loss) - float(loss_j)) < GPT_O1_LOSS_TOL
    port = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_params(model, named)))
    for path, ref in jax.tree_util.tree_leaves_with_path(grads_j):
        ref = np.asarray(ref, np.float32)
        err = np.abs(np.asarray(port[path]) - ref).max()
        assert err <= GPT_O1_GRAD_TOL * np.abs(ref).max(), (
            jax.tree_util.keystr(path), err)


# ---------------------------------------------------------------------------
# the amp piece of checkpoints
# ---------------------------------------------------------------------------


def _o2_run(steps, tmp=None, resume_at=None):
    """O2 with a dynamic scale (growth every 2 clean steps, so the scale
    moves) on the toy regression; with ``resume_at`` the state is
    snapshotted, saved, restored into a fresh template and unpacked
    there, then the run goes on."""
    tx = fused_adam(5e-2)
    params, handle = amp.initialize(toy_params(), tx, "O2",
                                    loss_scale="dynamic")
    handle.scaler.growth_interval = 2
    handle.scaler.init_scale = 2.0 ** 14
    state = handle.init(params)
    x, y = (torch.from_numpy(a) for a in _data())
    for step in range(steps):
        if step == resume_at:
            snap = port_ckpt.snapshot_training_state(
                params, state.opt_state, step=step, amp_handle=handle,
                amp_state=state, extra={"master": state.master_params})
            port_ckpt.save_checkpoint(str(tmp / "ck"), snap)
            # a fresh process's state: a new handle and init, restored
            params, handle = amp.initialize(toy_params(), tx, "O2",
                                            loss_scale="dynamic")
            handle.scaler.growth_interval = 2
            fresh = handle.init(params)
            template = port_ckpt.snapshot_training_state(
                params, fresh.opt_state, step=0, amp_handle=handle,
                amp_state=fresh, extra={"master": fresh.master_params})
            restored = port_ckpt.restore_checkpoint(str(tmp / "ck"),
                                                    template)
            params, opt, at, state, extra = port_ckpt.restore_training_state(
                restored, amp_handle=handle, amp_state=fresh)
            assert at == step
            state = state._replace(opt_state=opt,
                                   master_params=extra["master"])
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        pred = x.to(torch.bfloat16) @ leaves["w"] + leaves["b"]
        loss = torch.mean((pred.float() - y) ** 2)
        grads = torch.autograd.grad(handle.scale_loss(loss, state),
                                    list(leaves.values()))
        params, state, _ = handle.step(params, dict(zip(leaves, grads)),
                                       state)
    return params, state


def test_amp_state_through_a_checkpoint_resumes_bit_for_bit(tmp_path):
    full_p, full_s = _o2_run(4)
    res_p, res_s = _o2_run(4, tmp_path, resume_at=2)
    assert float(full_s.scaler_state.loss_scale) > 2.0 ** 14  # it grew
    for a, b in zip(full_s.scaler_state, res_s.scaler_state):
        assert torch.equal(a, b)
    for k in full_p:
        assert torch.equal(full_p[k], res_p[k])
        assert torch.equal(full_s.master_params[k], res_s.master_params[k])
        assert torch.equal(full_s.opt_state.m[k], res_s.opt_state.m[k])
        assert torch.equal(full_s.opt_state.v[k], res_s.opt_state.v[k])
    assert int(full_s.opt_state.count) == int(res_s.opt_state.count) == 4


def test_step_count_lives_on_the_device():
    """``init`` puts the optimizer's step count on the parameters' device
    as a 0-d int32 tensor, as every step leaves it (so a fresh state is a
    checkpoint template that restores it in place), and a count that a
    restore brought back on another device moves to the update's device
    (a count left on the host made the resumed update's arithmetic
    differ from the uninterrupted one's on the card)."""
    from apex_tpu_torch.amp.scaler import _as_device_count

    params, handle = amp.initialize(toy_params(), fused_adam(1e-3), "O2")
    count = handle.init(params).opt_state.count
    assert isinstance(count, torch.Tensor) and count.dtype == torch.int32
    assert count.shape == () and int(count) == 0
    st = fused_adam(1e-3).init(toy_params())._replace(
        count=torch.tensor(5, dtype=torch.int64))
    moved = _as_device_count(st, torch.device("meta"))
    assert moved.count.device.type == "meta"
    assert moved.count.dtype == torch.int32
    assert _as_device_count(st, torch.device("cpu")) is st


def test_snapshot_without_amp_has_no_amp_piece():
    snap = port_ckpt.snapshot_training_state(toy_params(), step=3)
    assert "amp" not in snap
    out = port_ckpt.restore_training_state(snap)
    assert out[2] == 3 and out[3] is None

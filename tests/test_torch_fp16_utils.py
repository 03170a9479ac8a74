"""apex_tpu_torch.fp16_utils and apex_tpu_torch._autocast_utils vs the
JAX package's, and the DCGAN example.

- ``tofp16`` / ``network_to_half`` / ``BN_convert_float`` over the
  reference's nested tree (the same dtypes leaf for leaf) and over the
  dotted names of ``named_parameters()`` (the anchored segment match:
  ``bn1`` and ``bn_1`` convert, ``subnet`` does not);
- ``prep_param_lists``, ``master_params_to_model_params``,
  ``model_grads_to_master_grads`` (dtypes, values, no aliasing);
- ``FP16_Optimizer``: 50 steps of the reference's regression with a
  dynamic scaler starting at 8, the losses and final masters against
  the JAX ``FP16_Optimizer`` (``TOL_HALF``: bf16 products), an overflow
  step skipped bit for bit, ``loss_scale`` and the state dict;
- ``cast_inputs`` / ``_cast_if_autocast_enabled`` against the
  reference's for a policy, a dtype and None, and under PyTorch's own
  CPU autocast;
- ``examples/dcgan/main_amp.py`` for 3 steps on the CPU at O1 and O2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import _autocast_utils as jac
from apex_tpu import amp as jamp
from apex_tpu import fp16_utils as jfp
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu_torch import _autocast_utils as pac
from apex_tpu_torch import amp
from apex_tpu_torch import fp16_utils as pfp
from apex_tpu_torch.examples.dcgan import main_amp as dcgan
from apex_tpu_torch.optimizers import fused_adam

#: bf16 products on both sides, rounded apart now and then by PyTorch's
#: and XLA's CPU kernels, carried on by Adam over 50 steps
TOL_HALF = dict(rtol=1e-2, atol=1e-2)


def _name(t):
    return str(t.dtype).replace("torch.", "")


def _tree_np():
    rs = np.random.RandomState(0)
    return {
        "conv": {"kernel": rs.randn(2, 2).astype(np.float32)},
        "bn_1": {"scale": rs.randn(2).astype(np.float32)},
        "BatchNorm_0": {"bias": rs.randn(2).astype(np.float32)},
        "subnet": {"kernel": rs.randn(2).astype(np.float32)},
        "SyncBatchNorm_2": {"scale": rs.randn(2).astype(np.float32),
                            "count": np.arange(2, dtype=np.int32)},
    }


def _torch_tree(tree):
    return {k: (_torch_tree(v) if isinstance(v, dict)
                else torch.from_numpy(v.copy())) for k, v in tree.items()}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_half_and_bn_convert_equal_the_reference(half):
    port = pfp.network_to_half(_torch_tree(_tree_np()), getattr(torch, half))
    ref = jfp.network_to_half(_jax_tree(_tree_np()), getattr(jnp, half))
    port_bn, ref_bn = pfp.BN_convert_float(port), jfp.BN_convert_float(ref)
    for p_tree, r_tree in ((port, ref), (port_bn, ref_bn)):
        for scope, leaves in r_tree.items():
            for k, r in leaves.items():
                p = p_tree[scope][k]
                assert _name(p) == str(r.dtype), (scope, k)
                np.testing.assert_array_equal(
                    p.float().numpy() if p.is_floating_point() else p.numpy(),
                    np.asarray(r, np.float32) if p.is_floating_point()
                    else np.asarray(r))
    assert port_bn["conv"]["kernel"].dtype == getattr(torch, half)
    assert port_bn["bn_1"]["scale"].dtype == torch.float32
    assert port_bn["subnet"]["kernel"].dtype == getattr(torch, half)
    assert pfp.tofp16(_torch_tree(_tree_np()))["conv"]["kernel"].dtype == (
        torch.bfloat16)


def test_bn_convert_over_named_parameters():
    """A module's dotted names: every segment is matched, anchored (the
    torch-style numbered ``bn1`` too), never a substring."""
    net = torch.nn.ModuleDict({
        "bn1": torch.nn.BatchNorm2d(4),
        "layer1": torch.nn.ModuleDict({"bn_2": torch.nn.BatchNorm2d(4),
                                       "conv": torch.nn.Conv2d(4, 4, 1)}),
        "subnet": torch.nn.Linear(4, 4),
        "abn": torch.nn.Linear(4, 4),
    })
    named = {k: p.detach() for k, p in net.named_parameters()}
    out = pfp.BN_convert_float(pfp.network_to_half(named))
    want_f32 = {"bn1.weight", "bn1.bias", "layer1.bn_2.weight",
                "layer1.bn_2.bias"}
    for k, t in out.items():
        assert t.dtype == (torch.float32 if k in want_f32
                           else torch.bfloat16), k


def test_param_list_helpers():
    rs = np.random.RandomState(1)
    model = {"w": torch.from_numpy(rs.randn(3, 2).astype(np.float32)).to(
        torch.bfloat16), "n": torch.arange(3)}
    same, master = pfp.prep_param_lists(model)
    assert same is model
    assert master["w"].dtype == torch.float32 and master["n"] is model["n"]
    master["w"] += 1.0  # the masters are copies
    assert not torch.equal(master["w"].to(torch.bfloat16), model["w"])
    back = pfp.master_params_to_model_params(model, master)
    assert back["w"].dtype == torch.bfloat16
    torch.testing.assert_close(back["w"], master["w"].to(torch.bfloat16))
    g32 = pfp.model_grads_to_master_grads({"w": torch.ones(3,
                                                           dtype=torch.bfloat16)})
    assert g32["w"].dtype == torch.float32
    ref = jfp.model_grads_to_master_grads({"w": jnp.ones(3, jnp.bfloat16)})
    assert str(ref["w"].dtype) == _name(g32["w"])


def _regression():
    x = np.random.RandomState(1).randn(16, 8).astype(np.float32)
    y = np.random.RandomState(2).randn(16, 4).astype(np.float32)
    p = {"w": np.random.RandomState(0).randn(8, 4).astype(np.float32),
         "b": np.zeros((4,), np.float32)}
    return x, y, p


def test_fp16_optimizer_equals_the_reference():
    x, y, p0 = _regression()
    opt = pfp.FP16_Optimizer(fused_adam(5e-2), dynamic_loss_scale=True,
                             dynamic_loss_args=dict(init_scale=8.0))
    jopt = jfp.FP16_Optimizer(jax_fused_adam(5e-2), dynamic_loss_scale=True,
                              dynamic_loss_args=dict(init_scale=8.0))
    params = pfp.network_to_half({k: torch.from_numpy(v.copy())
                                  for k, v in p0.items()})
    jparams = jfp.network_to_half({k: jnp.asarray(v) for k, v in p0.items()})
    state, jstate = opt.init(params), jopt.init(jparams)
    tx, ty = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(y)
    jx, jy = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y)

    def jloss(p):
        return jnp.mean(((jx @ p["w"] + p["b"]).astype(jnp.float32) - jy)
                        ** 2)

    losses, jlosses = [], []
    for step in range(50):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = torch.mean(((tx @ leaves["w"] + leaves["b"]).float() - ty)
                          ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        scaled = {k: opt.scale_loss(g, state) for k, g in zip(leaves, grads)}
        jl, jg = jax.value_and_grad(jloss)(jparams)
        jscaled = jax.tree_util.tree_map(lambda g: jopt.scale_loss(g, jstate),
                                         jg)
        if step == 20:  # a planted overflow: the step is skipped
            scaled["w"] = scaled["w"].clone()
            scaled["w"][0, 0] = float("inf")
            jscaled["w"] = jscaled["w"].at[0, 0].set(jnp.inf)
            before = (params, state)
        params, state, found = opt.step(params, scaled, state)
        jparams, jstate, jfound = jopt.step(jparams, jscaled, jstate)
        assert float(found) == float(jfound) == float(step == 20)
        if step == 20:
            for k in params:
                assert torch.equal(params[k], before[0][k])
                assert torch.equal(state["master"][k], before[1]["master"][k])
        losses.append(float(loss.detach()))
        jlosses.append(float(jl))
        assert float(opt.loss_scale(state)) == float(jopt.loss_scale(jstate))
    np.testing.assert_allclose(losses, jlosses, **TOL_HALF)
    for k in p0:
        np.testing.assert_allclose(state["master"][k].numpy(),
                                   np.asarray(jstate["master"][k]), **TOL_HALF)
    assert losses[-1] < 0.5 * losses[0]
    assert state["master"]["w"].dtype == torch.float32
    assert params["w"].dtype == torch.bfloat16
    assert opt.load_state_dict(None, opt.state_dict(state)) is state
    with pytest.raises(ValueError, match="static_loss_scale"):
        pfp.FP16_Optimizer(fused_adam(1e-3), static_loss_scale=None)


@pytest.mark.parametrize("how", ["policy", "dtype", "none"])
def test_cast_inputs_equal_the_reference(how):
    rs = np.random.RandomState(3)
    a = rs.randn(2, 3).astype(np.float32)
    b = rs.randint(0, 5, (3,)).astype(np.int32)
    port_args = (torch.from_numpy(a), {"k": torch.from_numpy(a)},
                 torch.from_numpy(b))
    ref_args = (jnp.asarray(a), {"k": jnp.asarray(a)}, jnp.asarray(b))
    pol = {"policy": (amp.Policy(compute_dtype=torch.bfloat16),
                      jamp.Policy(compute_dtype=jnp.bfloat16)),
           "dtype": (torch.float16, jnp.float16),
           "none": (None, None)}[how]
    port = pac._cast_if_autocast_enabled(*port_args, policy=pol[0])
    ref = jac._cast_if_autocast_enabled(*ref_args, policy=pol[1])
    flat_p = [port[0], port[1]["k"], port[2]]
    flat_r = [ref[0], ref[1]["k"], ref[2]]
    for p, r in zip(flat_p, flat_r):
        assert _name(p) == str(r.dtype)
    assert pac.cast_inputs(port_args, pol[0])[2] is port_args[2]


def test_cast_follows_torch_autocast_when_no_policy_is_given():
    x = torch.ones(2, 2)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        (y,) = pac._cast_if_autocast_enabled(x)
    assert y.dtype == torch.bfloat16
    (z,) = pac._cast_if_autocast_enabled(x)
    assert z is x


@pytest.mark.parametrize("argv", [
    [], ["--opt-level", "O2", "--loss-scale", "dynamic"]])
def test_dcgan_example_trains_three_steps_on_cpu(argv):
    losses = dcgan.main(["--device", "cpu", "--steps", "3", "--batch", "4",
                         *argv])
    assert set(losses) == {"d_real", "d_fake", "g"}
    for key, values in losses.items():
        assert len(values) == 3 and np.isfinite(values).all(), key
    # the discriminator starts at chance (ln 2 each) and moves
    assert abs(losses["d_real"][0] - np.log(2)) < 0.05
    assert losses["d_real"] != [losses["d_real"][0]] * 3

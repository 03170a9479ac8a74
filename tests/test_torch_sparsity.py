"""apex_tpu_torch's ASP (2:4 sparsity) against the JAX package.

- ``create_mask`` equals the reference's bit for bit at explicit axes
  (0, 1 and -1 of a 3-d weight), on tied magnitudes (all ones, bf16
  rounding ties: both keep the later indices of a tie) and on zeros;
  every group keeps exactly 2; the two refusals.
- ASP on a small ResNet (stage sizes (1, 1, 1, 1), width 16, carried
  across from the JAX model): the port's masks, read back in the JAX
  layout, equal the reference's ASP masks leaf by leaf, and the same
  leaves are pruned (where the reference's name rule reads the input
  axis right).
- ASP on a 2-layer GPT (ROADMAP C15): the port prunes every product
  along its input axis; the reference's ASP, reading its ``(in, out)``
  ``weight`` leaves as ``(out, in)``, prunes them along the output axis.
  The test shows both masks: the port's is the reference's
  ``create_mask`` along the input axis, and differs from the reference
  ASP's.  The tied embedding is pruned along H by both.
- The workflow: masked gradients and masks re-applied after each
  FusedAdam step keep every pruned weight exactly 2:4; an optimizer
  with state from dense steps breaks it when the masks are not
  re-applied after the step (the card check's planted fault).
- The permutation search against the reference's on three seeds (the
  same permutation; the kept magnitudes within 1e-5 relative: f64 sums
  here, f32 there), on a conv weight's axis 1, ``compute_permutations``
  over a tree, and ``apply_permutation``/``invert_permutation``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import sparsity as jsp
from apex_tpu_torch.contrib import sparsity as psp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=0):
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


def _groups_of_four(mask, axis):
    m = np.moveaxis(np.asarray(mask), axis, -1)
    return m.reshape(*m.shape[:-1], -1, 4).sum(axis=-1)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_create_mask_matches_the_reference(axis):
    w = _x((8, 12, 16))
    w[0, :4, :4] = 1.0  # ties
    w[1, :4, :4] = 0.0  # zeros
    got = psp.create_mask(torch.from_numpy(w), axis=axis)
    want = np.asarray(jsp.create_mask(jnp.asarray(w), axis=axis))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (_groups_of_four(got, axis) == 2).all()


def test_create_mask_ties_keep_the_later_indices():
    got = psp.create_mask(torch.ones(1, 8))
    np.testing.assert_array_equal(got.int().numpy(), [[0, 0, 1, 1] * 2])
    np.testing.assert_array_equal(
        np.asarray(jsp.create_mask(jnp.ones((1, 8)))).astype(int),
        [[0, 0, 1, 1] * 2])
    # bf16 weights tie often: the same masks on the same bf16 values
    w = torch.from_numpy(_x((16, 64)) * 0.01).bfloat16()
    want = jsp.create_mask(jnp.asarray(w.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(psp.create_mask(w).numpy(),
                                  np.asarray(want))


def test_create_mask_refusals():
    with pytest.raises(ValueError, match="pattern"):
        psp.create_mask(torch.ones(4, 8), pattern="m8n4")
    with pytest.raises(ValueError, match="divisible by 4"):
        psp.create_mask(torch.ones(4, 6))


# ---------------------------------------------------------------------------
# ASP on the reference's models
# ---------------------------------------------------------------------------


def test_asp_masks_on_resnet_equal_the_references():
    from apex_tpu.models.resnet import ResNet as JaxResNet
    from apex_tpu.models.resnet import ResNetConfig as JaxResNetConfig
    from apex_tpu_torch.models import resnet

    small = dict(stage_sizes=(1, 1, 1, 1), width=16, num_classes=32)
    jm = JaxResNet(JaxResNetConfig(**small, dtype=jnp.float32))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    model = resnet.from_jax_variables(
        v, resnet.resnet50_config(**small, dtype=torch.float32), device="cpu")
    masks = psp.ASP.compute_sparse_masks(dict(model.named_parameters()))
    ref = jsp.ASP.compute_sparse_masks(v["params"])
    pruned = 0
    for name, path, perm in resnet._param_paths(model):
        want = ref
        for k in path:
            want = want[k]
        want, got = np.asarray(want), masks[name]
        assert (got.ndim == 0) == (want.ndim == 0), name
        if got.ndim:
            got = got.numpy()
            got = np.transpose(got, perm) if got.ndim == 4 else got.T
            np.testing.assert_array_equal(got, want, err_msg=name)
            pruned += 1
    assert pruned == 17  # 12 block convs, 4 downsamples, fc
    assert masks["conv_stem.weight"].ndim == 0  # C_in 3


def test_asp_on_gpt_prunes_the_input_axis_where_the_reference_does_not():
    """ROADMAP C15: the reference's ASP keeps 2 of 4 along its GPT
    products' output axis; the port along their input axis."""
    from apex_tpu.models.gpt import GptConfig as JaxGptConfig
    from apex_tpu.models.gpt import GptModel as JaxGptModel
    from apex_tpu_torch.models import GptConfig, from_jax_params

    dims = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64)
    variables = JaxGptModel(JaxGptConfig(**dims, dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), jnp.zeros((8, 2), jnp.int32))
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, variables),
                            GptConfig(**dims, dtype=torch.float32),
                            device="cpu")
    params = variables["params"]
    masks = psp.ASP.compute_sparse_masks(dict(model.named_parameters()))
    ref = jsp.ASP.compute_sparse_masks(params)
    block, ref_block = params["layers"]["block"], ref["layers"]["block"]
    for prod in ("qkv", "out", "fc1", "fc2"):
        w = np.asarray(block[prod]["weight"])  # (L, in, out)
        for layer in range(2):
            got = masks[f"layers.{layer}.{prod}.weight"].numpy()  # (out, in)
            along_in = np.asarray(jsp.create_mask(jnp.asarray(w[layer]),
                                                  axis=0)).T
            along_out = np.asarray(ref_block[prod]["weight"])[layer].T
            np.testing.assert_array_equal(got, along_in)
            assert (_groups_of_four(got, 1) == 2).all()
            assert (_groups_of_four(along_out, 0) == 2).all()
            assert (got != along_out).any(), (prod, layer)
    # the tied embedding (V, H): along H in both packages
    np.testing.assert_array_equal(
        masks["word_embeddings.weight"].numpy(),
        np.asarray(ref["word_embeddings"]["weight"]))
    for name, m in masks.items():
        assert (m.ndim == 0) == (not name.endswith("weight")
                                 or "ln" in name), name


def _masked_gpt_steps(model, masks, opt, steps, reapply=True):
    from apex_tpu_torch.models.gpt import gpt_lm_loss

    params = dict(model.named_parameters())
    ids = torch.from_numpy(np.random.RandomState(5).randint(
        0, 64, (16, 2)).astype(np.int64))
    losses = []
    for _ in range(steps):
        loss = gpt_lm_loss(model, ids)
        loss.backward()
        psp.ASP.apply_masks_({n: p.grad for n, p in params.items()}, masks)
        opt.step()
        opt.zero_grad(set_to_none=True)
        if reapply:
            psp.ASP.apply_masks_(params, masks)
        losses.append(loss.item())
    return losses


def _violations(model, masks):
    return sum(int((_groups_of_four(p.detach() != 0, 1) > 2).sum())
               for n, p in model.named_parameters() if masks[n].ndim)


def test_asp_workflow_keeps_the_weights_two_of_four():
    from apex_tpu_torch.models import GptConfig, GptModel
    from apex_tpu_torch.optimizers import FusedAdam

    cfg = GptConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                    intermediate_size=64, dtype=torch.float32)
    model = GptModel(cfg, device="cpu")
    opt = FusedAdam(model.parameters(), lr=1e-2)
    _masked_gpt_steps(model, {n: torch.ones((), dtype=torch.bool)
                              for n, _ in model.named_parameters()}, opt, 2)
    params = dict(model.named_parameters())
    pruned, masks = psp.ASP.prune_trained_model(params)
    assert all(not pruned[n].requires_grad for n, m in masks.items()
               if m.ndim)
    assert masks["layers.0.qkv.bias"].ndim == 0
    assert torch.equal(pruned["layers.0.qkv.bias"], params["layers.0.qkv.bias"])
    psp.ASP.apply_masks_(params, masks)
    assert _violations(model, masks) == 0
    losses = _masked_gpt_steps(model, masks, opt, 3)
    assert np.isfinite(losses).all()
    assert _violations(model, masks) == 0
    for n, p in params.items():
        if masks[n].ndim:
            assert (_groups_of_four(p.detach() != 0, 1) == 2).all(), n
    # the functional form gives the same weights
    again = psp.ASP.apply_masks(params, masks)
    for n, p in params.items():
        assert torch.equal(again[n], p), n
    # the planted fault: Adam's moments from the dense steps move the
    # pruned weights when the masks are not re-applied after the step
    _masked_gpt_steps(model, masks, opt, 1, reapply=False)
    assert _violations(model, masks) > 0


# ---------------------------------------------------------------------------
# the permutation search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_permutation_search_matches_the_reference(seed):
    w = _x((24, 48), seed)
    perm, before, after = psp.search_channel_permutation(torch.from_numpy(w))
    rperm, rbefore, rafter = jsp.search_channel_permutation(w, axis=-1)
    np.testing.assert_array_equal(perm.numpy(), rperm)
    np.testing.assert_allclose(before, rbefore, rtol=1e-5)
    np.testing.assert_allclose(after, rafter, rtol=1e-5)
    assert after > before
    np.testing.assert_allclose(
        after, psp.permutation_retained_magnitude(w, perm), rtol=1e-12)
    wp = psp.apply_permutation(torch.from_numpy(w), perm, axis=1)
    kept = (wp * psp.create_mask(wp)).abs().sum()
    np.testing.assert_allclose(float(kept), after, rtol=1e-5)
    back = psp.apply_permutation(wp, psp.invert_permutation(perm), axis=1)
    assert torch.equal(back, torch.from_numpy(w))


def test_permutation_search_on_a_conv_and_a_tree():
    w = _x((16, 24, 3, 3), seed=3)
    perm, _, after = psp.search_channel_permutation(torch.from_numpy(w),
                                                    axis=1, max_swaps=5)
    rperm, _, rafter = jsp.search_channel_permutation(w, axis=1, max_swaps=5)
    np.testing.assert_array_equal(perm.numpy(), rperm)
    np.testing.assert_allclose(after, rafter, rtol=1e-5)
    tree = {"fc.weight": torch.from_numpy(_x((20, 32), seed=4)),
            "fc.bias": torch.ones(20)}
    perms = psp.ASP.compute_permutations(tree)
    assert perms["fc.bias"] is None
    entry = perms["fc.weight"]
    assert entry["axis"] == 1 and entry["after"] >= entry["before"]
    assert sorted(entry["perm"].tolist()) == list(range(32))

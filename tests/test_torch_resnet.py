"""apex_tpu_torch's ResNet and the ImageNet amp example vs the JAX package.

On the same seeded inputs and the JAX model's variables carried across
(``from_jax_variables``), at stage sizes (1, 1, 1, 1), width 8, 32 x 32
images and 10 classes, f32:

- the logits in training and in evaluation, the updated running
  statistics and the parameter gradients of the f32 log-softmax loss,
  in both norm branches (flax's ``BatchNorm`` and ``SyncBatchNorm``),
  within ``TOL`` (cuDNN-free CPU convolutions summing in another order);
- flax's "SAME" padding of the strided 3 x 3 convolution: ``same_pads``
  equals ``jax.lax.padtype_to_pads``, and the symmetric padding planted
  in its place moves the logits past ``TRAP`` (> 100 x ``TOL``);
- the forward's FLOP count against the convolutions the model ran;
- ``main_amp.main(--device cpu)`` at O0 for 2 steps against the
  reference example's losses (the reference run on one JAX device, its
  per-step losses read from its jitted step), both examples on the
  small model above in place of ResNet-50 (the reference's ``resnet50``
  patched, the port's passed in), ``EXAMPLE_TOL``;
- ``--sync-bn`` at world 2 (two gloo processes, each half the batch)
  against one process with the whole batch: the losses and the
  SyncBatchNorm running statistics, ``EXAMPLE_TOL``.
"""

import functools
import importlib.util
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from apex_tpu import parallel_state as jps
from apex_tpu.models.resnet import ResNet as JaxResNet
from apex_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from apex_tpu_torch.examples.imagenet import main_amp
from apex_tpu_torch.models import resnet

TOL = dict(atol=1e-4, rtol=1e-4)
TRAP = 1e-2
EXAMPLE_TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = dict(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
EXAMPLE_ARGS = ["--device", "cpu", "--opt-level", "O0", "--batch-size", "4",
                "--image-size", "32", "--num-classes", "10", "--steps", "2"]

port_state_guard = pytest.fixture(autouse=True)(workers.port_state_guard)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(use_syncbn, seed=1):
    """The JAX model's variables with the norms' parameters and running
    statistics moved off their initial values (numpy)."""
    model = JaxResNet(JaxResNetConfig(**SMALL, dtype=jnp.float32,
                                      use_syncbn=use_syncbn))
    v = _init(model)
    rs = np.random.RandomState(seed)
    v = jax.tree.map(
        lambda a: np.asarray(a + (0.1 * rs.randn(*a.shape) if a.ndim == 1
                                  else 0.0), np.float32), v)
    return model, v


def _init(model):
    return jax.jit(functools.partial(model.init, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)))


def _eval(model, v, x):
    return np.asarray(jax.jit(functools.partial(model.apply, train=False))(
        v, jnp.asarray(x)))


def _batch(seed=2, n=4):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 32, 32, 3).astype(np.float32),
            rs.randint(0, 10, (n,)))


def _jax_loss(model, v, x, y):
    def f(params):
        logits, upd = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        loss = -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                             axis=-1))
        return loss, (logits, upd["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(v["params"])
    return float(loss), np.asarray(logits), stats, grads


def _port_model(v, use_syncbn):
    cfg = resnet.resnet50_config(**SMALL, dtype=torch.float32,
                                 use_syncbn=use_syncbn)
    return resnet.from_jax_variables(v, cfg, device="cpu")


def _assert_tree_close(got, want, tol, relative=False):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_g) == len(flat_w)
    for path, a in flat_g:
        b = np.asarray(flat_w[path])
        scale = max(float(np.abs(b).max()), 1e-6) if relative else 1.0
        np.testing.assert_allclose(np.asarray(a) / scale, b / scale, **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("use_syncbn", [False, True], ids=["bn", "syncbn"])
def test_forward_stats_and_gradients_match_jax(use_syncbn):
    jmodel, v = _variables(use_syncbn)
    x, y = _batch()
    loss_j, logits_j, stats_j, grads_j = _jax_loss(jmodel, v, x, y)
    model = _port_model(v, use_syncbn)
    logits, stats = model(torch.from_numpy(x))
    loss = main_amp.xent(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), logits_j, **TOL)
    np.testing.assert_allclose(float(loss.detach()), loss_j, **TOL)
    # the buffers are untouched until the statistics are committed
    out = resnet.to_jax_variables(model)
    _assert_tree_close(out["batch_stats"], v["batch_stats"],
                       dict(atol=0, rtol=0))
    _assert_tree_close(resnet.to_jax_variables(model, stats=stats)[
        "batch_stats"], stats_j, TOL)
    grads = resnet.to_jax_variables(
        model, {n: p.grad for n, p in model.named_parameters()})["params"]
    _assert_tree_close(grads, grads_j, TOL, relative=True)
    model.load_batch_stats(stats)
    _assert_tree_close(resnet.to_jax_variables(model)["batch_stats"],
                       stats_j, TOL)
    # evaluation normalizes with the running statistics
    ev = _port_model(v, use_syncbn)(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(ev.detach().numpy(), _eval(jmodel, v, x),
                               **TOL)


def test_variables_round_trip():
    _, v = _variables(False)
    model = _port_model(v, False)
    _assert_tree_close(resnet.to_jax_variables(model), v,
                       dict(atol=0, rtol=0))
    assert model.bn_stem.path == "bn_stem"
    assert "stage3_block0/downsample_bn" in model.batch_stats()


@pytest.mark.parametrize("n", [2, 7, 8, 32, 33, 56])
@pytest.mark.parametrize("k,s", [(3, 2), (3, 1), (1, 2), (7, 2)])
def test_same_pads_is_xla_same(n, k, s):
    want = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
    assert resnet.same_pads(n, k, s) == tuple(want)


def test_symmetric_padding_is_caught(monkeypatch):
    """The strided conv2 padded (1, 1) as ``nn.Conv2d(padding=1)`` would:
    the same shapes, logits off by more than ``TRAP``."""
    jmodel, v = _variables(False)
    x, _ = _batch()
    want = _eval(jmodel, v, x)
    sound = _port_model(v, False)(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(sound.detach().numpy(), want, **TOL)
    monkeypatch.setattr(resnet, "same_pads", lambda n, k, s: (k // 2, k // 2))
    bad = _port_model(v, False)(torch.from_numpy(x), train=False)
    assert bad.shape == sound.shape
    assert np.abs(bad.detach().numpy() - want).max() > TRAP


def test_bn3_scale_starts_at_zero():
    model = resnet.ResNet(resnet.resnet50_config(**SMALL), device="cpu")
    for name, p in model.named_parameters():
        if name.endswith("bn3.weight"):
            assert not p.any()
        elif name.endswith(("bn1.weight", "bn_stem.weight")):
            assert (p == 1).all()
    again = resnet.ResNet(resnet.resnet50_config(**SMALL), device="cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_forward_flops_counts_the_convolutions():
    cfg = resnet.resnet50_config(**SMALL, dtype=torch.float32)
    model = resnet.ResNet(cfg, device="cpu")
    counted = []

    def hook(mod, inp, out):
        o, i, kh, kw = mod.weight.shape
        counted.append(2 * out.shape[2] * out.shape[3] * o * i * kh * kw)

    for mod in model.modules():
        if isinstance(mod, resnet.Conv):
            mod.register_forward_hook(hook)
    model(torch.zeros(1, 32, 32, 3), train=False)
    fc = 2 * model.fc.in_features * model.fc.out_features
    assert resnet.forward_flops(cfg, 32) == sum(counted) + fc
    # ResNet-50 at 224: 4.09 G multiply-adds
    assert resnet.forward_flops(resnet.resnet50_config(), 224) == 8178368512


def _reference_example():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "imagenet", "main_amp.py")
    spec = importlib.util.spec_from_file_location("ref_imagenet_main_amp",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _JaxSpy:
    """The reference module's ``jax`` with ``jit`` wrapped so that each
    call of the jitted step records its loss (the 4th output)."""

    def __init__(self, losses):
        self._losses = losses

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, *args, **kwargs):
        step = jax.jit(fn, *args, **kwargs)

        def run(*a):
            out = step(*a)
            self._losses.append(float(out[3]))
            return out

        return run


def _example_variables(sync_bn=False):
    model = _small_resnet50(num_classes=10, use_syncbn=sync_bn,
                            dtype=jnp.float32)
    return jax.tree.map(np.asarray, _init(model))


def _small_resnet50(**overrides):
    """The reference example's ``resnet50`` cut to ``SMALL``'s stages and
    width (its classes, norm and dtype from the example's flags)."""
    kw = {k: v for k, v in SMALL.items() if k != "num_classes"}
    return JaxResNet(JaxResNetConfig(**kw, **overrides))


def _small_port(v, sync_bn=False):
    kw = {k: val for k, val in SMALL.items() if k != "num_classes"}
    cfg = resnet.resnet50_config(**kw, num_classes=10, use_syncbn=sync_bn,
                                 dtype=torch.float32)
    return resnet.from_jax_variables(v, cfg, device="cpu")


@pytest.fixture(scope="module")
def reference_losses():
    mod = _reference_example()
    losses = []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(mod, "jax", _JaxSpy(losses))
        mp.setattr(mod, "resnet50", _small_resnet50)
        mp.setattr(jps, "initialize_model_parallel", functools.partial(
            jps.initialize_model_parallel, devices=jax.devices()[:1]))
        mp.setattr(sys, "argv", ["main_amp.py"] + EXAMPLE_ARGS[2:])
        mod.main()
    finally:
        mp.undo()
        jps.destroy_model_parallel()
    return losses


def test_example_matches_reference_example(reference_losses):
    assert len(reference_losses) == 2
    out = main_amp.main(EXAMPLE_ARGS, model=_small_port(_example_variables()))
    np.testing.assert_allclose(out["losses"], reference_losses,
                               **EXAMPLE_TOL)
    assert out["loss_scales"] == [1.0, 1.0]
    assert all(np.isfinite(out["losses"]))
    with pytest.raises(ValueError, match="does not match"):
        main_amp.main(EXAMPLE_ARGS + ["--sync-bn"],
                      model=_small_port(_example_variables()))


def test_example_world2_syncbn_matches_one_process(tmp_path):
    """dp = 2 with ``--sync-bn``: each rank's half of the batch, the
    statistics over both, the dp-mean loss and averaged gradients give
    one process's run at the whole batch."""
    v = _example_variables(sync_bn=True)
    path = tmp_path / "variables.pkl"
    with open(path, "wb") as f:
        pickle.dump(v, f)
    argv = EXAMPLE_ARGS + ["--sync-bn", "--backend", "gloo"]
    small = {k: val for k, val in SMALL.items() if k != "num_classes"}
    ranks = workers.spawn(2, [("run", "imagenet_case", dict(
        argv=argv, variables_path=str(path), model_kwargs=small))], tmp_path)
    one = workers.imagenet_case(EXAMPLE_ARGS + ["--sync-bn"], str(path),
                                small)
    for r in ranks:
        np.testing.assert_allclose(r["run"]["losses"], one["losses"],
                                   **EXAMPLE_TOL)
        _assert_tree_close(r["run"]["batch_stats"], one["batch_stats"],
                           EXAMPLE_TOL)
    # the stats moved: a step's batch statistics, not the initial ones
    init = v["batch_stats"]["bn_stem"]["SyncBatchNorm_0"]["var"]
    assert not np.allclose(one["batch_stats"]["bn_stem"]["SyncBatchNorm_0"][
        "var"], init)

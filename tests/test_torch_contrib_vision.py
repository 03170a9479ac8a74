"""apex_tpu_torch's NHWC vision blocks against the JAX package.

The same seeded numpy inputs go through the reference's function or
flax module and the port's, the module weights carried across by the
port's loaders (HWIO kernels to OIHW); the outputs and the input and
parameter gradients (``jax.vjp`` against ``torch.autograd``, one seeded
cotangent) must agree within ``TOL`` in f32:

- ``conv_bias_relu``: ``ConvBias``, ``ConvBiasReLU`` and
  ``ConvBiasMaskReLU`` at stride 1 and 2, with the OIHW weight (a
  channels-last one too), and the cast both packages' O1 policy gives
  ``conv_bias`` (half);
- ``group_norm`` with every ``act`` (None, "", "silu", "swish"), without
  the affine, the ``GroupNorm`` module, the f32 statistics of a bf16
  input and O1's f32 cast, and its two errors;
- ``groupbn``'s ``BatchNorm2d_NHWC`` with the residual ``z`` and
  ``fuse_relu``, its running statistics after two training calls, an
  evaluation call, the ``use_running_average`` rule and the two
  ``bn_group`` errors; ``cudnn_gbn``'s alias;
- ``Bottleneck`` at stride 1 and stride 2 (with ``downsample``) in
  training (outputs, every parameter's gradient, running statistics) and
  in evaluation, and ``SpatialBottleneck``'s stride rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from apex_tpu.contrib import bottleneck as jbn
from apex_tpu.contrib import conv_bias_relu as jcbr
from apex_tpu.contrib import group_norm as jgn
from apex_tpu.contrib import groupbn as jgbn
from apex_tpu_torch.contrib import bottleneck as pbn
from apex_tpu_torch.contrib import conv_bias_relu as pcbr
from apex_tpu_torch.contrib import cudnn_gbn as pcgbn
from apex_tpu_torch.contrib import group_norm as pgn
from apex_tpu_torch.contrib import groupbn as pgbn

#: f32 on the CPU: XLA's and PyTorch's convolutions and reductions sum in
#: other orders
TOL = dict(atol=2e-5, rtol=2e-5)

port_state_guard = pytest.fixture(autouse=True)(workers.port_state_guard)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=0, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _oihw(hwio):
    return np.ascontiguousarray(np.asarray(hwio).transpose(3, 2, 0, 1))


def _jax_vjp(fn, args, g):
    y, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(y), [np.asarray(d) for d in vjp(jnp.asarray(g))]


def _port_grads(fn, args, g):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = fn(*ts)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), [t.grad.numpy() for t in ts]


# ---------------------------------------------------------------------------
# conv_bias_relu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("op", ["ConvBias", "ConvBiasReLU",
                                "ConvBiasMaskReLU"])
def test_conv_bias_ops_match_jax(op, stride):
    x = _x((2, 9, 8, 6))
    w = _x((3, 3, 6, 5), seed=1, scale=0.2)
    b = _x((5,), seed=2, scale=0.1)
    ho = (9 + 2 - 3) // stride + 1
    wo = (8 + 2 - 3) // stride + 1
    mask = (np.random.RandomState(3).rand(2, ho, wo, 5) > 0.4)
    g = _x((2, ho, wo, 5), seed=4)
    extra = (mask,) if op == "ConvBiasMaskReLU" else ()
    want, (dx, dw, db) = _jax_vjp(
        lambda x, w, b: getattr(jcbr, op)(x, w, b, *extra, stride=stride),
        (x, w, b), g)
    textra = tuple(torch.from_numpy(m) for m in extra)
    got, (gx, gw, gb) = _port_grads(
        lambda x, w, b: getattr(pcbr, op)(x, w, b, *textra, stride=stride),
        (x, _oihw(w), b), g)
    _close(got, want)
    _close(gx, dx)
    _close(gw, _oihw(dw))
    _close(gb, db)


def test_conv_bias_takes_a_channels_last_weight_and_pads_unevenly():
    x = torch.from_numpy(_x((1, 7, 7, 4)))
    w = torch.from_numpy(_x((8, 4, 3, 3), seed=1))
    b = torch.zeros(8)
    cl = w.contiguous(memory_format=torch.channels_last)
    y = pcbr.conv_bias(x, cl, b)
    assert y.shape == (1, 7, 7, 8)
    _close(y, pcbr.conv_bias(x, w, b))
    # ((top, bottom), (left, right)) uneven: the input is padded first
    jy = jcbr.conv_bias(jnp.asarray(x.numpy()),
                        jnp.asarray(w.numpy().transpose(2, 3, 1, 0)),
                        jnp.zeros(8), padding=((0, 1), (1, 2)))
    _close(pcbr.conv_bias(x, w, b, padding=((0, 1), (1, 2))), jy)


def test_conv_bias_casts_as_the_reference_under_o1():
    from apex_tpu.amp.lists import o1_patch as jax_o1
    from apex_tpu_torch.amp.lists import o1_patch

    x, w, b = _x((1, 6, 6, 4)), _x((3, 3, 4, 8), seed=1), _x((8,), seed=2)
    with jax_o1():
        jy = jcbr.conv_bias(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    with o1_patch():
        y = pcbr.conv_bias(torch.from_numpy(x), torch.from_numpy(_oihw(w)),
                           torch.from_numpy(b))
    assert jy.dtype == jnp.bfloat16 and y.dtype == torch.bfloat16
    _close(y.float(), np.asarray(jy, np.float32),
           dict(atol=3e-2, rtol=3e-2))


# ---------------------------------------------------------------------------
# group_norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("act", [None, "", "silu", "swish"])
def test_group_norm_matches_jax(act, affine):
    x = _x((2, 5, 4, 12), scale=2.0) + 0.5
    w = _x((12,), seed=1) if affine else None
    b = _x((12,), seed=2) if affine else None
    g = _x(x.shape, seed=3)
    args = (x, w, b) if affine else (x,)

    def jfn(x, w=None, b=None):
        return jgn.group_norm(x, 3, w, b, 1e-5, act)

    def pfn(x, w=None, b=None):
        return pgn.group_norm(x, 3, w, b, 1e-5, act)

    want, dref = _jax_vjp(jfn, args, g)
    got, dport = _port_grads(pfn, args, g)
    _close(got, want)
    for a, r in zip(dport, dref):
        _close(a, r)


def test_group_norm_module_through_its_loader():
    x = _x((2, 4, 4, 8))
    jm = jgn.GroupNorm(num_groups=2, num_channels=8, act="silu")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda v: v + jnp.asarray(_x(v.shape, seed=5, scale=0.3)), params)
    pm = pgn.from_jax_params(pgn.GroupNorm(2, 8, act="silu", device="cpu"),
                             _np_tree(params))
    _close(pm(torch.from_numpy(x)).detach(), jm.apply(params, jnp.asarray(x)))
    with pytest.raises(ValueError, match="channels-last"):
        pm(torch.zeros(1, 8, 4, 4))


def test_group_norm_keeps_f32_statistics_and_casts_as_the_reference():
    from apex_tpu.amp.lists import o1_patch as jax_o1
    from apex_tpu_torch.amp.lists import o1_patch

    x = _x((2, 4, 4, 8), scale=30.0) + 100.0
    xb = torch.from_numpy(x).bfloat16()
    y = pgn.group_norm(xb, 4)
    assert y.dtype == torch.bfloat16
    jy = jgn.group_norm(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                        4)
    _close(y.float(), np.asarray(jy, np.float32), dict(atol=1e-2, rtol=1e-2))
    # O1: group_norm is an fp32 op in both packages
    with jax_o1():
        jo = jgn.group_norm(jnp.asarray(x).astype(jnp.bfloat16), 4)
    with o1_patch():
        po = pgn.group_norm(xb, 4)
    assert jo.dtype == jnp.float32 and po.dtype == torch.float32


def test_group_norm_errors():
    with pytest.raises(ValueError, match="divisible"):
        pgn.group_norm(torch.ones(1, 4, 4, 10), num_groups=4)
    with pytest.raises(ValueError, match="act must be one of"):
        pgn.group_norm(torch.ones(1, 4, 4, 8), 4, act="gelu")
    with pytest.raises(ValueError, match="act must be one of"):
        jgn.group_norm(jnp.ones((1, 4, 4, 8)), 4, act="gelu")


# ---------------------------------------------------------------------------
# groupbn / cudnn_gbn
# ---------------------------------------------------------------------------


def _bn_pair(fuse_relu, **kw):
    jm = jgbn.BatchNorm2d_NHWC(6, fuse_relu=fuse_relu, **kw)
    x = _x((3, 4, 5, 6), scale=1.5) + 0.7
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                use_running_average=False)
    v = {"params": jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(_x(a.shape, seed=7, scale=0.4)),
        v["params"]),
         "batch_stats": {"mean": jnp.asarray(_x((6,), seed=8)),
                         "var": jnp.asarray(np.abs(_x((6,), seed=9)) + 0.5)}}
    pm = pgbn.from_jax_variables(
        pgbn.BatchNorm2d_NHWC(6, fuse_relu=fuse_relu, device="cpu", **kw),
        _np_tree(v))
    return jm, v, pm


@pytest.mark.parametrize("with_z", [False, True])
@pytest.mark.parametrize("fuse_relu", [False, True])
def test_batchnorm_nhwc_matches_jax(fuse_relu, with_z):
    jm, v, pm = _bn_pair(fuse_relu)
    xs = [_x((3, 4, 5, 6), seed=s, scale=1.5) + 0.7 for s in (10, 11)]
    z = _x((3, 4, 5, 6), seed=12) if with_z else None
    g = _x((3, 4, 5, 6), seed=13)
    for x in xs:  # two training calls: the running statistics move twice
        def jfn(x, p, z=None):
            y, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                              x, z, use_running_average=False,
                              mutable=["batch_stats"])
            return y, upd

        args = [jnp.asarray(x), v["params"]] + (
            [jnp.asarray(z)] if with_z else [])
        y_ref, vjp, upd = jax.vjp(jfn, *args, has_aux=True)
        grads = vjp(jnp.asarray(g))
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}

        xt = torch.from_numpy(x).requires_grad_(True)
        zt = torch.from_numpy(z).requires_grad_(True) if with_z else None
        y = pm(xt, zt, use_running_average=False)
        y.backward(torch.from_numpy(g))
        _close(y.detach(), y_ref)
        _close(xt.grad, grads[0])
        _close(pm.weight.grad, grads[1]["weight"])
        _close(pm.bias.grad, grads[1]["bias"])
        if with_z:
            _close(zt.grad, grads[2])
        _close(pm.running_mean, v["batch_stats"]["mean"])
        _close(pm.running_var, v["batch_stats"]["var"])
        pm.zero_grad()
    # evaluation normalizes with the running statistics
    x = xs[0]
    want = jm.apply(v, jnp.asarray(x), use_running_average=True)
    _close(pm(torch.from_numpy(x), use_running_average=True).detach(), want)


def test_batchnorm_nhwc_use_running_average_rule():
    _, _, pm = _bn_pair(False)
    x = torch.zeros(1, 2, 2, 6)
    with pytest.raises(ValueError, match="use_running_average"):
        pm(x)  # neither the attribute nor the argument
    fixed = pgbn.BatchNorm2d_NHWC(6, use_running_average=True, device="cpu")
    with pytest.raises(ValueError, match="use_running_average"):
        fixed(x, use_running_average=False)  # both
    _close(fixed(x).detach(), np.zeros((1, 2, 2, 6)), dict(atol=0, rtol=0))
    with pytest.raises(ValueError, match="channels-last"):
        pm(torch.zeros(1, 6, 2, 2), use_running_average=False)


def test_bn_group_errors_are_the_references():
    from apex_tpu_torch import parallel_state as ps

    x = torch.ones(2, 2, 2, 4)
    bn = pgbn.BatchNorm2d_NHWC(4, bn_group=2, device="cpu")
    with pytest.raises(RuntimeError, match="bound"):
        bn(x, use_running_average=False)
    jm = jgbn.BatchNorm2d_NHWC(4, bn_group=2)
    with pytest.raises(RuntimeError, match="bound"):
        jm.init(jax.random.PRNGKey(0), jnp.ones((2, 2, 2, 4)),
                use_running_average=False)
    ps.initialize_model_parallel()  # a bound dp axis of size 1
    with pytest.raises(ValueError, match="must equal"):
        bn(x, use_running_average=False)


def test_cudnn_gbn_is_groupbn():
    assert pcgbn.GroupBatchNorm2d is pgbn.BatchNorm2d_NHWC
    assert pcgbn.BatchNorm2d_NHWC is pgbn.BatchNorm2d_NHWC


# ---------------------------------------------------------------------------
# bottleneck
# ---------------------------------------------------------------------------


def _bottleneck_variables(jm, x, seed=20):
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    leaves, tree = jax.tree_util.tree_flatten(v)
    rs = np.random.RandomState(seed)
    out = []
    for leaf, (path, _) in zip(
            leaves, jax.tree_util.tree_flatten_with_path(v)[0]):
        key = jax.tree_util.keystr(path)
        if "var" in key:
            out.append(jnp.asarray(rs.rand(*leaf.shape) + 0.5, jnp.float32))
        elif "kernel" in key:
            out.append(leaf)
        else:
            out.append(leaf + jnp.asarray(rs.randn(*leaf.shape) * 0.3,
                                          jnp.float32))
    return jax.tree_util.tree_unflatten(tree, out)


def _port_param_grad(name, grads):
    """The JAX gradient of the port parameter ``name``, in its layout."""
    *mods, leaf = name.split(".")
    tree = grads
    for m in mods:
        tree = tree[m]
    if leaf == "weight" and mods[-1] == "conv":
        return _oihw(tree["kernel"])
    return np.asarray(tree[leaf])


@pytest.mark.parametrize("cin,cb,cout,stride", [(8, 4, 8, 1),
                                                (8, 4, 12, 2)])
def test_bottleneck_matches_jax(cin, cb, cout, stride):
    x = _x((2, 8, 8, cin))
    jm = jbn.Bottleneck(cin, cb, cout, stride=stride, dtype=jnp.float32)
    v = _bottleneck_variables(jm, x)
    pm = pbn.from_jax_variables(
        pbn.Bottleneck(cin, cb, cout, stride, device="cpu"), _np_tree(v))
    assert (pm.downsample is None) == (stride == 1 and cin == cout)
    assert pm.conv2.conv.weight.is_contiguous(
        memory_format=torch.channels_last)
    ho = 8 // stride
    g = _x((2, ho, ho, cout), seed=3)

    def jfn(p, x):
        return jm.apply({"params": p, "batch_stats": v["batch_stats"]}, x,
                        train=True, mutable=["batch_stats"])

    want, vjp, upd = jax.vjp(jfn, v["params"], jnp.asarray(x), has_aux=True)
    dparams, dx = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = pm(xt, train=True)
    y.backward(torch.from_numpy(g))
    _close(y.detach(), want)
    _close(xt.grad, dx)
    names = [n for n, _ in pm.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(dparams))
    for name, p in pm.named_parameters():
        _close(p.grad, _port_param_grad(name, dparams))
    for name, mod in pm.named_modules():
        if isinstance(mod, pgbn.BatchNorm2d_NHWC):
            stats = upd["batch_stats"][name.split(".")[0]]["bn"]
            _close(mod.running_mean, stats["mean"])
            _close(mod.running_var, stats["var"])
    # evaluation: the running statistics after the step, both sides
    v2 = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    _close(pm(xt.detach(), train=False).detach(),
           jm.apply(v2, jnp.asarray(x), train=False))


def test_spatial_bottleneck_refuses_a_stride():
    with pytest.raises(ValueError, match="stride"):
        pbn.SpatialBottleneck(8, 4, 8, stride=2, device="cpu")
    with pytest.raises(ValueError, match="stride"):
        jbn.SpatialBottleneck(8, 4, 8, stride=2).init(
            jax.random.PRNGKey(0), jnp.ones((1, 8, 8, 8)), train=False)
    assert pbn.SpatialBottleneck(8, 4, 8, device="cpu").spatial_axis_name \
        == "dp"

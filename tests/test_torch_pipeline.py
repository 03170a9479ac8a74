"""apex_tpu_torch's pipeline parallelism vs the JAX package.

The port runs in spawned gloo processes (one spawn per world, pp = 2
and 4; ``torch_dist_workers.p2p_case`` and ``pipeline_case``), the JAX
package under ``shard_map`` over a pp mesh of the same size, on the same
seeded inputs (stages ``tanh(x @ w + b)`` with D = 8, microbatches of
4, NM = 4; the loss the mean squared error, or through each stage's
``head`` leaf with ``loss_takes_params=True``):

- the shifts of ``p2p_communication`` (cyclic and not, both
  directions): the received values and the input gradients against
  ``jax.vjp`` of ``ppermute``, and the call log's ``collective-permute``;
- each of the five schedules with ``loss_takes_params`` both ways,
  ``forward_only``, both stash modes, remat and its "dots" policy, vpp
  2 where it applies: the per-microbatch losses and every rank's
  gradients against the JAX schedule of the same name;
- the microbatch calculators and ``utils`` against the JAX package's
  (values and error messages), ``get_forward_backward_func``'s
  resolution, and the ported ``train_gpt_pp`` at pp 2 on the CPU, whose
  loss falls.

Tolerance: ``RTOL`` 1e-4 and ``ATOL`` 1e-5 (f32 on the CPU, the
reference's own pipeline-test tolerance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import apex_tpu.transformer.microbatches as jmb
import apex_tpu.transformer.pipeline_parallel as jpl
import apex_tpu.transformer.pipeline_parallel.utils as jutils
import apex_tpu_torch.transformer.microbatches as tmb
import apex_tpu_torch.transformer.pipeline_parallel as tpl
import apex_tpu_torch.transformer.pipeline_parallel.utils as tutils
import torch_dist_workers as workers
from apex_tpu import parallel_state as jps

D, MB, NM = 8, 4, 4
RTOL, ATOL = 1e-4, 1e-5
WORLDS = (2, 4)

#: name -> (schedule, kwargs); ``vpp`` and ``head`` are read by both sides
CASES = {
    "without": ("forward_backward_pipelining_without_interleaving", {}),
    "without_noremat": ("forward_backward_pipelining_without_interleaving",
                        dict(remat=False)),
    "without_head": ("forward_backward_pipelining_without_interleaving",
                     dict(head=True)),
    "without_fwd": ("forward_backward_pipelining_without_interleaving",
                    dict(forward_only=True)),
    "without_carry": ("forward_backward_pipelining_without_interleaving",
                      dict(carry_chunk=3)),
    "1f1b": ("forward_backward_pipelining_1f1b", {}),
    "1f1b_input": ("forward_backward_pipelining_1f1b", dict(stash="input")),
    "1f1b_head": ("forward_backward_pipelining_1f1b", dict(head=True)),
    "1f1b_fwd": ("forward_backward_pipelining_1f1b",
                 dict(forward_only=True, head=True)),
    "1f1b_dots": ("forward_backward_pipelining_1f1b",
                  dict(remat=True, remat_policy="dots")),
    "with_il": ("forward_backward_pipelining_with_interleaving",
                dict(vpp=2)),
    "with_il_head": ("forward_backward_pipelining_with_interleaving",
                     dict(vpp=2, head=True)),
    "with_il_fwd": ("forward_backward_pipelining_with_interleaving",
                    dict(vpp=2, forward_only=True)),
    "il_1f1b": ("forward_backward_pipelining_interleaved_1f1b",
                dict(vpp=2)),
    "il_1f1b_input": ("forward_backward_pipelining_interleaved_1f1b",
                      dict(vpp=2, stash="input")),
    "il_1f1b_head": ("forward_backward_pipelining_interleaved_1f1b",
                     dict(vpp=2, head=True, stash="input")),
    "il_1f1b_fwd": ("forward_backward_pipelining_interleaved_1f1b",
                    dict(vpp=2, forward_only=True)),
}


def _stacked(n):
    rs = np.random.RandomState(n)
    return {"w": (rs.randn(n, D, D) * 0.5).astype(np.float32),
            "b": (rs.randn(n, D) * 0.1).astype(np.float32),
            "head": (rs.randn(n, D, D) * 0.5).astype(np.float32)}


def _batch():
    rs = np.random.RandomState(1)
    return (rs.randn(NM, MB, D).astype(np.float32),
            rs.randn(NM, MB, D).astype(np.float32))


def _port_cases():
    out = []
    for name, (schedule, kw) in CASES.items():
        kw = dict(kw)
        if "vpp" in kw:
            kw["num_model_chunks"] = kw["vpp"]
        out.append((name, schedule, kw))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_runs")
    inputs, targets = _batch()
    out = {}
    for world in WORLDS:
        cases = [("p2p", "p2p_case", dict(
                     x=np.arange(6, dtype=np.float32).reshape(2, 3))),
                 ("sched", "pipeline_case", dict(
                     stacked=_stacked(2 * world), inputs=inputs,
                     targets=targets, cases=_port_cases()))]
        if world == 2:
            cases.append(("example", "example_case", dict(
                module="train_gpt_pp",
                argv=["--pp", "2", "--steps", "4", "--device", "cpu",
                      "--backend", "gloo"])))
            cases.append(("example_vpp", "example_case", dict(
                module="train_gpt_pp",
                argv=["--pp", "2", "--vpp", "2", "--hand-1f1b", "--steps",
                      "4", "--device", "cpu", "--backend", "gloo"])))
        out[world] = workers.spawn(world, cases, tmp, timeout=180.0)
    return out


def _mesh(pp):
    jps.destroy_model_parallel()
    return jps.initialize_model_parallel(1, pp, devices=jax.devices()[:pp])


def _j_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _j_loss(y, t):
    return jnp.mean((y - t) ** 2)


def _j_loss_head(p, y, t):
    return jnp.mean((y @ p["head"] - t) ** 2)


@functools.lru_cache(maxsize=None)
def _jax_schedule(name, world):
    """JAX's ``(losses, grads)`` of case ``name`` at pp = ``world``,
    the grads stacked by virtual stage (n, ...)."""
    schedule, kw = CASES[name]
    kw = dict(kw)
    vpp = kw.pop("vpp", None)
    head = kw.pop("head", False)
    forward_only = kw.get("forward_only", False)
    stacked = {k: jnp.asarray(v) for k, v in _stacked(2 * world).items()}
    if not head:
        stacked.pop("head")
    inputs, targets = (jnp.asarray(a) for a in _batch())
    mesh = _mesh(world)
    fn = getattr(jpl, schedule)
    if vpp:
        kw["num_model_chunks"] = vpp
        stacked = {k: v[: world * vpp].reshape(vpp, world, *v.shape[1:])
                   for k, v in stacked.items()}
        spec, take, put = P(None, "pp"), (lambda v: v[:, 0]), (
            lambda v: v[:, None])
    else:
        stacked = {k: v[:world] for k, v in stacked.items()}
        spec, take, put = P("pp"), (lambda v: v[0]), (lambda v: v[None])

    def run(local, inputs, targets):
        params = jax.tree.map(take, local)
        losses, grads = fn(_j_stage, _j_loss_head if head else _j_loss,
                           params, (inputs, targets), num_microbatches=NM,
                           loss_takes_params=head, **kw)
        if grads is None:
            grads = jax.tree.map(jnp.zeros_like, params)
        return losses, jax.tree.map(put, grads)

    try:
        losses, grads = jax.jit(jax.shard_map(
            run, mesh=mesh, in_specs=(spec, P(), P()),
            out_specs=(P(), spec), check_vma=False,
        ))(stacked, inputs, targets)
    finally:
        jps.destroy_model_parallel()
    grads = {k: np.asarray(v) for k, v in grads.items()}
    if vpp:
        grads = {k: v.reshape(world * vpp, *v.shape[2:])
                 for k, v in grads.items()}
    return np.asarray(losses), (None if forward_only else grads)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_matches_jax(world, name, runs):
    """Every rank's losses (shared over pp) and its stages' gradients
    equal JAX's schedule under shard_map."""
    want_losses, want_grads = _jax_schedule(name, world)
    vpp = CASES[name][1].get("vpp")
    for r in range(world):
        losses, grads = runs[world][r]["sched"][name]
        np.testing.assert_allclose(losses, want_losses, rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} rank {r}")
        if want_grads is None:
            assert grads is None
            continue
        assert set(grads) == set(want_grads)
        for k, g in grads.items():
            stages = ([c * world + r for c in range(vpp)] if vpp else [r])
            want = np.stack([want_grads[k][v] for v in stages])
            got = g if vpp else g[None]
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} {k} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("cyclic", [False, True])
@pytest.mark.parametrize("name", ["send_forward_recv_forward",
                                  "send_backward_recv_backward"])
def test_p2p_shift_matches_ppermute(world, name, cyclic, runs):
    """The shift and its backward (the inverse shift) against
    ``ppermute`` and its transpose under shard_map."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    mesh = _mesh(world)

    def f(xs):
        rank = jax.lax.axis_index("pp").astype(jnp.float32)
        inp = xs * (rank + 1)
        y, vjp = jax.vjp(
            lambda t: getattr(jpl.p2p_communication, name)(
                t, cyclic=cyclic), inp)
        (g,) = vjp(y * 3 + rank)
        return y[None], g[None]

    try:
        y, g = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P(),), out_specs=(P("pp"), P("pp")),
            check_vma=False))(jnp.asarray(x))
    finally:
        jps.destroy_model_parallel()
    for r in range(world):
        got_y, got_g = runs[world][r]["p2p"][(name, cyclic)]
        np.testing.assert_array_equal(got_y, np.asarray(y)[r])
        np.testing.assert_array_equal(got_g, np.asarray(g)[r])


def test_p2p_shift_is_logged(runs):
    """The shift is a ``collective-permute`` over pp with the bytes
    sent (the last rank sends nothing forward)."""
    for r in range(2):
        log = runs[2][r]["p2p"]["log"]
        assert [(e["kind"], e["axis"]) for e in log] == [
            ("collective-permute", "pp")]
        assert log[0]["bytes"] == (24 if r == 0 else 0)


@pytest.mark.parametrize("extra", ["example", "example_vpp"])
def test_train_gpt_pp_loss_falls(extra, runs):
    """The ported example at pp 2 on the CPU: the pp ranks report the
    same losses, and the loss falls."""
    a, b = (runs[2][r][extra] for r in range(2))
    assert a == b and len(a) == 4
    assert a[-1] < a[0] - 0.5, a


@pytest.mark.parametrize("forward_only", [False, True])
@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_no_pipelining_matches_jax(forward_only, head, remat):
    stacked = _stacked(1)
    inputs, targets = _batch()
    if not head:
        stacked.pop("head")
    jp = {k: jnp.asarray(v[0]) for k, v in stacked.items()}
    want_l, want_g = jpl.forward_backward_no_pipelining(
        _j_stage, _j_loss_head if head else _j_loss, jp,
        (jnp.asarray(inputs), jnp.asarray(targets)), num_microbatches=NM,
        forward_only=forward_only, remat=remat, loss_takes_params=head)
    tp_ = {k: torch.from_numpy(v[0].copy()) for k, v in stacked.items()}
    got_l, got_g = tpl.forward_backward_no_pipelining(
        workers._pp_stage, workers._pp_loss_head if head else
        workers._pp_loss, tp_, (torch.from_numpy(inputs),
                                torch.from_numpy(targets)),
        num_microbatches=NM, forward_only=forward_only, remat=remat,
        loss_takes_params=head)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               rtol=RTOL, atol=ATOL)
    if forward_only:
        assert got_g is None and want_g is None
        return
    for k in tp_:
        np.testing.assert_allclose(got_g[k].numpy(), np.asarray(want_g[k]),
                                   rtol=RTOL, atol=ATOL)


def test_schedule_refusals_match_jax():
    """The argument checks of both packages, message for message."""
    for pkg in (jpl, tpl):
        with pytest.raises(ValueError, match="unknown stash mode 'x'"):
            pkg.forward_backward_pipelining_1f1b(
                None, None, {}, (None, None), num_microbatches=2, stash="x")
        with pytest.raises(ValueError, match="num_model_chunks"):
            pkg.forward_backward_pipelining_interleaved_1f1b(
                None, None, {}, (None, None), num_microbatches=2,
                num_model_chunks=0)
    with pytest.raises(TypeError, match="carry_chunk"):
        tpl.forward_backward_pipelining_without_interleaving(
            None, None, {}, (None, None), num_microbatches=2,
            carry_chunk=1.5)


def _resolution(fn):
    if isinstance(fn, functools.partial):
        return fn.func.__name__, fn.keywords
    return fn.__name__, None


@pytest.mark.parametrize("hand", [False, True])
@pytest.mark.parametrize("vpp", [None, 2])
@pytest.mark.parametrize("pp", [None, 1, 2])
def test_get_forward_backward_func_matches_jax(pp, vpp, hand):
    jps.destroy_model_parallel()
    want = _resolution(jpl.get_forward_backward_func(vpp, pp, hand))
    got = _resolution(tpl.get_forward_backward_func(vpp, pp, hand))
    assert got == want


# ---------------------------------------------------------------------------
# microbatch calculators and utils
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


CALCULATORS = {
    "constant": lambda m: m.ConstantNumMicroBatches(64, 4, 2),
    "constant_bad": lambda m: m.ConstantNumMicroBatches(60, 4, 4),
    "rampup": lambda m: m.RampupBatchsizeNumMicroBatches(16, 8, 100, 64, 4,
                                                         2),
    "rampup_bad_incr": lambda m: m.RampupBatchsizeNumMicroBatches(
        16, 0, 100, 64, 4, 2),
    "rampup_bad_diff": lambda m: m.RampupBatchsizeNumMicroBatches(
        16, 7, 100, 64, 4, 2),
    "build_none": lambda m: m.build_num_microbatches_calculator(
        0, None, 32, 2, 4),
    "build_rampup": lambda m: m.build_num_microbatches_calculator(
        0, [8, 8, 50], 32, 2, 4),
    "build_bad": lambda m: m.build_num_microbatches_calculator(
        0, [8, 8], 32, 2, 4),
}


def _trace(calc):
    rows = [(calc.get(), calc.get_current_global_batch_size())]
    for consumed in (0, 10, 30, 60, 90, 101, 200):
        r = _outcome(lambda: calc.update(consumed, True))
        rows.append((r[0], calc.get(), calc.get_current_global_batch_size()))
    return rows


@pytest.mark.parametrize("name", sorted(CALCULATORS))
def test_microbatch_calculator_matches_jax(name):
    got = _outcome(lambda: CALCULATORS[name](tmb))
    want = _outcome(lambda: CALCULATORS[name](jmb))
    assert got[0] == want[0] and (got[0] == "ok" or got[1] == want[1])
    if got[0] == "ok":
        assert _trace(got[1]) == _trace(want[1])


def test_utils_match_jax():
    for mod in (jutils, tutils):
        mod.destroy_microbatch_calculator()
    try:
        for mod in (jutils, tutils):
            with pytest.raises(RuntimeError, match="not initialized"):
                mod.get_num_microbatches()
            mod.setup_microbatch_calculator(0, [4, 4, 40], 16, 2, 2)
            with pytest.raises(RuntimeError, match="already initialized"):
                mod.setup_microbatch_calculator(0, None, 16, 2, 2)
        seq = []
        for mod in (jutils, tutils):
            row = [(mod.get_num_microbatches(),
                    mod.get_current_global_batch_size())]
            for consumed in (5, 20, 50):
                mod.update_num_microbatches(consumed)
                row.append((mod.get_num_microbatches(),
                            mod.get_current_global_batch_size()))
            mod._reconfigure_microbatch_calculator(0, None, 32, 4, 2)
            row.append(mod.get_num_microbatches())
            seq.append(row)
        assert seq[0] == seq[1]
    finally:
        for mod in (jutils, tutils):
            mod.destroy_microbatch_calculator()
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    batch = {"x": x, "y": x[:, 0]}
    want = jutils.split_batch_into_microbatches(
        {k: jnp.asarray(v) for k, v in batch.items()}, 3)
    got = tutils.split_batch_into_microbatches(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 3)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(
            tutils.get_kth_microbatch(got, 1)[k].numpy(),
            np.asarray(jutils.get_kth_microbatch(want, 1)[k]))
    with pytest.raises(ValueError, match="not divisible by num_microbatches"):
        tutils.split_batch_into_microbatches(torch.zeros(5, 2), 2)
    assert tutils.listify_model("m") == jutils.listify_model("m") == ["m"]
    assert tutils.listify_model(["a"]) == ["a"]


# ---------------------------------------------------------------------------
# the example's stage tree carried across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunks", [None, 2])
def test_pipeline_stage_converts_from_jax(chunks):
    """A JAX stage tree (``core`` = ``BertEncoderCore.init``, ``embed``,
    ``is_chunk0``; stacked on a chunk axis under interleaving) becomes
    the port's stage params and back bit for bit, and the port's core
    bound to it computes the JAX core's output (within 2e-5 of its
    largest |value|)."""
    from apex_tpu.models.bert import BertConfig as JCfg
    from apex_tpu.models.bert import BertEncoderCore as JCore
    from apex_tpu_torch.models import convert
    from apex_tpu_torch.models.bert import BertConfig, BertEncoderCore
    from apex_tpu_torch.train.trainer import module_loss

    dims = dict(vocab_size=32, hidden_size=16, num_layers=4, num_heads=4,
                intermediate_size=32, max_position_embeddings=8)
    jcore = JCore(JCfg(**dims, dtype=jnp.float32), num_layers=2)
    x = np.random.RandomState(5).randn(8, 2, 16).astype(np.float32)
    rs = np.random.RandomState(6)

    def one(c):
        core = jcore.init(jax.random.PRNGKey(c), jnp.asarray(x))
        core = jax.tree.map(lambda a: np.asarray(a) + np.float32(
            0.05) * rs.randn(*a.shape).astype(np.float32), core)
        return {"core": core,
                "embed": rs.randn(32, 16).astype(np.float32),
                "is_chunk0": np.float32(c == 0)}

    trees = [one(c) for c in range(chunks or 1)]
    tree = trees[0] if chunks is None else jax.tree.map(
        lambda *a: np.stack(a), *trees)
    port = convert.pipeline_stage_from_jax(tree, 2, num_chunks=chunks,
                                           device="cpu")
    back = convert.pipeline_stage_to_jax(port, 2, num_chunks=chunks)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    core = BertEncoderCore(BertConfig(**dims, dtype=torch.float32), 2, "cpu")
    run = module_loss(core, lambda m, h: m(h))
    for c, t in enumerate(trees):
        want = np.asarray(jcore.apply(jax.tree.map(jnp.asarray, t["core"]),
                                      jnp.asarray(x)))
        p = port["core"] if chunks is None else {
            k: v[c] for k, v in port["core"].items()}
        got = run(p, torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   atol=2e-5 * np.abs(want).max())

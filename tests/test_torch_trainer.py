"""apex_tpu_torch.train (the composable trainer) vs apex_tpu.train.

The decisions, specs and plans are host arithmetic: the port's must
equal the reference's exactly (``TrainConfig``'s refusals and messages,
``decide_update_sharding``'s decision and printed reason, rule
resolution, ``exact_entry_rules``, ``local_shape``, ``slice_local``,
``plan_wire_bytes``, ``optimizers.by_name``).

The builds run in spawned gloo processes (``torch_dist_workers.
trainer_case``; world 2 for (dp, tp) = (2, 1) and (1, 2), world 4 for
(2, 2)) on the reference's ``demo_params`` and ``demo_batch`` carried
across as numpy, in both update modes, against the JAX
``build_demo(..., verify="off")`` under ``shard_map`` on the conftest's
CPU devices: three steps' losses and the final params within
``TOL``.  Each build runs with ``verify="error"``: its call log must
equal the declared plan (the math of the reference's ``TestLiveBuilds``
tests, which fail under jax 0.9.0 in ``analysis.check``), and a planted
bogus plan must fail the build.  Also: ``track_grad_norm`` in ZeRO mode
(and its refusal at tp > 1), the metric fold, ``optimizer_kwargs``
surviving a mode flip, ``fit`` at world 2 preempted and resumed bit for
bit, a collective checkpoint with a rank failing mid-save, the BERT
example's ``--ckpt-dir``/``--resume`` at world 2, and ``module_loss``
over a tiny GPT against the hand-written loop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_dist_workers as workers
from apex_tpu import optimizers as jopt
from apex_tpu import parallel_state as jps
from apex_tpu import train as jtrain
from apex_tpu.analysis import sharding as jash
from apex_tpu.train import demo as jdemo
from apex_tpu.train import sharding as jtsh
from apex_tpu_torch import optimizers as popt
from apex_tpu_torch import train as ptrain
from apex_tpu_torch.analysis import sharding as pash
from apex_tpu_torch.analysis.sharding import P
from apex_tpu_torch.train import sharding as ptsh

#: losses of the demo against the reference: f32 on the CPU, the same
#: arithmetic in other summation orders over three Adam steps
TOL = dict(rtol=2e-5, atol=2e-6)
#: its params: Adam's normalised update (m / sqrt(v), ~±1 a step at lr
#: 1e-2) turns f32 rounding in a near-zero gradient into up to 3e-3 of
#: the learning rate (2 of 65536 elements read that much); the limit is
#: 5e-3 of it
PARAM_TOL = dict(rtol=2e-5, atol=5e-5)
#: the int8 wire: the same codec on both sides, but a value within f32
#: rounding of a code's tie may land one code apart, and Adam's
#: normalised update then moves that element by up to a step.  The
#: losses take rtol 1e-3; of the params (gathered on the int8 wire, so
#: on its grid) 99.9% must lie within one code of a block (max |param| /
#: 127: a block of the flat buffer spans leaves) and every one within the
#: STEPS * lr Adam can move it (4 of 65536 elements of w1 read 0.5 lr)
INT8_TOL = dict(rtol=1e-3, atol=1e-4)
INT8_WITHIN_ONE_CODE = 0.999
STEPS = 3
MESHES = ((2, 1), (1, 2), (2, 2))


@pytest.fixture(autouse=True)
def _reset_port_parallel_state():
    """A build in this process initializes the port's parallel_state
    (``Trainer.mesh``): leave none behind for the next test."""
    from apex_tpu_torch import parallel_state

    yield
    parallel_state.destroy_model_parallel()


# ---------------------------------------------------------------------------
# host arithmetic: config, heuristic, rule tables
# ---------------------------------------------------------------------------


def _both(**kw):
    """(port TrainConfig, JAX TrainConfig) or (port error, JAX error)."""
    out = []
    for mod, spec in ((ptrain, P), (jtrain, JP)):
        k = dict(kw)
        k.setdefault("rules", [(r".*", spec())])
        try:
            out.append(mod.TrainConfig(**k))
        except Exception as e:  # noqa: BLE001 — compared below
            out.append(e)
    return out


@pytest.mark.parametrize("kw", [
    dict(mesh={"dp": 2, "pp": 2}),
    dict(mesh={"ep": 2}),
    dict(mesh={"dp": 0}),
    dict(mesh={"dp": 2}, wire="fp8"),
    dict(mesh={"dp": 2}, param_wire="fp8"),
    dict(mesh={"dp": 2}, update_sharding="sometimes"),
    dict(mesh={"dp": 2}, verify="loud"),
    dict(mesh={"dp": 2}, optimizer=object()),
])
def test_config_refusals_equal_the_reference(kw):
    port, ref = _both(**kw)
    assert isinstance(ref, Exception)
    assert type(port) is type(ref)
    assert str(port) == str(ref)


def test_config_fields_and_constants():
    assert ptrain.UPDATE_SHARDING_MODES == jtrain.UPDATE_SHARDING_MODES
    assert ptrain.VERIFY_LEVELS == jtrain.VERIFY_LEVELS
    port, ref = _both(mesh={"dp": 2, "tp": 2})
    skip = {"devices", "device", "rules"}
    for f in dataclasses.fields(ref):
        if f.name not in skip:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.mesh_dict() == ref.mesh_dict()
    assert port.device == "cuda"


def _decisions(params_np, **kw):
    cfgs = _both(mesh=kw.pop("mesh", {"dp": 2}), **kw)
    ptree = {k: torch.zeros(v) for k, v in params_np.items()}
    jtree = {k: jnp.zeros(v) for k, v in params_np.items()}
    out = []
    for f, cfg, tree in ((ptrain.decide_update_sharding, cfgs[0], ptree),
                         (jtrain.decide_update_sharding, cfgs[1], jtree)):
        try:
            out.append(f(tree, cfg))
        except Exception as e:  # noqa: BLE001 — compared below
            out.append(e)
    return out


class _Custom:
    def init(self, p):
        return ()

    def update(self, g, s, p):
        return g, s


@pytest.mark.parametrize("case", [
    ("small tree", {"w": (1024,)}, {}),
    ("large tree", {"w": (2 << 20,)}, {}),
    ("large, many leaves", {f"w{i}": (70000,) for i in range(40)}, {}),
    ("int8 wire", {"w": (2 << 20,)}, dict(wire="int8")),
    ("dp1", {"w": (2 << 20,)}, dict(mesh={"dp": 1})),
    ("override shard", {"w": (1024,)}, dict(update_sharding="shard")),
    ("override replicate", {"w": (2 << 20,)},
     dict(update_sharding="replicate")),
    ("custom optimizer", {"w": (2 << 20,)}, dict(optimizer=_Custom())),
    ("shard on dp1", {"w": (1024,)},
     dict(mesh={"dp": 1}, update_sharding="shard")),
    ("shard, custom", {"w": (1024,)},
     dict(update_sharding="shard", optimizer=_Custom())),
    ("lamb, tp 2", {"w": (4096, 1024)}, dict(mesh={"dp": 2, "tp": 2},
                                            optimizer="lamb")),
], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_update_sharding_decision_equals_the_reference(case):
    _, shapes, kw = case
    port, ref = _decisions(shapes, **kw)
    if isinstance(ref, Exception):
        assert type(port) is type(ref) and str(port) == str(ref)
        return
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.mode == ref.mode
    assert port.render() == ref.render()


def _tree():
    rs = np.random.RandomState(0)
    shapes = {"embed": {"kernel": (64, 32)}, "mlp": {
        "up": {"kernel": (32, 128), "bias": (128,)},
        "down": {"kernel": (128, 32), "bias": (32,)}}, "scale": (1,)}

    def make(node, f):
        return {k: make(v, f) if isinstance(v, dict) else f(
            rs.randn(*v).astype(np.float32)) for k, v in node.items()}

    return make(shapes, torch.from_numpy), make(shapes, jnp.asarray)


RULES = [(r"up/kernel", ("tp",), (None, "tp")), (r"up/bias", ("tp",), ("tp",)),
         (r"down/kernel", None, ("tp", None)), (r"embed", None, ("dp", None)),
         (r".*", None, ())]


def _rules(spec_cls):
    return [(rx, spec_cls(*s)) for rx, _, s in RULES]


def test_rule_resolution_equals_the_reference():
    pt, jt = _tree()
    got = pash.tree_paths(ptsh.resolve_param_specs(_rules(P), pt))
    want = jash.tree_paths(jtsh.resolve_param_specs(_rules(JP), jt))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [tuple(s) for _, s in got] == [tuple(s) for _, s in want]
    bp = ptsh.resolve_batch_specs(None, (torch.zeros(4, 2), torch.zeros(4)))
    bj = jtsh.resolve_batch_specs(None, (jnp.zeros((4, 2)), jnp.zeros(4)))
    assert [tuple(s) for s in bp] == [tuple(s) for s in bj]


def test_uncovered_param_fails_naming_the_path():
    pt, jt = _tree()
    rules = [(r"mlp", P())]
    with pytest.raises(ValueError) as port:
        ptsh.resolve_param_specs(rules, pt)
    with pytest.raises(ValueError) as ref:
        jtsh.resolve_param_specs([(r"mlp", JP())], jt)
    assert str(port.value) == str(ref.value)
    assert "embed/kernel" in str(port.value)
    cfg = ptrain.TrainConfig(mesh={"dp": 1}, rules=rules, device="cpu")
    with pytest.raises(ptrain.TrainBuildError, match="embed/kernel"):
        ptrain.Trainer(cfg).build(lambda p, b: 0.0, pt, (torch.zeros(2),))


def test_exact_entry_rules_equal_the_reference():
    pt, jt = _tree()
    ps_ = ptsh.resolve_param_specs(_rules(P), pt)
    js_ = jtsh.resolve_param_specs(_rules(JP), jt)
    bp, bj = (torch.zeros(4, 2),), (jnp.zeros((4, 2)),)
    got = ptsh.exact_entry_rules([
        ("state/params", pt, ps_),
        ("batch", bp, ptsh.resolve_batch_specs(None, bp))])
    want = jtsh.exact_entry_rules([
        ("state/params", jt, js_),
        ("batch", bj, jtsh.resolve_batch_specs(None, bj))])
    assert [(r, tuple(s)) for r, s in got] == [(r, tuple(s))
                                              for r, s in want]


@pytest.mark.parametrize("spec,shape", [
    ((None, "tp"), (8, 12)), (("tp", None), (8, 12)), (("dp",), (16,)),
    ((("dp", "tp"),), (16,)), ((), (3, 5)), (("tp",), (6,))])
def test_local_shape_and_slice_local_equal_the_reference(spec, shape):
    mesh = {"dp": 2, "tp": 2}
    assert ptsh.local_shape(shape, P(*spec), mesh) == \
        jtsh.local_shape(shape, JP(*spec), mesh)
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    if any(isinstance(e, tuple) for e in spec):
        return  # mixed-axis dims: both refuse the slice
    for axis in ("dp", "tp"):
        for i in range(2):
            got = ptsh.slice_local(torch.from_numpy(x), P(*spec), axis, i, 2)
            want = jtsh.slice_local(jnp.asarray(x), JP(*spec), axis, i, 2)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plan_wire_bytes_equals_the_reference():
    from apex_tpu.parallel import comm as jcomm
    from apex_tpu_torch.parallel import comm as pcomm

    sizes = [1000, 70000, 7, 300000]
    for wire in ("f32", "bf16", "int8"):
        for plan in (lambda c: c.sync_plan(sizes, 4, wire=wire),
                     lambda c: c.zero_plan(sum(sizes), 4, wire=wire)):
            assert ptsh.plan_wire_bytes(plan(pcomm)) == \
                jtsh.plan_wire_bytes(plan(jcomm))
    assert ptsh.ZERO_TWINS == jtsh.ZERO_TWINS
    from apex_tpu_torch.train import trainer as ttr

    assert ttr.ZERO_TWINS is ptsh.ZERO_TWINS


def test_optimizer_registry():
    assert set(popt.FACTORIES) == set(jopt.FACTORIES)
    for name in jopt.FACTORIES:
        assert popt.by_name(name) is getattr(popt, f"fused_{name}")
    with pytest.raises(ValueError) as port:
        popt.by_name("adma")
    with pytest.raises(ValueError) as ref:
        jopt.by_name("adma")
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the builds, across processes
# ---------------------------------------------------------------------------

BOGUS = [{"kind": "all-to-all", "axis": "tp", "count": 7, "dtypes": ["s8"]}]


def _demo_np():
    params = jax.tree.map(np.asarray, jdemo.demo_params(0))
    x, y = jdemo.demo_batch(1)
    return params, (np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_runs")
    params, batch = _demo_np()
    out = {}
    for world, meshes in ((2, ((2, 1), (1, 2))), (4, ((2, 2),))):
        cases = [(f"{dp}x{tp}", "trainer_case", dict(
            dp=dp, tp=tp, params_np=params, batch_np=batch, steps=STEPS,
            modes=("auto", "replicate") + (("auto:int8",) if dp * tp == 4
                                          else ()),
            bogus_plan=BOGUS)) for dp, tp in meshes]
        if world == 2:
            cases += [
                ("fit", "fit_case", dict(params_np=params, batch_np=batch,
                                         directory=str(tmp / "fit"),
                                         steps=8, preempt_at=5)),
                ("ckpt_fault", "ckpt_fault_case",
                 dict(directory=str(tmp / "fault"))),
            ]
        res = workers.spawn(world, cases, tmp, timeout=400)
        for dp, tp in meshes:
            out[(dp, tp)] = [r[f"{dp}x{tp}"] for r in res]
        if world == 2:
            out["fit"] = [r["fit"] for r in res]
            out["ckpt_fault"] = [r["ckpt_fault"] for r in res]
    return out


def _jax_demo(dp, tp, mode, wire="f32"):
    jps.destroy_model_parallel()
    step = jtrain.build_demo(dp, tp, update_sharding=mode, verify="off",
                             wire=wire)
    st, losses = step.state, []
    for _ in range(STEPS):
        st, aux = step(st, step.example_batch)
        losses.append(float(aux["loss"]))
    params = jax.tree.map(np.asarray, st["params"])
    jps.destroy_model_parallel()
    return step.mode, losses, params


@pytest.mark.parametrize("mesh,mode", [
    (m, mode) for m in MESHES for mode in ("auto", "replicate")
] + [((2, 2), "auto:int8")], ids=lambda v: (
    f"dp{v[0]}tp{v[1]}" if isinstance(v, tuple) else v))
def test_demo_trains_as_the_reference(mesh, mode, runs, eight_devices):
    upd, _, wire = mode.partition(":")
    jmode, jlosses, jparams = _jax_demo(*mesh, upd, wire or "f32")
    tol = TOL if not wire else INT8_TOL
    for rank, r in enumerate(runs[mesh]):
        got = r[mode]
        assert got["mode"] == jmode
        np.testing.assert_allclose(got["losses"], jlosses, **tol)
        code = 1.01 * max(np.abs(a).max() for a in jparams.values()) / 127
        for k, v in jparams.items():
            if not wire:
                np.testing.assert_allclose(got["params"][k], v, err_msg=k,
                                           **PARAM_TOL)
                continue
            diff = np.abs(got["params"][k] - v)
            assert diff.max() <= STEPS * 1e-2, k
            assert (diff <= code).mean() >= INT8_WITHIN_ONE_CODE, k


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}tp{m[1]}")
def test_call_log_equals_the_declared_plan(mesh, runs):
    """verify="error" passed with no finding: every collective of the
    step was declared, at its count, bytes and dtypes.  The log of a
    step (outside the build) names the same groups."""
    dp, tp = mesh
    for r in runs[mesh]:
        for mode in r:
            if mode in ("bogus", "norms", "flips"):
                continue
            got = r[mode]
            assert got["findings"] == [], got["findings"]
            assert got["log"] == got["plan"]
            kinds = {e["kind"] for e in got["expect"]["collectives"]}
            if dp > 1 and got["mode"] == "zero":
                want = ({"all-to-all", "all-gather"} if mode.endswith("int8")
                        else {"reduce-scatter", "all-gather"})
                assert want <= set(got["log"]) and want <= kinds
            if tp > 1:
                assert any(e["axis"] == "tp" and e["count"] == 1
                           for e in got["expect"]["collectives"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}tp{m[1]}")
def test_planted_bogus_plan_fails_the_build(mesh, runs):
    for r in runs[mesh]:
        assert r["bogus"] is not None
        assert "reshard-plan" in r["bogus"] and "all-to-all over tp" in \
            r["bogus"]


def test_metric_fold_and_grad_norm(runs):
    for mesh in MESHES:
        for r in runs[mesh]:
            # the registry holds the last step's loss
            assert r["auto"]["metrics"] == pytest.approx(
                r["auto"]["losses"][-1], rel=1e-6)
            norms = r["norms"]
            for mode, v in norms.items():
                if mesh == (2, 2) and mode == "shard":
                    assert "track_grad_norm" in v
                    continue
                assert v[0] > 0 and v[1] == pytest.approx(v[0])
            if "shard" in norms and mesh == (2, 1):
                assert norms["shard"][0] == pytest.approx(
                    norms["replicate"][0], rel=1e-5)


def test_optimizer_kwargs_survive_a_mode_flip(runs):
    for mesh in ((2, 1), (2, 2)):
        flips = runs[mesh][0]["flips"]
        assert len(flips) == 4
        by = {}
        for keys, mode, built, losses in flips:
            assert built == {"replicate": "ddp", "shard": "zero"}[mode]
            assert all(np.isfinite(losses)) and losses[1] < losses[0]
            by.setdefault(mode, []).append(losses)
        # both spellings are one optimizer
        for mode, (a, b) in by.items():
            assert a == b, mode


def test_fit_resumes_bit_for_bit(runs):
    for rank, r in enumerate(runs["fit"]):
        # saves every 2 steps and the preemption's final one, the
        # newest 3 kept
        assert r["first"] == (5, True, [2, 4, 5])
        plain, resumed = r["plain"], r["preempted"]
        assert resumed["resumed"] == 5 and resumed["steps_run"] == 2
        assert plain["last"] == resumed["last"] == 7
        np.testing.assert_array_equal(plain["master"], resumed["master"])
        for k in plain["params"]:
            np.testing.assert_array_equal(plain["params"][k],
                                          resumed["params"][k], err_msg=k)
        assert plain["goodput"]["accepted"] == 8
        assert plain["steps"] == [2, 4, 6]
        assert resumed["steps"] == [4, 5, 7]
    # each rank kept its own master shard
    a, b = (r["plain"]["master"] for r in runs["fit"])
    assert a.shape == b.shape and not np.array_equal(a, b)


def test_a_rank_failing_mid_save_commits_nothing(runs):
    for rank, r in enumerate(runs["ckpt_fault"]):
        assert r["raised"] in ("OSError", "RuntimeError")
        assert r["after_fault"] == []
        assert r["after"] == [7]
        np.testing.assert_array_equal(r["w"], np.arange(4.0))
        np.testing.assert_array_equal(r["m"], np.full(3, float(rank)))
        assert r["count"] == 2
        assert r["files"] == ["commit_success.txt", "rank0", "rank1",
                              "tree.json"]


# ---------------------------------------------------------------------------
# the BERT example's --ckpt-dir at world 2
# ---------------------------------------------------------------------------


def test_bert_example_resumes_at_world_2(tmp_path):
    from apex_tpu_torch.data import synthetic_token_corpus

    corpus = tmp_path / "bert.bin"
    synthetic_token_corpus(corpus, vocab_size=2048, num_tokens=20_000,
                           floor=1000)
    ck = str(tmp_path / "ckpt")
    base = ["--tiny", "--device", "cpu", "--batch", "4", "--seq-len", "16",
            "--lr", "1e-2", "--data", str(corpus), "--backend", "gloo"]
    cases = [
        ("full", "example_case", dict(module="pretrain_bert",
                                      argv=base + ["--steps", "6"])),
        ("first", "example_case", dict(
            module="pretrain_bert",
            argv=base + ["--steps", "4", "--ckpt-dir", ck,
                         "--save-every", "2"])),
        ("resumed", "example_case", dict(
            module="pretrain_bert",
            argv=base + ["--steps", "6", "--ckpt-dir", ck, "--resume"])),
    ]
    res = workers.spawn(2, cases, tmp_path, timeout=300)
    for r in res:
        assert r["first"] == r["full"][:4]
        assert r["resumed"] == r["full"][4:]
    assert res[0]["full"] == res[1]["full"]


# ---------------------------------------------------------------------------
# module_loss: the trainer over an nn.Module (GPT)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_module_loss_trains_gpt_as_the_hand_written_loop(remat):
    """Bit for bit, with full remat too: the recompute in the backward
    must read the trainer's tensors, not the module's own."""
    from apex_tpu_torch.models.gpt import GptConfig, GptModel, gpt_lm_loss
    from apex_tpu_torch.optimizers import FusedAdam

    cfg = GptConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=2, intermediate_size=64, max_seq_len=32,
                    dtype=torch.float32, remat=remat)
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, 64, size=(16, 4)))
    hand = GptModel(cfg, device="cpu")
    opt = FusedAdam(hand.parameters(), lr=1e-2)
    want = []
    for _ in range(3):
        loss = gpt_lm_loss(hand, ids)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        want.append(float(loss))
    model = GptModel(cfg, device="cpu")
    step = ptrain.Trainer(ptrain.TrainConfig(
        mesh={"dp": 1}, rules=[(r".*", P())], learning_rate=1e-2,
        batch_rules=[(r".*", P(None, "dp"))], device="cpu",
        verify="error")).build(
        ptrain.module_loss(model, gpt_lm_loss), ptrain.module_params(model),
        ids)
    st, got = step.state, []
    for _ in range(3):
        st, aux = step(st, ids)
        got.append(float(aux["loss"]))
    assert got == want
    for name, p in hand.named_parameters():
        assert torch.equal(st["params"][name.replace(".", "/")], p), name
    assert step.report.findings == []

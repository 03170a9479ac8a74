"""apex_tpu_torch.checkpoint against the JAX package's, on the CPU.

- the commit-marker rule: each debris and half-written scenario of
  tests/test_checkpoint.py gives the same ``all_steps`` / ``latest_step``
  in both packages, and each package's scan reads the other's directory
  as its owner does;
- the manager's interval policy and retention are orbax's;
- the codec: dtypes, numpy scalars, in-place restore into a template on
  its device, restore without a template as CPU tensors, a step of the
  manager and one of the async engine through one ``restore_step_dir``;
- the RNG tracker's streams resume mid-stream through a checkpoint;
- carrying state across: the JAX tiny BERT trains 2 LAMB steps and saves
  through ``apex_tpu.checkpoint``; the checkpoint restored to numpy is
  converted (params and the LAMB state) and the port trains 2 more
  steps; its losses and params match the JAX run continued from the
  same checkpoint, under tests/test_torch_bert.py's LAMB-step tolerance;
- port only: 4 uninterrupted steps of the tiny BERT with dropout drawn
  from the tracker equal 2 + save + restore + 2, bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu import checkpoint as ref_ckpt
from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.models.bert import BertForPreTraining as JaxBert
from apex_tpu.models.bert import bert_pretrain_loss as jax_bert_loss
from apex_tpu.optimizers import fused_lamb as jax_fused_lamb
from apex_tpu_torch import checkpoint as port_ckpt
from apex_tpu_torch.data import pack_mlm_predictions
from apex_tpu_torch.examples import pretrain_bert
from apex_tpu_torch.goodput import AsyncCheckpointEngine
from apex_tpu_torch.models import (
    BertConfig,
    BertForPreTraining,
    bert_from_jax_params,
    bert_lamb_state_from_jax,
    bert_to_jax_params,
    load_optimizer_state,
    optimizer_state,
)
from apex_tpu_torch.optimizers import FusedLAMB, FusedLAMBState
from apex_tpu_torch.transformer.tensor_parallel.random import (
    get_tpu_rng_tracker,
    model_parallel_tpu_manual_seed,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref_state(step):
    return {"w": jnp.zeros((2,)) + step}


def _port_state(step):
    return {"w": torch.zeros(2) + step}


def _save_three(pkg, d):
    state = _ref_state if pkg is ref_ckpt else _port_state
    with pkg.CheckpointManager(d) as mgr:
        for step in range(3):
            mgr.save(step, state(step))
        mgr.wait_until_finished()


def _w(out):
    return np.asarray(out["w"])


# ---------------------------------------------------------------------------
# the commit-marker rule
# ---------------------------------------------------------------------------


def _plant(d, scenario):
    if scenario == "uncommitted_debris":
        debris = d / f"3.orbax-checkpoint-tmp-{os.getpid()}"
        debris.mkdir()
        (debris / "params").write_text("torn write")
        (d / "not_a_step").mkdir()
    elif scenario == "half_written_step":
        (d / "7").mkdir()
        (d / "7" / "params").write_text("torn half-written payload")
    elif scenario == "port_staging_debris":
        staging = d / f"4{port_ckpt.STAGING_INFIX}{os.getpid()}-0"
        staging.mkdir()
        (staging / "tree.json").write_text("{}")
    elif scenario == "stray_file":
        (d / "9").write_text("a file, not a step directory")


SCENARIOS = ("uncommitted_debris", "half_written_step",
             "port_staging_debris", "stray_file")


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_commit_marker_rule_matches_the_reference(tmp_path, scenario):
    dirs = {}
    for pkg, name in ((ref_ckpt, "ref"), (port_ckpt, "port")):
        d = dirs[name] = tmp_path / name
        _save_three(pkg, d)
        _plant(d, scenario)
    for pkg, name in ((ref_ckpt, "ref"), (port_ckpt, "port")):
        d = dirs[name]
        assert pkg.all_steps(d) == [0, 1, 2]
        assert pkg.latest_step(d) == 2
        tmpl = _ref_state(0) if pkg is ref_ckpt else _port_state(0)
        if scenario == "half_written_step":
            with pytest.raises(FileNotFoundError, match="incomplete"):
                pkg.restore_step_dir(d, 7, template=tmpl)
        with pkg.CheckpointManager(d) as mgr:
            assert mgr.latest_step() == 2
            np.testing.assert_array_equal(
                _w(mgr.restore(template=tmpl)), [2.0, 2.0])
    # each scan reads the other package's directory as its owner does
    assert port_ckpt.all_steps(dirs["ref"]) == ref_ckpt.all_steps(dirs["ref"])
    assert ref_ckpt.all_steps(dirs["port"]) == port_ckpt.all_steps(
        dirs["port"])


def test_missing_and_empty_directories_match(tmp_path):
    for pkg in (ref_ckpt, port_ckpt):
        assert pkg.all_steps(tmp_path / "absent") == []
        assert pkg.latest_step(tmp_path / "absent") is None
        assert not (tmp_path / "absent").exists()
        with pkg.CheckpointManager(tmp_path / f"empty_{pkg.__name__}") as m:
            with pytest.raises(FileNotFoundError):
                m.restore()


@pytest.mark.parametrize("interval,keep", [(2, 2), (1, None), (3, 1)])
def test_manager_policy_and_retention_match(tmp_path, interval, keep):
    got = {}
    for pkg, state in ((ref_ckpt, _ref_state), (port_ckpt, _port_state)):
        d = tmp_path / pkg.__name__
        with pkg.CheckpointManager(d, max_to_keep=keep,
                                   save_interval_steps=interval) as mgr:
            saved = [mgr.save(s, state(s)) for s in range(7)]
            saved.append(mgr.save(3, state(3)))  # older than the latest
            mgr.wait_until_finished()
            got[pkg] = (saved, mgr.all_steps(), mgr.latest_step(),
                        _w(mgr.restore(template=state(0))).tolist())
    assert got[port_ckpt] == got[ref_ckpt]


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def test_roundtrip_keeps_dtypes_and_numpy_leaves(tmp_path):
    state = {"w": torch.arange(12.0).reshape(3, 4),
             "nested": {"b": torch.ones(5, dtype=torch.bfloat16),
                        "n": np.int64(7), "i8": torch.arange(-3, 3).to(
                            torch.int8)},
             "stream": {"next_batch": np.asarray(5, np.int64)},
             "seq": [np.arange(6, dtype=np.float32).reshape(2, 3).T, 3, 0.1,
                     None, "x", (True, torch.tensor(2.5))]}
    port_ckpt.save_checkpoint(tmp_path / "c", state)
    with pytest.raises(FileExistsError):
        port_ckpt.save_checkpoint(tmp_path / "c", state)
    out = port_ckpt.restore_checkpoint(tmp_path / "c")
    assert out["w"].device.type == "cpu" and torch.equal(out["w"], state["w"])
    assert out["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["nested"]["i8"], state["nested"]["i8"])
    n = out["nested"]["n"]
    assert isinstance(n, np.ndarray) and n.shape == () and n.dtype == np.int64
    assert int(n) == 7
    np.testing.assert_array_equal(out["seq"][0], state["seq"][0])
    assert out["seq"][1:5] == [3, 0.1, None, "x"]
    assert out["seq"][5][0] is True and float(out["seq"][5][1]) == 2.5
    # the reference restores a numpy scalar as a 0-d array too
    ref_ckpt.save_checkpoint(tmp_path / "r", {"n": np.int64(7)})
    r = ref_ckpt.restore_checkpoint(tmp_path / "r")["n"]
    assert r.shape == n.shape and r.dtype == n.dtype


def test_restore_loads_in_place_into_the_template(tmp_path):
    live = {"p": torch.randn(4, 3), "opt": FusedLAMBState(
        count=3, m={"a": torch.randn(2)}, v={"a": torch.rand(2)})}
    saved = {"p": live["p"].clone(),
             "opt": (live["opt"].count, dict(live["opt"].m),
                     dict(live["opt"].v))}
    port_ckpt.save_checkpoint(tmp_path / "c", live)
    tmpl = {"p": torch.zeros(4, 3), "opt": FusedLAMBState(
        count=0, m={"a": torch.zeros(2)}, v={"a": torch.zeros(2)})}
    ptrs = tmpl["p"].data_ptr(), tmpl["opt"].m["a"].data_ptr()
    out = port_ckpt.restore_checkpoint(tmp_path / "c", tmpl)
    assert out["p"] is tmpl["p"] and out["p"].data_ptr() == ptrs[0]
    assert torch.equal(tmpl["p"], saved["p"])
    assert isinstance(out["opt"], FusedLAMBState) and out["opt"].count == 3
    assert out["opt"].m["a"].data_ptr() == ptrs[1]
    assert torch.equal(out["opt"].v["a"], saved["opt"][2]["a"])
    with pytest.raises(ValueError, match="shape|holds"):
        port_ckpt.restore_checkpoint(tmp_path / "c", dict(
            tmpl, p=torch.zeros(3, 4)))
    with pytest.raises(ValueError, match="not in the checkpoint"):
        port_ckpt.restore_checkpoint(tmp_path / "c", dict(tmpl, q=1))


def test_manager_and_engine_steps_restore_through_one_path(tmp_path):
    with port_ckpt.CheckpointManager(tmp_path) as mgr:
        mgr.save(0, {"w": torch.full((3,), 1.0)})
    with AsyncCheckpointEngine(tmp_path) as eng:
        eng.save(1, {"w": torch.full((3,), 2.0)})
        eng.wait_until_finished()
        assert eng.all_steps() == [0, 1]
        assert eng.restore(0)["w"].tolist() == [1.0, 1.0, 1.0]
    for step, want in ((0, 1.0), (1, 2.0)):
        out = port_ckpt.restore_step_dir(tmp_path, step,
                                         template={"w": torch.zeros(3)})
        assert out["w"].tolist() == [want] * 3


def test_training_state_resumes_the_tracker_mid_stream(tmp_path):
    model_parallel_tpu_manual_seed(1234, tp_rank=0)
    tracker = get_tpu_rng_tracker()
    gen = tracker.fork()
    torch.randint(0, 2 ** 31 - 1, (5,), generator=gen)  # advance
    params = {"w": torch.ones(4, 4), "b": torch.zeros(4)}
    opt_state = {"count": 2, "m": {"w": torch.randn(4, 4)}}
    state = port_ckpt.snapshot_training_state(
        params, opt_state, step=17, stream={"next_batch": np.int64(18)},
        extra={"note": torch.arange(3)})
    port_ckpt.save_checkpoint(tmp_path / "snap", state)
    after_save = torch.randint(0, 2 ** 31 - 1, (5,), generator=gen)
    tracker.reset()
    restored = port_ckpt.restore_checkpoint(tmp_path / "snap")
    r_params, r_opt, r_step, r_amp, r_extra = (
        port_ckpt.restore_training_state(restored))
    assert r_step == 17 and r_amp is None
    assert torch.equal(r_params["w"], params["w"])
    assert r_opt["count"] == 2
    assert torch.equal(r_opt["m"]["w"], opt_state["m"]["w"])
    assert torch.equal(r_extra["note"], torch.arange(3))
    assert int(restored["stream"]["next_batch"]) == 18
    # the tracker resumes where the snapshot was taken
    again = torch.randint(0, 2 ** 31 - 1, (5,), generator=tracker.fork())
    assert torch.equal(again, after_save)
    with pytest.raises(RuntimeError, match="already exists"):
        tracker.add("model-parallel-rng", 1)
    with pytest.raises(RuntimeError, match="not added"):
        tracker.fork("nope")
    tracker.reset()


def test_tracker_seeds_follow_the_reference_layout():
    tracker = model_parallel_tpu_manual_seed(100, tp_rank=3)
    states = tracker.get_states()
    assert sorted(states) == ["default-rng", "model-parallel-rng"]
    for name, seed in (("default-rng", 100), ("model-parallel-rng",
                                               100 + 2718 + 3)):
        assert torch.equal(states[name],
                           torch.Generator().manual_seed(seed).get_state())
    tracker.reset()


# ---------------------------------------------------------------------------
# carrying a JAX training state across
# ---------------------------------------------------------------------------

DIMS = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            intermediate_size=256, max_position_embeddings=64)
SEQ, BATCH, K = 32, 4, 6


def _batch(step):
    """tests/test_torch_bert.py's packed batch (the one its LAMB-step
    tolerance was set on: lengths 32/20/7/0, the last row fully padded),
    for every step."""
    rs = np.random.RandomState(3)
    ids = rs.randint(0, DIMS["vocab_size"], size=(SEQ, BATCH)).astype(
        np.int32)
    mask = (np.arange(SEQ)[None] < np.array((32, 20, 7, 0))[:, None]).astype(
        np.int32)
    labels = np.where(rs.rand(SEQ, BATCH) < 0.25, ids, -1).astype(np.int32)
    token_types = (rs.rand(SEQ, BATCH) < 0.5).astype(np.int32)
    nsp = rs.randint(0, 2, size=(BATCH,)).astype(np.int32)
    pos, pids, w = pack_mlm_predictions(labels, K)
    return {"input_ids": ids, "token_type_ids": token_types,
            "attention_mask": mask, "nsp_labels": nsp, "mlm_positions": pos,
            "mlm_label_ids": pids, "mlm_weights": w}


def test_jax_training_state_continues_in_the_port(tmp_path):
    """JAX: 2 LAMB steps, save (params, LAMB state, step) through
    apex_tpu.checkpoint, 2 more.  The port: the checkpoint restored to
    numpy, converted, 2 more steps.  Losses within 1e-5, and the params
    after each continued step within tests/test_torch_bert.py's
    LAMB-step tolerance (atol 1e-6, rtol 1e-5) per step taken, on its
    batch: atol 1e-6 after the first, 2e-6 after the second (the two
    packages' gradients, norms and trust ratios differ in the last bits
    each step; after the second step the worst weight reads 1.3e-6)."""
    jmodel = JaxBert(JaxBertConfig(**DIMS, dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((SEQ, BATCH), jnp.int32))
    tx = jax_fused_lamb(learning_rate=1e-3, weight_decay=0.01)
    opt_state = tx.init(params)

    @jax.jit
    def step(p, s, b):
        loss, g = jax.value_and_grad(lambda q: jax_bert_loss(q, jmodel, b))(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    for i in range(2):
        params, opt_state, _ = step(params, opt_state, _batch(i))
    ref_ckpt.save_checkpoint(tmp_path / "jax", ref_ckpt.snapshot_training_state(
        params, opt_state, step=2))
    jax_losses, jax_params = [], []
    for i in (2, 3):
        params, opt_state, loss = step(params, opt_state, _batch(i))
        jax_losses.append(float(loss))
        jax_params.append(params)

    restored = ref_ckpt.restore_checkpoint(tmp_path / "jax")  # numpy
    cfg = BertConfig(**DIMS, dtype=torch.float32)
    model = bert_from_jax_params(restored["params"], cfg, device="cpu")
    lamb = bert_lamb_state_from_jax(restored["opt_state"], cfg, device="cpu")
    assert lamb.count == int(restored["step"]) == 2
    opt = FusedLAMB(model.parameters(), lr=1e-3, weight_decay=0.01)
    load_optimizer_state(opt, model, lamb)
    losses = []
    for n, i in enumerate((2, 3)):
        batch = {k: torch.from_numpy(v) for k, v in _batch(i).items()}
        losses.append(float(pretrain_bert.train_step(model, opt, batch)))
        port = dict(jax.tree_util.tree_leaves_with_path(
            bert_to_jax_params(model)))
        for path, leaf in jax.tree_util.tree_leaves_with_path(jax_params[n]):
            np.testing.assert_allclose(
                port[path], np.asarray(leaf), atol=1e-6 * (n + 1), rtol=1e-5,
                err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(losses, jax_losses, atol=1e-5, rtol=1e-5)
    assert opt.param_groups[0]["step"] == 4


def test_optimizer_state_round_trips_through_the_stateful_optimizer():
    cfg = BertConfig(**DIMS, dtype=torch.float32)
    model = BertForPreTraining(cfg, device="cpu")
    opt = FusedLAMB(model.parameters(), lr=1e-3)
    tree = optimizer_state(opt, model)
    assert tree["count"] == 0 and set(tree["m"]) == set(
        dict(model.named_parameters()))
    src = {"count": 5,
           "m": {k: torch.full_like(t, 0.5) for k, t in tree["m"].items()},
           "v": {k: torch.full_like(t, 0.25) for k, t in tree["v"].items()}}
    live = {k: t.data_ptr() for k, t in tree["m"].items()}
    load_optimizer_state(opt, model, src)
    again = optimizer_state(opt, model)
    assert again["count"] == 5
    for k, t in again["m"].items():
        assert t.data_ptr() == live[k] and bool((t == 0.5).all())


# ---------------------------------------------------------------------------
# port only: resume equals an uninterrupted run, bit for bit
# ---------------------------------------------------------------------------


def _dropout_run(steps, directory=None, resume=False, save_at=None):
    """The tiny BERT (dropout 0.1 everywhere) with FusedLAMB on the CPU,
    dropout seeds drawn from the tracker's model-parallel generator; the
    state goes through the example's ``training_state``."""
    cfg = BertConfig(**DIMS, dtype=torch.float32)
    model = BertForPreTraining(cfg, device="cpu")
    opt = FusedLAMB(model.parameters(), lr=1e-3, weight_decay=0.01)
    tracker = model_parallel_tpu_manual_seed(77)
    start = 0
    if resume:
        restored = port_ckpt.restore_step_dir(
            directory, port_ckpt.latest_step(directory),
            template=pretrain_bert.training_state(model, opt, 0))
        _, opt_state, start, _, _ = port_ckpt.restore_training_state(restored)
        load_optimizer_state(opt, model, opt_state)
    losses = []
    for i in range(start, steps):
        batch = {k: torch.from_numpy(v) for k, v in _batch(i).items()}
        losses.append(pretrain_bert.train_step(model, opt, batch,
                                               generator=tracker.fork()))
        if save_at == i + 1:
            port_ckpt.save_checkpoint(
                os.path.join(directory, str(i + 1)),
                pretrain_bert.training_state(model, opt, i + 1))
    return losses, model, opt, tracker.get_states()


def test_resume_equals_an_uninterrupted_run_bit_for_bit(tmp_path):
    full, model, opt, rng = _dropout_run(4)
    first, _, _, _ = _dropout_run(2, tmp_path, save_at=2)
    second, model_r, opt_r, rng_r = _dropout_run(4, tmp_path, resume=True)
    assert torch.equal(torch.stack(first + second), torch.stack(full))
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 model_r.named_parameters()):
        assert torch.equal(p, q), name
    a, b = optimizer_state(opt, model), optimizer_state(opt_r, model_r)
    assert a["count"] == b["count"] == 4
    for key in ("m", "v"):
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)
    assert all(torch.equal(rng[k], rng_r[k]) for k in rng)
    get_tpu_rng_tracker().reset()

"""apex_tpu_torch's tensor and sequence parallelism vs the JAX package.

The port runs in spawned gloo processes (``torch_dist_workers``: one
spawn per world size, every case of the file in it), the JAX package
under ``shard_map`` on the conftest's CPU devices, on the same seeded
numpy inputs:

- every mapping's forward and backward at tp 2 and 4, against numpy
  (the collectives' definitions) and the reference's pairs, and the
  call log of the collectives they issued;
- tiny GPT and BERT (f32) at tp = 2 and 4, with and without sequence
  parallelism: the loss and every rank's gradient shard (after the
  sequence-parallel gradient sum) against the JAX model under
  ``shard_map`` over a tp mesh of the same size, fed the same full
  weights; the JAX loss at tp > 1 also against its tp = 1 loss, which
  checks the shard layout of ``convert.tp_shard_jax_params``;
- a planted fault: every rank loading its neighbour's shard reads far
  past the limit;
- the vocab-parallel cross entropy with label smoothing, and the layers'
  init cut from the full weights (``sharded_init``), at tp = 2.

Limits: f32 end to end, ``TOL`` (XLA and PyTorch sum matmuls and
collectives in other orders).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_workers as workers
from apex_tpu import parallel_state as jps
from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.models.bert import BertForPreTraining as JaxBert
from apex_tpu.models.bert import bert_pretrain_loss as jax_bert_loss
from apex_tpu.models.gpt import GptConfig as JaxGptConfig
from apex_tpu.models.gpt import GptModel as JaxGpt
from apex_tpu.models.gpt import gpt_lm_loss as jax_gpt_loss
from apex_tpu.transformer.tensor_parallel import (
    allreduce_sequence_parallel_gradients as jax_sp_allreduce,
)
from apex_tpu_torch.models import convert

TOL = dict(atol=2e-5, rtol=2e-4)
GPT_DIMS = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, max_seq_len=16)
BERT_DIMS = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                 intermediate_size=64, max_position_embeddings=16)
SEQ, BATCH = 8, 2
#: (model, tp, sequence_parallel, rotary) cases; BERT's position table
#: is learned, GPT's rotary except in one case
MODEL_CASES = [
    ("gpt", 2, False, True), ("gpt", 2, True, True), ("gpt", 2, True, False),
    ("gpt", 4, False, True), ("gpt", 4, True, True),
    ("bert", 2, False, None), ("bert", 2, True, None),
    ("bert", 4, False, None), ("bert", 4, True, None),
]


def _case_name(kind, tp, sp, rotary):
    return f"{kind}_tp{tp}_sp{int(sp)}" + ("" if rotary in (None, True)
                                          else "_learned_pos")


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _gpt_cfg(sp, rotary, jax_side):
    kw = dict(GPT_DIMS, sequence_parallel=sp, rotary=rotary)
    if jax_side:
        return JaxGptConfig(**kw, dtype=jnp.float32)
    return kw


def _bert_cfg(sp, jax_side):
    kw = dict(BERT_DIMS, sequence_parallel=sp, hidden_dropout=0.0,
              attention_dropout=0.0)
    if jax_side:
        return JaxBertConfig(**kw, dtype=jnp.float32)
    return kw


def _ids(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, GPT_DIMS["vocab_size"], (SEQ, BATCH)).astype(np.int32)


def _bert_batch(seed=1):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, BERT_DIMS["vocab_size"], (SEQ, BATCH)).astype(np.int32)
    labels = np.where(rs.rand(SEQ, BATCH) < 0.4, ids, -1).astype(np.int32)
    mask = np.ones((BATCH, SEQ), np.int32)
    mask[1, 6:] = 0
    tt = np.zeros((SEQ, BATCH), np.int32)
    tt[SEQ // 2:] = 1
    return dict(input_ids=ids, token_type_ids=tt, attention_mask=mask,
                mlm_labels=labels,
                nsp_labels=rs.randint(0, 2, (BATCH,)).astype(np.int32))


@pytest.fixture(scope="module")
def full_params(tmp_path_factory):
    """The tp = 1 JAX weights of both models (seed 0), saved for the
    workers."""
    out = {}
    tmp = tmp_path_factory.mktemp("tp_params")
    for kind in ("gpt", "gpt_learned_pos", "bert"):
        if kind == "bert":
            model = JaxBert(_bert_cfg(False, True))
            b = _bert_batch()
            params = model.init(jax.random.PRNGKey(0), b["input_ids"])
        else:
            model = JaxGpt(_gpt_cfg(False, kind == "gpt", True))
            params = model.init(jax.random.PRNGKey(0), _ids())
        params = _np_tree(params)
        path = tmp / f"{kind}.pkl"
        with open(path, "wb") as f:
            pickle.dump(params, f)
        out[kind] = (params, str(path))
    return out


def _port_cases(full_params, tp):
    x = np.random.RandomState(3).randn(8, 2, 12).astype(np.float32)
    cases = [("mappings", "mappings_case", dict(x=x, tp=tp))]
    for kind, ctp, sp, rotary in MODEL_CASES:
        if ctp != tp:
            continue
        name = _case_name(kind, tp, sp, rotary)
        if kind == "gpt":
            key = "gpt" if rotary else "gpt_learned_pos"
            cases.append((name, "gpt_tp_case", dict(
                params_path=full_params[key][1],
                cfg_kwargs=_gpt_cfg(sp, rotary, False), tp=tp, ids=_ids())))
        else:
            cases.append((name, "bert_tp_case", dict(
                params_path=full_params["bert"][1],
                cfg_kwargs=_bert_cfg(sp, False), tp=tp,
                batch=_bert_batch())))
    rs = np.random.RandomState(7)
    cases.append(("ce_init", "ce_init_case", dict(
        logits=(3 * rs.randn(5, 3, 64)).astype(np.float32),
        target=rs.randint(0, 64, (5, 3)).astype(np.int64),
        g=rs.rand(5, 3).astype(np.float32),
        cfg_kwargs=_gpt_cfg(False, True, False), tp=tp)))
    if tp == 2:
        cases.append(("gpt_swapped_shards", "gpt_tp_case", dict(
            params_path=full_params["gpt"][1],
            cfg_kwargs=_gpt_cfg(False, True, False), tp=2, ids=_ids(),
            fault="swap_shard")))
    return cases


@pytest.fixture(scope="module")
def port_runs(full_params, tmp_path_factory):
    """Every case of the file on 2 and on 4 gloo ranks: rank r's results
    under ``runs[world][r]``."""
    tmp = tmp_path_factory.mktemp("tp_runs")
    return {tp: workers.spawn(tp, _port_cases(full_params, tp), tmp)
            for tp in (2, 4)}


def _jax_run(kind, tp, sp, rotary, params_full):
    """Loss and per-device gradient shards of the JAX model at ``tp``
    under ``shard_map``, each leaf's shards stacked on a leading axis."""
    jps.destroy_model_parallel()
    if kind == "gpt":
        model = JaxGpt(_gpt_cfg(sp, rotary, True))
        batch = jnp.asarray(_ids())

        def loss_fn(p, b):
            return jax_gpt_loss(p, model, b)
    else:
        model = JaxBert(_bert_cfg(sp, True))
        batch = {k: jnp.asarray(v) for k, v in _bert_batch().items()}

        def loss_fn(p, b):
            return jax_bert_loss(p, model, b)

    shards = [convert.tp_shard_jax_params(params_full, r, tp)
              for r in range(tp)]
    stacked = jax.tree.map(lambda *a: np.stack(a), *shards)
    mesh = jps.initialize_model_parallel(
        tensor_model_parallel_size=tp, devices=jax.devices()[:tp])
    try:
        def f(p, b):
            p = jax.tree.map(lambda a: a[0], p)
            loss, g = jax.value_and_grad(loss_fn)(p, b)
            if sp:
                g = jax_sp_allreduce(g)
            return loss, jax.tree.map(lambda a: a[None], g)

        loss, grads = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P("tp"), P()),
            out_specs=(P(), P("tp")), check_vma=False,
        ))(stacked, batch)
    finally:
        jps.destroy_model_parallel()
    return float(loss), _np_tree(grads)


def _jax_dense_loss(kind, rotary, params_full):
    if kind == "gpt":
        return float(jax_gpt_loss(params_full, JaxGpt(_gpt_cfg(
            False, rotary, True)), jnp.asarray(_ids())))
    batch = {k: jnp.asarray(v) for k, v in _bert_batch().items()}
    return float(jax_bert_loss(params_full, JaxBert(_bert_cfg(False, True)),
                               batch))


def _worst(port_grads, jax_grads, rank):
    """max |port - jax| / max(|jax|, 1e-6) over the leaves of rank's
    shard, with the leaf's path."""
    worst, where = 0.0, None
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax_grads))
    for path, got in jax.tree_util.tree_leaves_with_path(port_grads):
        want = np.asarray(flat_j[path])[rank]
        assert got.shape == want.shape, jax.tree_util.keystr(path)
        err = float(np.abs(got - want).max()) / max(
            float(np.abs(want).max()), 1e-6)
        if err > worst:
            worst, where = err, jax.tree_util.keystr(path)
    return worst, where


@pytest.mark.parametrize("kind,tp,sp,rotary", MODEL_CASES,
                         ids=[_case_name(*c) for c in MODEL_CASES])
def test_model_loss_and_grad_shards_match_jax(kind, tp, sp, rotary,
                                              full_params, port_runs):
    key = "bert" if kind == "bert" else ("gpt" if rotary else
                                         "gpt_learned_pos")
    params_full = full_params[key][0]
    loss_j, grads_j = _jax_run(kind, tp, sp, rotary, params_full)
    # the shard layout: JAX at tp > 1 on the port's shards is JAX at tp 1
    np.testing.assert_allclose(loss_j, _jax_dense_loss(kind, rotary,
                                                       params_full), **TOL)
    name = _case_name(kind, tp, sp, rotary)
    for rank, run in enumerate(port_runs[tp]):
        res = run[name]
        np.testing.assert_allclose(res["loss"], loss_j, **TOL)
        worst, where = _worst(res["grads"], grads_j, rank)
        assert worst < TOL["rtol"], (rank, where, worst)
        # sequence parallelism's collectives and its gradient sum ran
        log = res["log"]
        assert ("reduce-scatter" in log) == sp and \
            ("all-gather" in log) == sp, log
        assert (res["n_sp"] > 0) == sp


def test_swapped_shards_fail_the_limit(full_params, port_runs):
    """A planted fault: each rank holds its neighbour's shard."""
    loss_j, grads_j = _jax_run("gpt", 2, False, True, full_params["gpt"][0])
    res = port_runs[2][0]["gpt_swapped_shards"]
    worst, _ = _worst(res["grads"], grads_j, 0)
    loss_err = abs(res["loss"] - loss_j) / abs(loss_j)
    assert worst > 100 * TOL["rtol"] or loss_err > 100 * TOL["rtol"], (
        worst, loss_err)


def _split(a, tp, axis):
    return np.split(a, tp, axis=axis)


@pytest.mark.parametrize("tp", [2, 4])
def test_mappings_forward_backward(tp, port_runs):
    """Each mapping against the collective it stands for, computed in
    numpy from every rank's input and cotangent."""
    x = np.random.RandomState(3).randn(8, 2, 12).astype(np.float32)
    runs = [r["mappings"] for r in port_runs[tp]]
    ins = [x * (r + 1) for r in range(tp)]

    def cot(y, r):
        return y * 3 + r

    for r in range(tp):
        got = runs[r]
        # copy_to: identity forward, all-reduce backward
        y, g = got["copy_to_tensor_model_parallel_region"]
        np.testing.assert_allclose(y, ins[r], **TOL)
        np.testing.assert_allclose(
            g, sum(cot(ins[q], q) for q in range(tp)), **TOL)
        # reduce_from: all-reduce forward, identity backward
        y, g = got["reduce_from_tensor_model_parallel_region"]
        s = sum(ins)
        np.testing.assert_allclose(y, s, **TOL)
        np.testing.assert_allclose(g, cot(s, r), **TOL)
        # scatter_to (last dim): split forward, gather backward
        y, g = got["scatter_to_tensor_model_parallel_region"]
        np.testing.assert_allclose(y, _split(ins[r], tp, -1)[r], **TOL)
        np.testing.assert_allclose(g, np.concatenate(
            [cot(_split(ins[q], tp, -1)[q], q) for q in range(tp)], -1),
            **TOL)
        # gather_from (last dim): gather forward, split backward
        y, g = got["gather_from_tensor_model_parallel_region"]
        full = np.concatenate([_split(ins[q], tp, -1)[q] for q in range(tp)],
                              -1)
        np.testing.assert_allclose(y, full, **TOL)
        np.testing.assert_allclose(g, _split(cot(full, r), tp, -1)[r], **TOL)
        # scatter_to sequence: split(0) forward, gather(0) backward
        y, g = got["scatter_to_sequence_parallel_region"]
        np.testing.assert_allclose(y, _split(ins[r], tp, 0)[r], **TOL)
        np.testing.assert_allclose(g, np.concatenate(
            [cot(_split(ins[q], tp, 0)[q], q) for q in range(tp)], 0), **TOL)
        # gather_from sequence: gather(0) forward; reduce-scatter or
        # split backward
        full0 = np.concatenate([_split(ins[q], tp, 0)[q] for q in range(tp)])
        y, g = got["gather_from_sequence_parallel_region"]
        np.testing.assert_allclose(y, full0, **TOL)
        np.testing.assert_allclose(g, _split(sum(
            cot(full0, q) for q in range(tp)), tp, 0)[r], **TOL)
        y, g = got["gather_from_sequence_parallel_region_split"]
        np.testing.assert_allclose(g, _split(cot(full0, r), tp, 0)[r], **TOL)
        # reduce_scatter sequence: rs(0) forward, gather(0) backward
        y, g = got["reduce_scatter_to_sequence_parallel_region"]
        np.testing.assert_allclose(y, _split(s, tp, 0)[r], **TOL)
        np.testing.assert_allclose(g, np.concatenate(
            [cot(_split(s, tp, 0)[q], q) for q in range(tp)], 0), **TOL)
    # one collective per direction that is not the identity, all on tp:
    # 2 all-reduces, 6 all-gathers (4 forward, 2 backward), 2
    # reduce-scatters (one each way)
    kinds = [rec["kind"] for rec in runs[0]["log"]]
    assert {rec["axis"] for rec in runs[0]["log"]} == {"tp"}
    assert (kinds.count("all-reduce"), kinds.count("all-gather"),
            kinds.count("reduce-scatter"), len(kinds)) == (2, 6, 2, 10)


def test_mappings_are_the_identity_at_tp1():
    """Without a model-parallel group every mapping returns its input
    and issues no collective."""
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer.tensor_parallel import mappings as mp

    x = torch.randn(4, 3, requires_grad=True)
    with comm.collective_log() as log:
        for name in ("copy_to_tensor_model_parallel_region",
                     "reduce_from_tensor_model_parallel_region",
                     "scatter_to_tensor_model_parallel_region",
                     "gather_from_tensor_model_parallel_region",
                     "scatter_to_sequence_parallel_region",
                     "gather_from_sequence_parallel_region",
                     "reduce_scatter_to_sequence_parallel_region"):
            y = getattr(mp, name)(x)
            (g,) = torch.autograd.grad(y, x, torch.ones_like(y))
            assert torch.equal(y, x) and torch.equal(g, torch.ones_like(x))
    assert log == []


def test_tp_shard_layout_is_the_references(full_params):
    """``tp_shard_jax_params`` gives the shapes the JAX model's own init
    gives each device under ``shard_map`` at tp = 2."""
    for kind in ("gpt", "bert"):
        params_full = full_params[kind][0]
        mesh = jps.initialize_model_parallel(
            tensor_model_parallel_size=2, devices=jax.devices()[:2])
        try:
            if kind == "gpt":
                model = JaxGpt(_gpt_cfg(False, True, True))
                x = jnp.asarray(_ids())
            else:
                model = JaxBert(_bert_cfg(False, True))
                x = jnp.asarray(_bert_batch()["input_ids"])
            local = jax.eval_shape(jax.shard_map(
                lambda k, i: model.init(k, i), mesh=mesh,
                in_specs=(P(), P()), out_specs=P(), check_vma=False),
                jax.random.PRNGKey(0), x)
        finally:
            jps.destroy_model_parallel()
        mine = convert.tp_shard_jax_params(params_full, 1, 2)
        assert jax.tree.structure(local) == jax.tree.structure(mine)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(local),
                                jax.tree.leaves(mine)):
            assert tuple(a.shape) == b.shape, jax.tree_util.keystr(path)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vocab_parallel_cross_entropy_matches_jax(tp, smoothing, port_runs):
    """Loss (the same on every rank) and each rank's logits-slice
    gradient against the JAX cross entropy under ``shard_map``."""
    from apex_tpu.transformer.tensor_parallel import (
        vocab_parallel_cross_entropy as jax_ce,
    )

    rs = np.random.RandomState(7)
    logits = (3 * rs.randn(5, 3, 64)).astype(np.float32)
    target = rs.randint(0, 64, (5, 3)).astype(np.int32)
    g = rs.rand(5, 3).astype(np.float32)
    mesh = jps.initialize_model_parallel(
        tensor_model_parallel_size=tp, devices=jax.devices()[:tp])
    try:
        def f(lg, t, gg):
            loss, vjp = jax.vjp(lambda x: jax_ce(x, t, smoothing), lg)
            return loss, vjp(gg)[0]

        loss_j, grad_j = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P(None, None, "tp"), P(), P()),
            out_specs=(P(), P(None, None, "tp")), check_vma=False,
        ))(logits, target, g)
    finally:
        jps.destroy_model_parallel()
    grads = np.split(np.asarray(grad_j), tp, axis=-1)
    for r, run in enumerate(port_runs[tp]):
        loss, grad = run["ce_init"][f"ce_{smoothing}"]
        np.testing.assert_allclose(loss, np.asarray(loss_j), **TOL)
        np.testing.assert_allclose(grad, grads[r], **TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_init_is_the_tp1_init_split(tp, port_runs):
    """A GptModel built at tp from generator seed 0 holds exactly the
    tp = 1 model's weights from the same seed, split (each rank's shard
    gathered back here)."""
    from apex_tpu_torch.models.gpt import GptConfig, GptModel

    dense = GptModel(GptConfig(**_gpt_cfg(False, True, False),
                               dtype=torch.float32), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    want = torch.randn((8, 12), generator=torch.Generator().manual_seed(1))
    for rank, run in enumerate(port_runs[tp]):
        np.testing.assert_array_equal(
            run["ce_init"]["sharded_init"],
            want.chunk(tp, 1)[rank].numpy())
        full = run["ce_init"]["init"]
        for name, p in dense.named_parameters():
            np.testing.assert_array_equal(full[name], p.detach().numpy(),
                                          err_msg=name)


def test_to_per_rank_key_folds_the_rank(monkeypatch):
    """Distinct tp ranks get distinct seeds (an int, an int32 seed
    tensor, a generator), the same rank the same one; the fold is a
    31-bit seed."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.transformer.tensor_parallel import to_per_rank_key

    seeds = {}
    for rank in range(4):
        monkeypatch.setattr(ps, "axis_rank", lambda axis, r=rank: r)
        a = to_per_rank_key(-12345)
        b = to_per_rank_key(torch.tensor([-12345], dtype=torch.int32))
        c = to_per_rank_key(torch.Generator().manual_seed(-12345 % 2 ** 63))
        assert a == to_per_rank_key(-12345) and 0 <= a < 2 ** 31
        assert int(b) == a and b.dtype == torch.int32
        assert c.initial_seed() == to_per_rank_key(-12345 % 2 ** 63)
        seeds[rank] = a
    assert len(set(seeds.values())) == 4


def test_rng_correct_checkpoint_replays_the_tracker_stream():
    """A checkpointed function that draws its dropout mask from the
    model-parallel stream gives the gradients of the same function
    without a checkpoint: the recompute sees the stream as the forward
    did, and the stream ends where one forward leaves it."""
    from apex_tpu_torch.transformer.tensor_parallel import (
        checkpoint,
        get_tpu_rng_tracker,
        model_parallel_tpu_manual_seed,
    )

    def fn(x):
        gen = get_tpu_rng_tracker().fork()
        keep = torch.rand(x.shape, generator=gen) >= 0.5
        return torch.where(keep, x.tanh() * 2, 0.0)

    x = torch.randn(6, 5, requires_grad=True)
    model_parallel_tpu_manual_seed(3)
    (want,) = torch.autograd.grad(fn(x).sum(), x)
    after = get_tpu_rng_tracker().get_states()
    model_parallel_tpu_manual_seed(3)
    y = checkpoint(fn, False, x)  # the reference's positional flag
    (got,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(got, want)
    for name, state in get_tpu_rng_tracker().get_states().items():
        assert torch.equal(state, after[name]), name

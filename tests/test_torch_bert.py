"""apex_tpu_torch's BERT pretraining slice vs the JAX package.

- the MLM data path: ``mlm_mask_batch``, ``pack_mlm_predictions`` and
  ``bert_mlm_batches`` bit-identical to the JAX package's;
- the converter: both JAX trees (scanned and unrolled) round-trip
  exactly;
- a tiny BERT (vocab 512, hidden 128, 2 layers, 2 heads of 64, f32, S
  32, B 4) with a padded attention_mask whose last row is all zero,
  initialised by the JAX ``BertForPreTraining.init`` and carried over:
  the MLM hidden states, the NSP logits, ``bert_pretrain_loss`` (dense,
  packed and chunked) and every parameter's gradient against
  ``jax.value_and_grad`` (``deterministic=True``; the JAX model sends
  S = 32 attention to its jnp composition, which autodiff differentiates
  correctly in the all-zero row); one LAMB step of both trainers;
- remat equal to no remat, with and without dropout (the seeds drawn
  before each block give the recompute the same masks);
- the example trainer for three steps on ``device="cpu"``, and its
  checkpoints: a resumed run's losses are an uninterrupted run's.

Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_workers as workers

from apex_tpu import _native
from apex_tpu import data as jax_data
from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.models.bert import BertForPreTraining as JaxBert
from apex_tpu.models.bert import bert_pretrain_loss as jax_bert_loss
from apex_tpu.optimizers import fused_lamb as jax_fused_lamb
from apex_tpu_torch import checkpoint as port_ckpt
from apex_tpu_torch import data as port_data
from apex_tpu_torch.examples import pretrain_bert
from apex_tpu_torch.models import (
    BertConfig,
    BertForPreTraining,
    bert_from_jax_params,
    bert_pretrain_loss,
    bert_to_jax_params,
)
from apex_tpu_torch.optimizers import FusedLAMB

DIMS = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            intermediate_size=256, max_position_embeddings=64)
SEQ, BATCH, K = 32, 4, 6
LENGTHS = (32, 20, 7, 0)  # the last sequence has no real token
#: f32 end to end; XLA and PyTorch sum matmuls and rows in other orders
TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _destroy_port_parallel_state():
    """Leave no port ``parallel_state`` behind (an example's ``main``
    leaves it initialized) for the next test or the next file in this
    worker."""
    yield from workers.port_state_guard()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs several workers
    at once, and some of their tests time the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_trees_close(port_tree, jax_tree, **tol):
    port = dict(jax.tree_util.tree_leaves_with_path(port_tree))
    ref = jax.tree_util.tree_leaves_with_path(jax_tree)
    assert len(port) == len(ref)
    for path, leaf in ref:
        np.testing.assert_allclose(
            port[path], np.asarray(leaf), err_msg=jax.tree_util.keystr(path),
            **tol,
        )


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_mlm_mask_batch_is_jax_bit_for_bit():
    ids = np.random.RandomState(0).randint(0, 30522, size=(16, 128))
    for seed in (0, 42, 2 ** 63 + 12345):
        out = port_data.mlm_mask_batch(ids, seed)
        ref = _native.mlm_mask_batch(ids.astype(np.int32), seed)
        for a, r in zip(out, ref):
            assert a.dtype == r.dtype == np.int32
            np.testing.assert_array_equal(a, r)


@pytest.mark.parametrize("k,with_rng,seq_first", [
    (20, False, True), (5, True, True), (5, True, False), (40, False, True),
])
def test_pack_mlm_predictions_is_jax_bit_for_bit(k, with_rng, seq_first):
    """Under and over the K budget, random and in-order selection, both
    layouts, K > S."""
    rs = np.random.RandomState(k)
    labels = np.where(rs.rand(32, 6) < 0.3, rs.randint(0, 100, (32, 6)), -1)
    labels[:, 0] = -1  # a sequence with nothing to predict
    if not seq_first:
        labels = labels.T

    def rng():
        return np.random.default_rng(7) if with_rng else None

    out = port_data.pack_mlm_predictions(labels, k, seq_first, rng())
    ref = jax_data.pack_mlm_predictions(labels, k, seq_first, rng())
    for a, r in zip(out, ref):
        assert a.dtype == r.dtype and a.shape == (k, 6)
        np.testing.assert_array_equal(a, r)


def test_bert_mlm_batches_are_jax_bit_for_bit(tmp_path):
    """The same corpus, loader and seeds give the same batch dicts, with
    the packed triple, from a resumed start step too."""
    path = port_data.synthetic_token_corpus(
        tmp_path / "corpus.bin", vocab_size=30522, num_tokens=40_000,
        floor=1000)
    for start in (0, 5):
        streams = [
            mod.bert_mlm_batches(
                mod.DataLoader(mod.TokenFileDataset(path, seq_len=128),
                               batch_size=8, seed=1234),
                seed=42, max_predictions_per_seq=20, start_step=start)
            for mod in (port_data, jax_data)
        ]
        for _ in range(3):
            out, ref = (next(s) for s in streams)
            assert set(out) == set(ref)
            for key in ref:
                assert out[key].dtype == ref[key].dtype, key
                np.testing.assert_array_equal(out[key], ref[key], key)


# ---------------------------------------------------------------------------
# the converter and the model
# ---------------------------------------------------------------------------


def _jax_params(scan_layers):
    jcfg = JaxBertConfig(**DIMS, dtype=jnp.float32, scan_layers=scan_layers)
    jmodel = JaxBert(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((SEQ, BATCH), jnp.int32))
    return jmodel, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_bert():
    jmodel, params = _jax_params(scan_layers=True)
    rs = np.random.RandomState(3)
    ids = rs.randint(0, DIMS["vocab_size"], size=(SEQ, BATCH)).astype(np.int32)
    mask = (np.arange(SEQ)[None] < np.array(LENGTHS)[:, None]).astype(np.int32)
    labels = np.where(rs.rand(SEQ, BATCH) < 0.25, ids, -1).astype(np.int32)
    batch = {
        "input_ids": ids,
        "token_type_ids": (rs.rand(SEQ, BATCH) < 0.5).astype(np.int32),
        "attention_mask": mask,
        "mlm_labels": labels,
        "nsp_labels": rs.randint(0, 2, size=(BATCH,)).astype(np.int32),
    }
    pos, pids, w = jax_data.pack_mlm_predictions(labels, K)
    packed = dict(batch, mlm_positions=pos, mlm_label_ids=pids,
                  mlm_weights=w)
    del packed["mlm_labels"]
    return jmodel, params, batch, packed


def _cfg(**over):
    return BertConfig(**DIMS, dtype=torch.float32, **over)


def _port(params, **over):
    return bert_from_jax_params(params, _cfg(**over), device="cpu")


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("scan_layers", [True, False])
def test_params_cross_exactly_both_ways(scan_layers):
    """Scanned (``encoder/layers/layer``, a leading layer axis) and
    unrolled (``encoder/layer_<i>``) trees both cross exactly, and each
    comes back in its own layout."""
    _, params = _jax_params(scan_layers)
    model = _port(params, scan_layers=scan_layers)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(params))
    _assert_trees_close(bert_to_jax_params(model), params, atol=0, rtol=0)


def test_forward_matches_jax(jax_bert):
    """MLM hidden states and NSP logits, TOL."""
    jmodel, params, batch, _ = jax_bert
    (h_j, bias_j), nsp_j = jmodel.apply(
        params, batch["input_ids"], batch["token_type_ids"],
        batch["attention_mask"])
    model = _port(params)
    tb = _t(batch)
    with torch.no_grad():
        (h, bias), nsp = model(tb["input_ids"], tb["token_type_ids"],
                               tb["attention_mask"])
    assert h.shape == (SEQ, BATCH, DIMS["hidden_size"])
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **TOL)
    np.testing.assert_allclose(nsp.numpy(), np.asarray(nsp_j), **TOL)
    np.testing.assert_array_equal(bias.detach().numpy(), np.asarray(bias_j))


@pytest.mark.parametrize("head,chunks", [
    ("dense", None), ("packed", None), ("dense", 4),
])
def test_loss_and_grads_match_jax(jax_bert, head, chunks):
    """``bert_pretrain_loss`` within 1e-5 and every gradient leaf within
    TOL, on the dense labels, the packed triple and the dense labels in
    4 chunks."""
    jmodel, params, batch, packed = jax_bert
    b = packed if head == "packed" else batch
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_bert_loss(p, jmodel, _j(b), mlm_loss_chunks=chunks)
    )(params)
    model = _port(params)
    loss = bert_pretrain_loss(model, _t(b), mlm_loss_chunks=chunks)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), atol=1e-5,
                               rtol=1e-5)
    grads = bert_to_jax_params(
        model, {n: p.grad for n, p in model.named_parameters()})
    _assert_trees_close(grads, grads_j, **TOL)


def test_one_lamb_step_matches_jax(jax_bert):
    """One ``bert_pretrain_loss`` + LAMB step (lr 1e-3, wd 0.01) on both
    sides from the same weights: the weights after it within atol 1e-6
    (the step moves a weight by ~1e-4; the trust ratios are f32 norms)."""
    jmodel, params, _, packed = jax_bert
    tx = jax_fused_lamb(learning_rate=1e-3, weight_decay=0.01)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    g_j = jax.grad(lambda p: jax_bert_loss(p, jmodel, _j(packed)))(p_j)
    updates, _ = tx.update(g_j, tx.init(p_j), p_j)
    p_j = optax.apply_updates(p_j, updates)
    model = _port(params)
    opt = FusedLAMB(model.parameters(), lr=1e-3, weight_decay=0.01)
    pretrain_bert.train_step(model, opt, _t(packed))
    _assert_trees_close(bert_to_jax_params(model), p_j, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dropout", [False, True])
def test_remat_matches_no_remat(jax_bert, dropout):
    """Full remat recomputes each block with the same arithmetic and, with
    dropout, the same masks (the block's seeds are drawn before it): the
    same loss and gradients to the last bit."""
    _, params, _, packed = jax_bert
    out = []
    for remat in (False, True):
        model = _port(params, remat=remat)
        gen = torch.Generator().manual_seed(11) if dropout else None
        loss = bert_pretrain_loss(model, _t(packed),
                                  deterministic=not dropout, generator=gen)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_dropout_changes_the_loss_and_needs_a_cpu_generator(jax_bert):
    _, params, _, packed = jax_bert
    model = _port(params)
    base = bert_pretrain_loss(model, _t(packed))
    gen = torch.Generator().manual_seed(1)
    dropped = bert_pretrain_loss(model, _t(packed), deterministic=False,
                                 generator=gen)
    again = bert_pretrain_loss(model, _t(packed), deterministic=False,
                               generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(dropped) and not torch.equal(base, dropped)
    assert torch.equal(dropped, again)
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        bert_pretrain_loss(model, _t(packed), deterministic=False)


@pytest.mark.parametrize("over,match", [
    (dict(sequence_parallel=True), "ROADMAP item 5"),
])
def test_unported_options_raise(over, match):
    """``sequence_parallel`` raised until ROADMAP item 5 ported it: now it
    builds, and at tp = 1 (no model-parallel group) the model is the
    dense one, bit for bit."""
    sp = BertForPreTraining(_cfg(**over), device="cpu")
    dense = BertForPreTraining(_cfg(), device="cpu")
    assert match == "ROADMAP item 5"
    for (name, a), (_, b) in zip(sp.named_parameters(),
                                 dense.named_parameters()):
        assert torch.equal(a, b), name
    ids = torch.randint(0, sp.cfg.vocab_size, (16, 2),
                        generator=torch.Generator().manual_seed(0))
    (h_sp, _), nsp_sp = sp(ids)
    (h, _), nsp = dense(ids)
    assert torch.equal(h_sp, h) and torch.equal(nsp_sp, nsp)


# ---------------------------------------------------------------------------
# the example trainer
# ---------------------------------------------------------------------------


def test_example_trains_three_steps_on_cpu(tmp_path):
    corpus = port_data.synthetic_token_corpus(
        tmp_path / "corpus.bin", vocab_size=2048, num_tokens=20_000,
        floor=1000)
    losses = pretrain_bert.main([
        "--tiny", "--device", "cpu", "--steps", "3", "--batch", "4",
        "--seq-len", "32", "--lr", "1e-2", "--data", corpus,
    ])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("case", ["save_then_resume", "resume_empty_dir",
                                  "resume_past_steps"])
def test_example_checkpoints_and_resumes(tmp_path, case):
    """``--save-every 2`` for 4 steps (checkpoints at 1, 2 and 4: orbax's
    policy saves the first step, ``max_to_keep=2`` keeps 2 and 4), then
    ``--resume`` to 6: the losses equal an uninterrupted 6-step run's bit
    for bit; ``--resume`` on an empty directory starts at step 0;
    ``--resume`` past ``--steps`` trains nothing."""
    corpus = port_data.synthetic_token_corpus(
        tmp_path / "corpus.bin", vocab_size=2048, num_tokens=20_000,
        floor=1000)
    base = ["--tiny", "--device", "cpu", "--batch", "4", "--seq-len", "32",
            "--lr", "1e-2", "--data", str(corpus)]
    ckpt = ["--ckpt-dir", str(tmp_path / "ckpt")]
    full = pretrain_bert.main(base + ["--steps", "6"])
    if case == "save_then_resume":
        first = pretrain_bert.main(base + ckpt + ["--steps", "4",
                                                  "--save-every", "2"])
        assert port_ckpt.all_steps(tmp_path / "ckpt") == [2, 4]
        run = pretrain_bert.train(pretrain_bert.parse_args(
            base + ckpt + ["--steps", "6", "--resume", "--save-every", "2"]))
        run.close()
        assert run.resumed_from == 4 and len(run.losses) == 2
        assert first + run.losses == full
        assert run.checkpoints == [4, 6]
    elif case == "resume_empty_dir":
        run = pretrain_bert.train(pretrain_bert.parse_args(
            base + ckpt + ["--steps", "6", "--resume"]))
        run.close()
        assert run.resumed_from is None and run.losses == full
    else:
        pretrain_bert.main(base + ckpt + ["--steps", "4", "--save-every",
                                          "2"])
        run = pretrain_bert.train(pretrain_bert.parse_args(
            base + ckpt + ["--steps", "3", "--resume"]))
        run.close()
        assert run.resumed_from == 4 and run.losses == []

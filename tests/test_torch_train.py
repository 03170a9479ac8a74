"""apex_tpu_torch's training slice vs the JAX package.

- ``fused_adam`` / ``FusedAdam``: three steps in both ``adam_w_mode``s
  with weight decay and a learning-rate schedule;
- the data pipeline: the same corpus file and the same batches for the
  same seed (shuffled, sharded, across an epoch boundary);
- GPT: a tiny f32 model (vocab 128, hidden 64, 2 layers, 4 heads, S 32)
  initialised by the JAX ``GptModel.init`` and carried over with
  ``from_jax_params``; the loss and every parameter's gradient (laid out
  as the JAX tree by ``to_jax_params``) against ``jax.value_and_grad``
  of ``gpt_lm_loss`` with the JAX kernels in interpret mode; remat on
  equal to remat off; three Adam steps of both trainers;
- the example trainer for three steps on ``device="cpu"``.

Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu import data as jax_data
from apex_tpu.models.gpt import GptConfig as JaxGptConfig
from apex_tpu.models.gpt import GptModel as JaxGptModel
from apex_tpu.models.gpt import gpt_lm_loss as jax_gpt_lm_loss
from apex_tpu.ops import _dispatch as jax_dispatch
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu_torch import data as port_data
from apex_tpu_torch.examples import train_gpt
from apex_tpu_torch.models import (
    GptConfig,
    GptModel,
    from_jax_params,
    gpt_lm_loss,
    to_jax_params,
)
from apex_tpu_torch.ops import _dispatch
from apex_tpu_torch.optimizers import FusedAdam, fused_adam

DIMS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_seq_len=64)
SEQ, BATCH = 32, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs several workers
    at once, and some of their tests time the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def force_pallas():
    jax_dispatch.set_use_pallas(True)
    yield
    jax_dispatch.set_use_pallas(None)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_trees_close(port_tree, jax_tree, **tol):
    port = dict(_leaves(port_tree))
    ref = _leaves(jax_tree)
    assert len(port) == len(ref)
    for path, leaf in ref:
        np.testing.assert_allclose(
            port[path], np.asarray(leaf), err_msg=jax.tree_util.keystr(path),
            **tol,
        )


# ---------------------------------------------------------------------------
# FusedAdam
# ---------------------------------------------------------------------------


def _sched(count):
    """A decaying schedule both frameworks evaluate at the 0-based step."""
    return 1e-2 / (1.0 + count)


def _adam_problem(seed):
    rs = np.random.RandomState(seed)
    params = {"w": rs.randn(8, 5).astype(np.float32),
              "b": rs.randn(5).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_three_steps_match_jax(adam_w_mode):
    """Functional form, weight decay 0.01, scheduled lr: the params after
    each of three steps within 1e-6 (f32 elementwise arithmetic, the
    same formula; updates are ~1e-2)."""
    params, grads = _adam_problem(seed=int(adam_w_mode))
    kw = dict(weight_decay=0.01, adam_w_mode=adam_w_mode)
    tx_j = jax_fused_adam(learning_rate=_sched, **kw)
    tx = fused_adam(learning_rate=_sched, **kw)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    s_j, s = tx_j.init(p_j), tx.init(p)
    for g in grads:
        u_j, s_j = tx_j.update({k: jnp.asarray(v) for k, v in g.items()},
                               s_j, p_j)
        p_j = optax.apply_updates(p_j, u_j)
        u, s = tx.update({k: torch.from_numpy(v) for k, v in g.items()}, s, p)
        p = {k: p[k] + u[k] for k in p}
        for k in params:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(p_j[k]),
                                       atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(s.m[k].numpy(), np.asarray(s_j.m[k]),
                                       atol=1e-6, rtol=1e-6)
    assert s.count == int(s_j.count) == 3


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_optimizer_matches_jax_wrapper(adam_w_mode):
    """``FusedAdam(params).step()`` on ``.grad`` against the JAX
    ``FusedAdam(params).step(grads, params)``, three steps, 1e-6."""
    params, grads = _adam_problem(seed=10 + int(adam_w_mode))
    kw = dict(lr=3e-3, betas=(0.8, 0.95), eps=1e-6, weight_decay=0.1,
              adam_w_mode=adam_w_mode)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    opt_j = JaxFusedAdam(p_j, **kw)
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = FusedAdam(list(ps.values()), **kw)
    for g in grads:
        p_j = opt_j.step({k: jnp.asarray(v) for k, v in g.items()}, p_j)
        for k, v in g.items():
            ps[k].grad = torch.from_numpy(v)
        opt.step()
    for k in params:
        np.testing.assert_allclose(ps[k].detach().numpy(), np.asarray(p_j[k]),
                                   atol=1e-6, rtol=1e-6)


def test_fused_adam_refuses_amsgrad():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam([torch.nn.Parameter(torch.zeros(2))], amsgrad=True)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_corpus_and_batches_match_jax(tmp_path):
    """The same corpus bytes and, for the same seed, the same (B, S)
    batches — across an epoch boundary, on each of two shards."""
    kw = dict(vocab_size=1024, num_tokens=20_000, zipf_a=1.2, seed=1)
    pj = jax_data.synthetic_token_corpus(tmp_path / "jax.bin", **kw)
    pp = port_data.synthetic_token_corpus(tmp_path / "port.bin", **kw)
    assert (tmp_path / "jax.bin").read_bytes() == (tmp_path / "port.bin").read_bytes()
    for shard in ((0, 1), (1, 2)):
        lj = jax_data.DataLoader(jax_data.TokenFileDataset(pj, seq_len=32),
                                 batch_size=8, seed=7, shard=shard)
        lp = port_data.DataLoader(port_data.TokenFileDataset(pp, seq_len=32),
                                  batch_size=8, seed=7, shard=shard)
        assert lp.batches_per_epoch == lj.batches_per_epoch
        n = lj.batches_per_epoch + 3
        for bj, bp in zip(lj.iter_from(0), lp.iter_from(0)):
            np.testing.assert_array_equal(bp, bj)
            assert bp.dtype == bj.dtype and bp.shape == (8, 32)
            n -= 1
            if n == 0:
                break


def test_gather_rows_bounds():
    base = np.arange(10, dtype=np.uint16)
    np.testing.assert_array_equal(
        port_data.gather_rows(base, np.array([0, 6]), 4),
        [[0, 1, 2, 3], [6, 7, 8, 9]],
    )
    with pytest.raises(IndexError):
        port_data.gather_rows(base, np.array([7]), 4)


# ---------------------------------------------------------------------------
# GPT
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_gpt():
    jcfg = JaxGptConfig(**DIMS, dtype=jnp.float32)
    jmodel = JaxGptModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((SEQ, BATCH), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    ids = np.random.RandomState(7).randint(
        0, DIMS["vocab_size"], size=(SEQ, BATCH)).astype(np.int32)
    return jmodel, params, ids


def _port_model(params, **over):
    cfg = GptConfig(**DIMS, dtype=torch.float32, **over)
    return from_jax_params(params, cfg, device="cpu")


def test_params_cross_exactly_both_ways(jax_gpt):
    _, params, _ = jax_gpt
    model = _port_model(params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    back = to_jax_params(model)
    _assert_trees_close(back, params, atol=0, rtol=0)


def test_gpt_loss_and_grads_match_jax(force_pallas, jax_gpt):
    """Loss within 1e-5 and every gradient leaf within atol 1e-5 / rtol
    1e-4: f32 end to end, XLA and PyTorch sum the matmuls and the
    per-row reductions in different orders, and the differences grow
    through the layers and the backward."""
    jmodel, params, ids = jax_gpt
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_gpt_lm_loss(p, jmodel, jnp.asarray(ids))
    )(params)
    assert jax_dispatch.last_paths()["flash_attention"] == "pallas"
    model = _port_model(params)
    loss = gpt_lm_loss(model, torch.from_numpy(ids))
    loss.backward()
    assert _dispatch.last_paths()["flash_attention"] == "torch"
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), atol=1e-5,
                               rtol=1e-5)
    grads = to_jax_params(model, {n: p.grad for n, p in model.named_parameters()})
    _assert_trees_close(grads, grads_j, atol=1e-5, rtol=1e-4)


def test_remat_matches_no_remat(jax_gpt):
    """Full remat recomputes each block in the backward with the same
    arithmetic: the same loss and gradients to the last bit."""
    _, params, ids = jax_gpt
    out = []
    for remat in (False, True):
        model = _port_model(params, remat=remat)
        loss = gpt_lm_loss(model, torch.from_numpy(ids))
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["dots", "sums"])
def test_unported_remat_policies_raise(policy):
    cfg = GptConfig(**DIMS, dtype=torch.float32, remat=True,
                    remat_policy=policy)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GptModel(cfg, device="cpu")


def test_three_training_steps_match_jax(jax_gpt):
    """Three steps of gpt_lm_loss + Adam on both sides from the same
    weights and batches: each step's loss within 1e-5 and the weights
    after the third within 1e-5.  eps = 1e-3 keeps Adam's update a
    smooth function of the gradient, so an element whose f32 gradient
    is within rounding of zero cannot take a full ±lr step in opposite
    directions on the two sides."""
    jmodel, params, _ = jax_gpt
    rs = np.random.RandomState(8)
    batches = [rs.randint(0, DIMS["vocab_size"], size=(SEQ, BATCH)).astype(np.int32)
               for _ in range(3)]
    tx = jax_fused_adam(learning_rate=1e-2, eps=1e-3)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p_j)
    model = _port_model(params)
    opt = FusedAdam(model.parameters(), lr=1e-2, eps=1e-3)
    for ids in batches:
        loss_j, g = jax.value_and_grad(
            lambda p: jax_gpt_lm_loss(p, jmodel, jnp.asarray(ids))
        )(p_j)
        updates, state = tx.update(g, state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        loss = train_gpt.train_step(model, opt, torch.from_numpy(ids))
        np.testing.assert_allclose(float(loss), float(loss_j), atol=1e-5,
                                   rtol=1e-5)
    _assert_trees_close(to_jax_params(model), p_j, atol=1e-5, rtol=1e-5)


def test_example_trains_three_steps_on_cpu(tmp_path):
    corpus = port_data.synthetic_token_corpus(
        tmp_path / "corpus.bin", vocab_size=1024, num_tokens=20_000)
    losses = train_gpt.main([
        "--tiny", "--device", "cpu", "--steps", "3", "--batch", "2",
        "--seq-len", "32", "--lr", "1e-2", "--data", corpus,
    ])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("flag", [
    ["--tp", "2"], ["--context-parallel", "ring"], ["--num-experts", "4"],
    ["--sequence-parallel"],
])
def test_example_refuses_unported_parallelism(flag):
    with pytest.raises(NotImplementedError, match="not ported"):
        train_gpt.main(["--tiny", "--device", "cpu", *flag])

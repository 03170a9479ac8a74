"""apex_tpu_torch's remat policies and BertEncoderCore vs the JAX package.

- **Values**: a tiny f32 GPT (vocab 128, hidden 64, 2 layers, S 32, B 2)
  and a tiny f32 BERT (vocab 512, hidden 128, 2 layers, S 32, B 4, one
  all-padding row) under ``remat=True`` with each policy (``"full"``,
  ``"dots"``, ``"sums"``), and BERT's ``remat_attention``: the loss
  within 1e-5 and every gradient within atol 1e-5 / rtol 1e-4 of
  ``jax.value_and_grad`` under the same policy (XLA and PyTorch sum in
  other orders).  Within the port the policies give the same loss and
  gradients to the last bit, BERT with dropout too.
- **BertEncoderCore** (the stack of blocks): output and gradients
  against the JAX module's, within the same limits.
- **What each policy saves**: a ``TorchDispatchMode`` counts the aten
  ops the backward runs, recompute included.  The products of the
  backward itself are fixed (two a linear layer, two for the tied
  logits), so the products above them are the recompute's:
  * GPT, L layers: ``"full"`` and ``"sums"`` recompute 3 products a
    layer (QKV, the output projection and fc1: the checkpoint stops
    recomputing once the backward has all it needs, before fc2), and
    ``"dots"`` none; ``"sums"`` serves the 3 tagged sums on that path
    (QKV, the attention residual, fc1) from its cache, so it runs 3 adds
    a layer fewer than ``"full"``;
  * BERT (post-LN: the recompute runs to the block's end): ``"full"``
    and ``"sums"`` recompute 4 products a layer, ``"dots"`` none, and
    ``"sums"`` runs 4 adds a layer fewer than ``"full"``;
  * every policy recomputes the attention (2 batched products a layer
    on the CPU; K3 on the card), as XLA recomputes the attention kernel.
  A planted ``"dots"`` policy that saves nothing fails its count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.models.bert import BertEncoderCore as JaxBertEncoderCore
from apex_tpu.models.bert import BertForPreTraining as JaxBert
from apex_tpu.models.bert import bert_pretrain_loss as jax_bert_loss
from apex_tpu.models.gpt import GptConfig as JaxGptConfig
from apex_tpu.models.gpt import GptModel as JaxGptModel
from apex_tpu.models.gpt import gpt_lm_loss as jax_gpt_lm_loss
from apex_tpu.transformer.pipeline_parallel import schedules as jax_schedules
from apex_tpu_torch.models import (
    BertConfig,
    GptConfig,
    bert_from_jax_params,
    bert_pretrain_loss,
    bert_to_jax_params,
    from_jax_params,
    gpt_lm_loss,
    to_jax_params,
)
from apex_tpu_torch.models import bert as bert_lib
from apex_tpu_torch.models import gpt as gpt_lib
from apex_tpu_torch.models.bert import BertEncoderCore
from apex_tpu_torch.transformer.pipeline_parallel import schedules

GPT_DIMS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                intermediate_size=128, max_seq_len=64)
BERT_DIMS = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                 intermediate_size=256, max_position_embeddings=64)
SEQ = 32
LENGTHS = (32, 20, 7, 0)
TOL = dict(atol=1e-5, rtol=1e-4)
POLICIES = ("full", "dots", "sums")
L = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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
            **tol)


class _Count(TorchDispatchMode):
    """Counts aten ops by name."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_counts(loss):
    with _Count() as c:
        loss.backward()
    return {op: c.n.get(f"aten.{op}.default", 0)
            + c.n.get(f"aten.{op}.Tensor", 0) for op in ("mm", "bmm", "add")}


# ---------------------------------------------------------------------------
# GPT
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_gpt():
    jcfg = JaxGptConfig(**GPT_DIMS, dtype=jnp.float32)
    params = JaxGptModel(jcfg).init(jax.random.PRNGKey(0),
                                    jnp.zeros((SEQ, 2), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    ids = np.random.RandomState(7).randint(
        0, GPT_DIMS["vocab_size"], size=(SEQ, 2)).astype(np.int32)
    return jcfg, params, ids


def _gpt_step(params, ids, **over):
    cfg = GptConfig(**GPT_DIMS, dtype=torch.float32, **over)
    model = from_jax_params(params, cfg, device="cpu")
    loss = gpt_lm_loss(model, torch.from_numpy(ids))
    counts = _backward_counts(loss)
    grads = {n: p.grad for n, p in model.named_parameters()}
    return model, loss.detach(), grads, counts


@pytest.mark.parametrize("policy", POLICIES)
def test_gpt_loss_and_grads_match_jax_under_each_policy(jax_gpt, policy):
    jcfg, params, ids = jax_gpt
    jmodel = JaxGptModel(dataclasses.replace(jcfg, remat=True,
                                             remat_policy=policy))
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_gpt_lm_loss(p, jmodel, jnp.asarray(ids)))(params)
    model, loss, grads, _ = _gpt_step(params, ids, remat=True,
                                      remat_policy=policy)
    np.testing.assert_allclose(float(loss), float(loss_j), atol=1e-5,
                               rtol=1e-5)
    _assert_trees_close(to_jax_params(model, grads), grads_j, **TOL)


def _gpt_expected_mm(policy):
    backward = 8 * L + 2  # dX and dW of 4 linears a layer, tied logits
    return backward + {"full": 3 * L, "dots": 0, "sums": 3 * L,
                       None: 0}[policy]


def test_gpt_policies_are_bit_identical_and_save_what_they_say(jax_gpt):
    _, params, ids = jax_gpt
    _, loss0, grads0, plain = _gpt_step(params, ids)
    assert plain["mm"] == _gpt_expected_mm(None)
    counts = {}
    for policy in POLICIES:
        _, loss, grads, counts[policy] = _gpt_step(
            params, ids, remat=True, remat_policy=policy)
        assert torch.equal(loss, loss0), policy
        for name, g in grads.items():
            assert torch.equal(g, grads0[name]), (policy, name)
        assert counts[policy]["mm"] == _gpt_expected_mm(policy), (
            policy, counts[policy])
        # the attention's forward is recomputed under every policy
        assert counts[policy]["bmm"] == plain["bmm"] + 2 * L, policy
    assert counts["full"]["add"] - counts["sums"]["add"] == 3 * L


def _save_nothing(ctx, op, *args, **kwargs):
    return CheckpointPolicy.PREFER_RECOMPUTE


def test_planted_dots_policy_that_saves_nothing_fails_the_count(
        jax_gpt, monkeypatch):
    _, params, ids = jax_gpt
    real = schedules.resolve_remat_policy
    monkeypatch.setattr(
        gpt_lib, "resolve_remat_policy",
        lambda name: _save_nothing if name == "dots" else real(name))
    _, _, _, counts = _gpt_step(params, ids, remat=True, remat_policy="dots")
    assert counts["mm"] == _gpt_expected_mm("full")
    assert counts["mm"] != _gpt_expected_mm("dots")


def test_policy_resolution_matches_the_reference():
    assert schedules.SUMS_SAVE_NAMES == jax_schedules.SUMS_SAVE_NAMES
    for name in (None, "full"):
        assert schedules.resolve_remat_policy(name) is None
        assert jax_schedules.resolve_remat_policy(name) is None
    for name in ("dots", "sums"):
        assert callable(schedules.resolve_remat_policy(name))
    for mod in (schedules, jax_schedules):
        with pytest.raises(ValueError, match="unknown remat_policy"):
            mod.resolve_remat_policy("everything")
    with pytest.raises(ValueError, match="remat_policy"):
        GptConfig(remat_policy="everything")


def test_checkpoint_name_scopes_nest_and_reset():
    assert schedules._TAG.get() is None
    with schedules.checkpoint_name("gpt_qkv"):
        assert schedules._TAG.get() == "gpt_qkv"
        with schedules.checkpoint_name(None):
            assert schedules._TAG.get() is None
        assert schedules._TAG.get() == "gpt_qkv"
    assert schedules._TAG.get() is None


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_bert():
    jmodel = JaxBert(JaxBertConfig(**BERT_DIMS, dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((SEQ, 4),
                                                          jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    rs = np.random.RandomState(3)
    ids = rs.randint(0, BERT_DIMS["vocab_size"], size=(SEQ, 4)).astype(
        np.int32)
    batch = {
        "input_ids": ids,
        "token_type_ids": (rs.rand(SEQ, 4) < 0.5).astype(np.int32),
        "attention_mask": (np.arange(SEQ)[None] < np.array(LENGTHS)[:, None]
                           ).astype(np.int32),
        "mlm_labels": np.where(rs.rand(SEQ, 4) < 0.25, ids, -1).astype(
            np.int32),
        "nsp_labels": rs.randint(0, 2, size=(4,)).astype(np.int32),
    }
    return params, batch


def _bert_cfg(**over):
    return BertConfig(**BERT_DIMS, dtype=torch.float32, **over)


def _bert_step(params, batch, generator=None, **over):
    model = bert_from_jax_params(params, _bert_cfg(**over), device="cpu")
    loss = bert_pretrain_loss(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        deterministic=generator is None, generator=generator)
    counts = _backward_counts(loss)
    grads = {n: p.grad for n, p in model.named_parameters()}
    return model, loss.detach(), grads, counts


@pytest.mark.parametrize("policy,remat_attention", [
    ("full", False), ("dots", False), ("sums", False), ("sums", True),
])
def test_bert_loss_and_grads_match_jax_under_each_policy(
        jax_bert, policy, remat_attention):
    params, batch = jax_bert
    over = dict(remat=True, remat_policy=policy,
                remat_attention=remat_attention)
    jmodel = JaxBert(JaxBertConfig(**BERT_DIMS, dtype=jnp.float32, **over))
    loss_j, grads_j = jax.value_and_grad(lambda p: jax_bert_loss(
        p, jmodel, {k: jnp.asarray(v) for k, v in batch.items()}))(params)
    model, loss, grads, _ = _bert_step(params, batch, **over)
    np.testing.assert_allclose(float(loss), float(loss_j), atol=1e-5,
                               rtol=1e-5)
    _assert_trees_close(bert_to_jax_params(model, grads), grads_j, **TOL)


def _bert_expected_mm(policy):
    # 4 linears a layer; pooler, NSP head, MLM transform; tied decoder
    backward = 8 * L + 6 + 2
    return backward + {"full": 4 * L, "dots": 0, "sums": 4 * L,
                       None: 0}[policy]


@pytest.mark.parametrize("dropout", [False, True])
def test_bert_policies_are_bit_identical_and_save_what_they_say(
        jax_bert, dropout):
    params, batch = jax_bert

    def gen():
        return torch.Generator().manual_seed(11) if dropout else None

    _, loss0, grads0, plain = _bert_step(params, batch, gen())
    assert plain["mm"] == _bert_expected_mm(None)
    counts = {}
    for policy, ra in (("full", False), ("dots", False), ("sums", False),
                       ("sums", True), ("full", True)):
        _, loss, grads, c = _bert_step(params, batch, gen(), remat=True,
                                       remat_policy=policy,
                                       remat_attention=ra)
        counts[policy, ra] = c
        assert torch.equal(loss, loss0), (policy, ra)
        for name, g in grads.items():
            assert torch.equal(g, grads0[name]), (policy, ra, name)
        assert c["mm"] == _bert_expected_mm(policy), (policy, ra, c)
        # the attention is recomputed once, with or without the inner
        # checkpoint: a checkpointed block recomputes it anyway
        assert c["bmm"] == plain["bmm"] + 2 * L, (policy, ra)
    assert counts["full", False]["add"] - counts["sums", False]["add"] == 4 * L


def test_remat_attention_alone_recomputes_only_the_attention(jax_bert):
    """Without the block checkpoint, ``remat_attention`` recomputes the
    attention core (2 more batched products a layer) and nothing else,
    with the same values."""
    params, batch = jax_bert
    _, loss0, grads0, plain = _bert_step(params, batch)
    _, loss, grads, c = _bert_step(params, batch, remat_attention=True)
    assert torch.equal(loss, loss0)
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name
    assert c["bmm"] == plain["bmm"] + 2 * L
    assert c["mm"] == plain["mm"]


def test_remat_prevent_cse_is_validated():
    for ok in (None, True, False):
        _bert_cfg(remat_prevent_cse=ok)
    with pytest.raises(ValueError, match="remat_prevent_cse"):
        _bert_cfg(remat_prevent_cse="auto")


@pytest.mark.parametrize("policy", POLICIES)
def test_bert_encoder_core_matches_jax(jax_bert, policy):
    """The stack alone: the JAX ``BertEncoderCore`` with the BERT tree's
    encoder weights against the port's on the same hidden states and
    padding bias — output and the gradients of the input and of every
    weight under a fixed cotangent."""
    params, _ = jax_bert
    over = dict(remat=True, remat_policy=policy)
    jcfg = JaxBertConfig(**BERT_DIMS, dtype=jnp.float32, **over)
    enc_params = {"params": params["params"]["bert"]["encoder"]}
    rs = np.random.RandomState(5)
    x = rs.randn(SEQ, 4, BERT_DIMS["hidden_size"]).astype(np.float32)
    keep = np.arange(SEQ)[None] < np.array(LENGTHS)[:, None]
    bias = np.where(keep, 0.0, -1e9)[:, None, None, :].astype(np.float32)
    ct = rs.randn(*x.shape).astype(np.float32)
    core = JaxBertEncoderCore(jcfg, BERT_DIMS["num_layers"])

    def f(p, xx):
        return jnp.sum(core.apply(p, xx, jnp.asarray(bias)) * ct)

    y_j = core.apply(enc_params, jnp.asarray(x), jnp.asarray(bias))
    (gp_j, gx_j) = jax.grad(f, argnums=(0, 1))(enc_params, jnp.asarray(x))

    model = bert_from_jax_params(params, _bert_cfg(**over), device="cpu")
    enc = model.bert.encoder
    assert isinstance(enc, BertEncoderCore)
    assert len(enc.layers) == BERT_DIMS["num_layers"]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = enc(xt, torch.from_numpy(bias))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    (y * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **TOL)
    grads = bert_to_jax_params(model, {
        n: (p.grad if p.grad is not None else torch.zeros_like(p))
        for n, p in model.named_parameters()})
    _assert_trees_close(grads["params"]["bert"]["encoder"],
                        gp_j["params"], **TOL)


def test_bert_encoder_core_stands_alone():
    """A stage-sized stack (1 layer of a 2-layer config) built on its
    own, its dropout seeds drawn from a CPU generator: two runs from one
    generator state give the same output, and a GPU generator raises."""
    cfg = _bert_cfg(remat=True, remat_policy="sums")
    torch.manual_seed(0)
    core = BertEncoderCore(cfg, 1)
    x = torch.randn(8, 2, BERT_DIMS["hidden_size"])
    outs = [core(x, deterministic=False,
                 generator=torch.Generator().manual_seed(4))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], core(x))
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        core(x, deterministic=False)
    assert bert_lib.SUMS_SAVE_NAMES == schedules.SUMS_SAVE_NAMES

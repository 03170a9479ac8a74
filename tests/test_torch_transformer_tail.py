"""The rest of apex_tpu_torch's transformer package and its utils
against the JAX package.

- ``transformer.log_util``: the logger names and the level set on the
  subsystem, re-exported from ``transformer`` as the reference does;
- ``transformer.layers``: the selector's names (``FastLayerNorm`` is
  ``FusedLayerNorm``), holding the reference's outputs;
- ``transformer.testing``: ``TEST_CONFIG`` equal to the reference's
  (dtypes aside); ``gpt_model_provider()`` and ``bert_model_provider()``
  with the JAX providers' initialized weights carried across give the
  JAX providers' GPT logits and BERT MLM hidden states and NSP logits
  within ``TOL``; ``set_random_seed``, ``print_separator``,
  ``IdentityLayer``, ``initialize_distributed`` and ``cpu_mesh`` (a
  one-process gloo world, torn down on exit);
- ``utils`` and ``utils.profiling``: the tracing hooks of
  ``observability.trace``, under the reference's five names.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import apex_tpu.transformer as jtr
import apex_tpu.transformer.layers as jlayers
import apex_tpu.transformer.testing as jtesting
import apex_tpu.utils as jutils
import apex_tpu_torch.transformer as ptr
import apex_tpu_torch.transformer.layers as players
import apex_tpu_torch.transformer.testing as ptesting
import apex_tpu_torch.utils as putils
from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.models import bert_from_jax_params, from_jax_params
from apex_tpu_torch.observability import trace as ptrace
from apex_tpu_torch.transformer.testing import standalone_bert as pbert
from apex_tpu_torch.transformer.testing import standalone_gpt as pgpt

TOL = dict(atol=1e-5, rtol=1e-5)
SEQ, BATCH = 16, 2


def test_log_util_matches_reference():
    assert ptr.get_transformer_logger is ptr.log_util.get_transformer_logger
    assert ptr.set_logging_level is ptr.log_util.set_logging_level
    for name in ("apex_tpu_torch.transformer", "pipeline", "x.y"):
        got = ptr.get_transformer_logger(name).name
        ref = jtr.get_transformer_logger(
            name.replace("apex_tpu_torch", "apex_tpu")).name
        assert got == ref.replace("apex_tpu.", "apex_tpu_torch.", 1)
    base = logging.getLogger("apex_tpu_torch.transformer")
    level = base.level
    try:
        ptr.set_logging_level("DEBUG")
        assert base.level == logging.DEBUG
        ptr.set_logging_level(logging.WARNING)
        assert base.level == logging.WARNING
        assert ptr.get_transformer_logger("p").getEffectiveLevel() == \
            logging.WARNING
    finally:
        base.setLevel(level)


def test_layers_selector_names():
    from apex_tpu_torch import normalization as pnorm

    for name in ("FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
                 "MixedFusedRMSNorm", "FastLayerNorm"):
        assert hasattr(jlayers, name) and hasattr(players, name)
    assert players.FastLayerNorm is pnorm.FusedLayerNorm
    assert players.FusedRMSNorm is pnorm.FusedRMSNorm
    x = np.random.RandomState(0).randn(4, 32).astype(np.float32)
    jm = jlayers.FastLayerNorm(32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    got = players.FastLayerNorm(32, device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("mod", [(pgpt, jtesting.standalone_gpt),
                                 (pbert, jtesting.standalone_bert)],
                         ids=["gpt", "bert"])
def test_test_configs_are_the_references(mod):
    port, ref = mod
    assert set(port.TEST_CONFIG) == set(ref.TEST_CONFIG)
    for k, v in ref.TEST_CONFIG.items():
        if k == "dtype":
            assert port.TEST_CONFIG[k] == torch.float32 == torch.float32
            assert v == jnp.float32
        else:
            assert port.TEST_CONFIG[k] == v, k


def _ids(vocab, seed=0):
    return np.random.RandomState(seed).randint(
        0, vocab, size=(SEQ, BATCH)).astype(np.int32)


def test_gpt_provider_logits_match_jax():
    jm = jtesting.gpt_model_provider()
    ids = _ids(jm.cfg.vocab_size)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    logits_j = jm.apply(params, jnp.asarray(ids))
    pm = ptesting.gpt_model_provider(device="cpu")
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                            pm.cfg, device="cpu")
    assert type(model) is type(pm) and model.cfg == pm.cfg
    with torch.no_grad():
        logits = model(torch.from_numpy(ids.astype(np.int64)))
    assert logits.shape == tuple(logits_j.shape)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)


def test_bert_provider_outputs_match_jax():
    jm = jtesting.bert_model_provider()
    ids = _ids(jm.cfg.vocab_size, 1)
    types = np.zeros_like(ids)
    mask = np.ones((BATCH, SEQ), np.int32)  # (B, S), as the models take it
    mask[1, -3:] = 0
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(ids),
                     jnp.asarray(types), jnp.asarray(mask))
    (h_j, bias_j), nsp_j = jm.apply(params, jnp.asarray(ids),
                                    jnp.asarray(types), jnp.asarray(mask))
    pm = ptesting.bert_model_provider(device="cpu")
    model = bert_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                 pm.cfg, device="cpu")
    assert type(model) is type(pm)
    with torch.no_grad():
        (h, bias), nsp = model(*(torch.from_numpy(a.astype(np.int64))
                                 for a in (ids, types, mask)))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **TOL)
    np.testing.assert_allclose(nsp.numpy(), np.asarray(nsp_j), **TOL)
    np.testing.assert_array_equal(bias.detach().numpy(), np.asarray(bias_j))


def test_providers_take_overrides():
    m = ptesting.gpt_model_provider(device="cpu", num_layers=1, remat=True)
    assert m.cfg.num_layers == 1 and m.cfg.remat
    b = ptesting.bert_model_provider(device="cpu", num_layers=2)
    assert b.cfg.num_layers == 2 and b.cfg.hidden_size == 64


def test_commons(capsys):
    g = ptesting.set_random_seed(5)
    a = np.random.rand()
    np.random.seed(5)
    assert a == np.random.rand()
    assert torch.equal(torch.randn(3, generator=g),
                       torch.randn(3, generator=torch.Generator()
                                   .manual_seed(5)))
    ptesting.print_separator("hello")
    jtesting.print_separator("hello")
    out = capsys.readouterr().out.split("\n\n")
    assert out[0] + "\n" == "\n" + out[1] or out[0] == out[1].lstrip("\n")
    layer = ptesting.IdentityLayer((3, 4), scale=2.0, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    w = layer()
    assert w is layer.weight and w.shape == (3, 4) and w.requires_grad
    assert torch.equal(w.detach(), 2.0 * torch.randn(
        3, 4, generator=torch.Generator().manual_seed(0)))


def test_cpu_mesh_builds_and_tears_down_a_world():
    assert not dist.is_initialized()
    with ptesting.cpu_mesh() as mesh:
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert ps.model_parallel_is_initialized()
        assert mesh.shape == {"dp": 1, "pp": 1, "cp": 1, "tp": 1}
        again = ptesting.initialize_distributed()
        assert again.shape == mesh.shape
    assert not dist.is_initialized()
    assert not ps.model_parallel_is_initialized()
    with pytest.raises(ValueError):
        with ptesting.cpu_mesh(tensor_model_parallel_size=2):
            pass
    assert not dist.is_initialized()


@pytest.mark.parametrize("mod", ["utils", "utils.profiling"])
def test_utils_reexport_the_tracing_hooks(mod):
    import importlib

    port = importlib.import_module(f"apex_tpu_torch.{mod}")
    ref = importlib.import_module(f"apex_tpu.{mod}")
    assert list(port.__all__) == list(ref.__all__)
    for name in port.__all__:
        assert getattr(port, name) is getattr(ptrace, name)
    assert putils.trace is ptrace.trace and jutils.trace is not None

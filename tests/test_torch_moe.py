"""apex_tpu_torch's Switch MoE vs the JAX package.

The sharded runs are spawned gloo processes (one spawn per world, ep =
dp = 2 and 4; ``torch_dist_workers.moe_case`` and ``moe_stats_case``),
held to the JAX package under ``shard_map`` over a dp (or cp) mesh of
the same size, on the same seeded inputs (S 4, B 2 a rank, H 16, F 32,
E 8, f32; weights 0.1–0.5 · N(0, 1) from numpy, carried across):

- ``moe_dispatch_combine`` at top-1 and top-2, with a capacity that
  drops tokens and one that does not: the dispatch and combine tensors,
  the aux loss, and the gradient of ``aux + Σ combine·w`` w.r.t. the
  router logits; with the statistics averaged over cp = 2 and 4 at
  gradient scale 1 and 1/n against JAX's ``pmean`` under ``shard_map``;
- ``SwitchMoe`` at ep 1 in process, and at ep 2 and 4: each rank's
  output, aux loss and gradients of ``mean(y²) + 0.01 aux``, before and
  after ``sync_moe_gradients``, against JAX's; the all-to-alls in the
  call log;
- the ep-invariant init: global expert e gets the same weights at ep 1,
  2 and 4;
- a GPT with experts from JAX weights (``from_jax_params``): the loss
  (the aux term included) and every gradient against
  ``jax.value_and_grad(gpt_lm_loss)``; the converter's round trip;
- the example, ``train_gpt --tiny --num-experts 4`` at world 2 (ep = dp
  = 2; ``build`` and ``train_step``), against its objective at ep = 1 in
  this process: the mean of ``gpt_lm_loss`` over the two half batches,
  step 0's gradients (the expert shards against their experts) and 3
  losses.

Tolerance: ``TOL`` 1e-5 relative to the largest |value| (f32 on the CPU,
sums in other orders; the reference's MoE tests use 1e-5); the sharded
parameter gradients ``GRAD_TOL`` 1e-4 of the largest |value| (the
router's gradient under top-2 sums terms of ~1e-3 in another order
over ranks: 4e-8 apart at ep 4); the example's step-0 gradients
``GRAD_TOL`` and its losses 2e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import apex_tpu.transformer.moe as jmoe
import apex_tpu_torch.transformer.moe as tmoe
import torch_dist_workers as workers
from apex_tpu import parallel_state as jps
from apex_tpu_torch import data as port_data
from apex_tpu.models import gpt as jgpt
from apex_tpu_torch.models import convert
from apex_tpu_torch.models import gpt as tgpt

S, B_LOCAL, H, F, E = 4, 2, 16, 32, 8
TOL = 1e-5
GRAD_TOL = 1e-4
WORLDS = (2, 4)
MOE_KW = dict(hidden_size=H, ffn_hidden_size=F, num_experts=E)


@pytest.fixture(autouse=True)
def _destroy_port_parallel_state():
    """Leave no port ``parallel_state`` behind (an example's ``main``
    leaves it initialized) for the next test or the next file in this
    worker."""
    yield from workers.port_state_guard()


def _weights():
    rs = np.random.RandomState(11)
    return ((rs.randn(H, E) * 0.5).astype(np.float32),
            (rs.randn(E, H, F) * 0.25).astype(np.float32),
            (rs.randn(E, F, H) * 0.2).astype(np.float32))


def _x(world):
    return np.random.RandomState(12).randn(
        S, B_LOCAL * world, H).astype(np.float32)


def _logits(t=16):
    return (np.random.RandomState(13).randn(t, E) * 2).astype(np.float32)


def _close(got, want, what="", tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=tol, atol=tol * max(float(np.abs(want).max()), 1e-6),
        err_msg=what)


#: the example's tiny f32 configuration (vocab 1024, hidden 64, 2
#: layers, 4 heads) with 4 experts, a global (32, 4) batch
TRAIN_ARGV = ["--tiny", "--device", "cpu", "--steps", "3", "--batch", "4",
              "--seq-len", "32", "--lr", "1e-2", "--num-experts", "4"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return str(port_data.synthetic_token_corpus(
        tmp_path_factory.mktemp("moe_corpus") / "corpus.bin",
        vocab_size=1024, num_tokens=20_000))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, corpus):
    tmp = tmp_path_factory.mktemp("moe_runs")
    router, w1, w2 = _weights()
    out = {}
    for world in WORLDS:
        jobs = [(f"top{k}", "moe_case", dict(
            router=router, w1=w1, w2=w2, x=_x(world),
            cfg_kwargs=dict(MOE_KW, top_k=k), with_sync=True))
            for k in (1, 2)]
        jobs.append(("stats", "moe_stats_case", dict(
            logits=_logits(8 * world), top_k=2, capacity=3,
            scales=(1.0, None))))
        if world == 2:
            jobs.append(("train_gpt", "train_gpt_case", dict(
                argv=[*TRAIN_ARGV, "--data", corpus])))
        out[world] = workers.spawn(world, jobs, tmp, timeout=180.0)
    return out


# ---------------------------------------------------------------------------
# dispatch / combine
# ---------------------------------------------------------------------------


def _jax_dispatch(logits, top_k, capacity):
    def f(lg):
        d, c, aux = jmoe.moe_dispatch_combine(
            jax.nn.softmax(lg, axis=-1), top_k, capacity)
        w = jnp.arange(c.size, dtype=jnp.float32).reshape(c.shape) / c.size
        return aux + jnp.sum(c * w), (d, c, aux)

    (_, (d, c, aux)), g = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(logits))
    return np.asarray(d), np.asarray(c), float(aux), np.asarray(g)


@pytest.mark.parametrize("capacity", [2, 6])
@pytest.mark.parametrize("top_k", [1, 2])
def test_dispatch_combine_matches_jax(top_k, capacity):
    logits = _logits()
    d, c, aux, g = _jax_dispatch(logits, top_k, capacity)
    lg = torch.from_numpy(logits).requires_grad_(True)
    td, tc, taux = tmoe.moe_dispatch_combine(torch.softmax(lg, -1), top_k,
                                             capacity)
    w = torch.arange(tc.numel(), dtype=torch.float32).reshape(
        tc.shape) / tc.numel()
    (tg,) = torch.autograd.grad(taux + (tc * w).sum(), lg)
    np.testing.assert_array_equal(td.detach().numpy(), d)
    _close(tc.detach().numpy(), c, "combine")
    assert float(taux.detach()) == pytest.approx(aux, rel=1e-6)
    _close(tg.numpy(), g, "grad")
    if capacity == 2:
        # the capacity really drops tokens (a routed token with no slot)
        assert td.sum() < top_k * logits.shape[0]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("scale", [1.0, None])
def test_dispatch_stats_axis_matches_jax(world, scale, runs):
    """Aux statistics averaged over cp (``pmean``) and the gradient
    scale, against JAX under shard_map, rank for rank."""
    logits = _logits(8 * world)
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(context_parallel_size=world,
                                         devices=jax.devices()[:world])

    def f(lg):
        def inner(lg):
            d, c, aux = jmoe.moe_dispatch_combine(
                jax.nn.softmax(lg, axis=-1), 2, 3, stats_axis="cp",
                stats_grad_scale=scale)
            w = jnp.arange(c.size, dtype=jnp.float32).reshape(c.shape) \
                / c.size
            return aux + jnp.sum(c * w), (d, c, aux)

        (_, (d, c, aux)), g = jax.value_and_grad(inner, has_aux=True)(lg)
        return aux[None], d[None], c[None], g[None]

    try:
        aux, d, c, g = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P("cp"),), out_specs=(P("cp"),) * 4,
            check_vma=False))(jnp.asarray(logits))
    finally:
        jps.destroy_model_parallel()
    for r in range(world):
        t_aux, t_d, t_c, t_g = runs[world][r]["stats"][scale]
        assert t_aux == pytest.approx(float(aux[r]), rel=1e-6)
        np.testing.assert_array_equal(t_d, np.asarray(d[r]))
        _close(t_c, c[r], "combine")
        _close(t_g, g[r], f"grad rank {r}")


# ---------------------------------------------------------------------------
# SwitchMoe
# ---------------------------------------------------------------------------


def _jax_params(router, w1, w2):
    return {"params": {"router": jnp.asarray(router),
                       "expert_w1": jnp.asarray(w1),
                       "expert_w2": jnp.asarray(w2)}}


def _local_loss(m, p, x):
    y, aux = m.apply(p, x)
    return jnp.mean(y ** 2) + 0.01 * aux, (y, aux)


@pytest.mark.parametrize("top_k", [1, 2])
def test_switch_moe_ep1_matches_jax(top_k):
    router, w1, w2 = _weights()
    x = _x(1)
    jm = jmoe.SwitchMoe(jmoe.MoeConfig(**MOE_KW, top_k=top_k,
                                       dtype=jnp.float32, expert_axis=None))
    (_, (y, aux)), g = jax.value_and_grad(
        lambda p: _local_loss(jm, p, jnp.asarray(x)), has_aux=True)(
        _jax_params(router, w1, w2))
    tm = tmoe.SwitchMoe(tmoe.MoeConfig(**MOE_KW, top_k=top_k,
                                       dtype=torch.float32,
                                       expert_axis=None), device="cpu")
    with torch.no_grad():
        for name, a in zip(("router", "expert_w1", "expert_w2"),
                           (router, w1, w2)):
            getattr(tm, name).copy_(torch.from_numpy(a))
    ty, taux = tm(torch.from_numpy(x))
    (torch.mean(ty ** 2) + 0.01 * taux).backward()
    _close(ty.detach().numpy(), y, "y")
    assert float(taux) == pytest.approx(float(aux), rel=1e-6)
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), g["params"][name], name)


def _jax_ep(world, top_k):
    router, w1, w2 = _weights()
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(devices=jax.devices()[:world])
    jm = jmoe.SwitchMoe(jmoe.MoeConfig(**MOE_KW, top_k=top_k,
                                       dtype=jnp.float32, expert_axis="dp"))
    specs = {"params": {"router": P(), "expert_w1": P("dp"),
                        "expert_w2": P("dp")}}

    def f(p, x):
        (_, (y, aux)), g = jax.value_and_grad(
            lambda p: _local_loss(jm, p, x), has_aux=True)(p)
        synced = jmoe.sync_moe_gradients(g)
        stack = lambda t: jax.tree.map(lambda a: a[None], t)  # noqa: E731
        return y, aux[None], stack(g), stack(synced)

    try:
        y, aux, g, synced = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(specs, P(None, "dp")),
            out_specs=(P(None, "dp"), P("dp"), P("dp"), P("dp")),
            check_vma=False))(_jax_params(router, w1, w2),
                              jnp.asarray(_x(world)))
    finally:
        jps.destroy_model_parallel()
    return np.asarray(y), np.asarray(aux), g["params"], synced["params"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("top_k", [1, 2])
def test_switch_moe_ep_matches_jax(world, top_k, runs):
    y, aux, g, synced = _jax_ep(world, top_k)
    for r in range(world):
        got = runs[world][r][f"top{top_k}"]
        _close(got["y"], y[:, r * B_LOCAL:(r + 1) * B_LOCAL], f"y rank {r}")
        assert got["aux"] == pytest.approx(float(aux[r]), rel=1e-6)
        for name in ("router", "expert_w1", "expert_w2"):
            _close(got["raw"][name], np.asarray(g[name])[r],
                   f"{name} rank {r}", GRAD_TOL)
            _close(got["synced"][name], np.asarray(synced[name])[r],
                   f"synced {name} rank {r}", GRAD_TOL)
        # the dispatch and the return over dp, and the return's
        # backward (x takes no gradient here, so the dispatch's backward
        # has nothing to carry)
        assert got["log"]["all-to-all"]["count"] == 3


@pytest.mark.parametrize("world", WORLDS)
def test_synced_grads_are_the_global_objective(world, runs):
    """After ``sync_moe_gradients`` the router's gradient is the same on
    every rank and the expert shards hold 1/ep of their sum: the mean
    objective's gradient (each rank's experts saw every rank's tokens)."""
    got = [runs[world][r]["top1"]["synced"] for r in range(world)]
    for r in range(1, world):
        np.testing.assert_array_equal(got[r]["router"], got[0]["router"])
    raw = [runs[world][r]["top1"]["raw"] for r in range(world)]
    for r in range(world):
        _close(got[r]["expert_w1"], raw[r]["expert_w1"] / world)


@pytest.mark.parametrize("world", WORLDS)
def test_expert_init_is_ep_invariant(world, runs):
    ref = tmoe.SwitchMoe(tmoe.MoeConfig(**MOE_KW, dtype=torch.float32),
                         device="cpu")
    e_l = E // world
    for r in range(world):
        seeded = runs[world][r]["top1"]["seeded"]
        np.testing.assert_array_equal(seeded["router"],
                                      ref.router.detach().numpy())
        for name in ("expert_w1", "expert_w2"):
            np.testing.assert_array_equal(
                seeded[name],
                getattr(ref, name).detach().numpy()[r * e_l:(r + 1) * e_l])


def test_moe_refusals_match_jax():
    for mod, dt in ((jmoe, jnp.float32), (tmoe, torch.float32)):
        with pytest.raises(ValueError, match="top_k must be 1 or 2"):
            mod.MoeConfig(**MOE_KW, top_k=3, dtype=dt)
        with pytest.raises(ValueError, match="mutually exclusive"):
            mod.MoeConfig(**MOE_KW, dtype=dt, sequence_parallel=True,
                          context_parallel=True)


# ---------------------------------------------------------------------------
# a GPT with experts
# ---------------------------------------------------------------------------

GPT_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_seq_len=16, num_experts=4)


@pytest.mark.parametrize("top_k", [1, 2])
def test_gpt_with_experts_matches_jax(top_k):
    cfg_j = jgpt.GptConfig(**GPT_KW, moe_top_k=top_k, dtype=jnp.float32)
    m = jgpt.GptModel(cfg_j)
    ids = np.random.RandomState(3).randint(0, 64, (16, 2))
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32))
    rs = np.random.RandomState(9)
    params = {"params": jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rs.randn(*a.shape)).astype(
            np.float32), params["params"])}
    loss, grads = jax.value_and_grad(
        lambda p: jgpt.gpt_lm_loss(p, m, jnp.asarray(ids, jnp.int32)))(
        jax.tree.map(jnp.asarray, params))
    cfg_t = tgpt.GptConfig(**GPT_KW, moe_top_k=top_k, dtype=torch.float32)
    model = convert.from_jax_params(params, cfg_t, device="cpu")
    back = convert.to_jax_params(model)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    tloss = tgpt.gpt_lm_loss(model, torch.from_numpy(ids))
    tloss.backward()
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)
    got = convert.to_jax_params(
        model, {n: p.grad for n, p in model.named_parameters()})
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    for path, leaf in flat:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, np.asarray(leaf), rtol=2e-4,
                                   atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    # the aux term is in the loss: dropping it moves the value
    h, auxes = model.forward_with_aux(torch.from_numpy(ids))
    assert len(auxes) == 2 and all(float(a) > 0 for a in auxes)


def test_gpt_experts_refuse_an_indivisible_ep():
    """num_experts must divide over the ep (= dp) ranks, as in JAX."""
    from apex_tpu_torch import parallel_state as tps

    tps.destroy_model_parallel()
    cfg = tgpt.GptConfig(**dict(GPT_KW, num_experts=3), dtype=torch.float32)
    state = tps._STATE
    try:
        tps._STATE = tps._ParallelState(mesh=tps.ProcessMesh(
            shape={"dp": 2, "pp": 1, "cp": 1, "tp": 1},
            coords={"dp": 0, "pp": 0, "cp": 0, "tp": 0},
            ranks={}, groups={"dp": None, "pp": None, "cp": None,
                              "tp": None}))
        with pytest.raises(ValueError, match="must be divisible by the "
                           "expert axis size"):
            tgpt.GptModel(cfg, device="cpu")
    finally:
        tps._STATE = state


def _train_gpt_ep1(argv):
    """The example's ep = 2 objective at ep = 1 in this process: its
    model (seed 0) and global batches, each step the mean of
    ``gpt_lm_loss`` over the two dp halves of the batch, FusedAdam.
    Returns the losses and step 0's gradients."""
    from apex_tpu_torch import parallel_state as tps
    from apex_tpu_torch.examples import train_gpt

    try:
        args = train_gpt.parse_args(argv)
        _, model, opt, batches, _ = train_gpt.build(args)
        losses, grads0 = [], None
        for _ in range(args.steps):
            ids = next(batches)
            half = ids.shape[1] // 2
            total = 0.0
            for part in (ids[:, :half], ids[:, half:]):
                loss = tgpt.gpt_lm_loss(model, part) * 0.5
                loss.backward()
                total += float(loss.detach())
            if grads0 is None:
                grads0 = {n: p.grad.detach().numpy().copy()
                          for n, p in model.named_parameters()}
            opt.step()
            opt.zero_grad(set_to_none=True)
            losses.append(total)
        return losses, grads0
    finally:
        tps.destroy_model_parallel()


def test_train_gpt_with_experts_at_ep2_equals_its_ep1_objective(runs,
                                                                corpus):
    """``build`` at world 2 makes dp = ep = 2 with no DDP, each rank
    holding 2 of the 4 experts and its 2 batch columns; ``train_step``
    syncs through ``sync_moe_gradients`` (the dense leaves averaged over
    dp, the expert leaves scaled by 1/ep) and reports the dp-mean loss.
    That is the ep = 1 gradient of the mean over the two half batches."""
    losses, grads0 = _train_gpt_ep1([*TRAIN_ARGV, "--data", corpus])
    for r in range(2):
        got = runs[2][r]["train_gpt"]
        assert got["mesh"]["dp"] == 2 and not got["ddp"]
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
        for name, want in grads0.items():
            if ".expert_" in name:
                want = want[2 * r:2 * r + 2]
            _close(got["grads0"][name], want, f"rank {r} {name}",
                   tol=GRAD_TOL)

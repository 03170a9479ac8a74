"""apex_tpu_torch's context parallelism vs the JAX package.

The port runs in spawned gloo processes (one spawn per world, cp = 2
and 4; ``torch_dist_workers.cp_case`` and ``gpt_cp_case``), the JAX
package under ``shard_map`` over a cp mesh of the same size, on the same
seeded inputs (q, k, v (B, H, S, D) = (2, 4, 32, 16) global, N(0, 1)
from numpy; a (B, 1, 1, S) key-padding mask of 0 / -1e9 with each row's
first key kept):

- ``ring_attention`` (contiguous, causal and not; zigzag), and
  ``ulysses_attention``, with and without the key-padding bias: each
  rank's output and its q/k/v gradients for the cotangent ``2 · out``
  against ``jax.vjp`` of the JAX function, rank for rank; the call log
  (world − 1 rotations a ring, all-to-alls for Ulysses);
- the planted fault — the hops' backward fed no lse cotangent — keeps
  the output and must fail the gradient comparison;
- dropout (cp 4, p = 0.25): the ring equals attention under the
  block-assembled keep mask (each (q-rank, kv-source) block the
  kernels' mask under ``fold_seed(seed, rank·cp + src)``, ``·4 + pair``
  under zigzag), in outputs and gradients — the reference's own test's
  form; the JAX bits differ (``jax.random``), so this golden is the
  port's;
- ``zigzag_shard``/``split``/``merge`` against JAX, and every probe's
  message;
- GPT under cp 2 in all three modes from JAX weights carried across:
  ``gpt_lm_loss_cp``, each rank's gradients as JAX's ``shard_map`` has
  them, and their cp mean against JAX's and the unsharded
  ``gpt_lm_loss``'s gradients;
- the example, ``train_gpt --tiny --context-parallel MODE --cp 2`` at
  world 2 (``build`` and ``train_step``), against the same example at
  world 1 in this process: step 0's gradients as ``train_step`` hands
  them to the optimizer, and 3 losses; ``check_args``' zigzag refusal.

Tolerances: ``TOL`` (2e-5 of the largest |value|, the reference's 2e-5)
for outputs and gradients without dropout; the dropout golden as the
reference's dropout test (outputs 2e-5; gradients rtol 1e-3, atol 5e-4);
GPT as the reference's cp model test (rtol 2e-4, atol 1e-5); the
example against itself at world 1 ``TOL`` for the gradients and 2e-5
relative for the losses (they read 6e-7 and 1.4e-7).  The example's
parameters after its Adam steps are not compared: Adam's first update
is the sign of each gradient, so a gradient within rounding of zero
moves its weight by up to 2·lr either way (the losses read the updates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import apex_tpu.transformer.context_parallel as jcp
import apex_tpu_torch.transformer.context_parallel as tcp
import torch_dist_workers as workers
from apex_tpu import parallel_state as jps
from apex_tpu.models import gpt as jgpt
from apex_tpu_torch import data as port_data
from apex_tpu_torch.examples import train_gpt
from apex_tpu_torch.ops.attention import dropout_keep_mask

B, H, S, D = 2, 4, 32, 16
TOL = 2e-5
WORLDS = (2, 4)
SEED = 1234
DROP_P = 0.25

#: name -> (kind, kwargs)
CASES = {
    "ring": ("ring", dict(causal=False)),
    "ring_causal": ("ring", dict(causal=True)),
    "ring_bias": ("ring", dict(causal=False, bias=True)),
    "ring_causal_bias": ("ring", dict(causal=True, bias=True)),
    "zigzag": ("zigzag", dict(causal=True)),
    "zigzag_bias": ("zigzag", dict(causal=True, bias=True)),
    "ulysses": ("ulysses", dict(causal=False)),
    "ulysses_causal": ("ulysses", dict(causal=True)),
    "ulysses_bias": ("ulysses", dict(causal=True, bias=True)),
}
FAULTS = {"ring_causal_dlse": ("ring", dict(causal=True, fault="dlse")),
          "zigzag_dlse": ("zigzag", dict(causal=True, fault="dlse"))}
DROPOUT = {"ring_drop": ("ring", dict(causal=False, dropout_p=DROP_P)),
           "ring_causal_drop": ("ring", dict(causal=True,
                                             dropout_p=DROP_P)),
           "zigzag_drop": ("zigzag", dict(causal=True, dropout_p=DROP_P))}

GPT_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_seq_len=16)
GPT_S, GPT_B = 16, 2
MODES = ("ring", "ring_zigzag", "ulysses")
GPT_TOL = dict(rtol=2e-4, atol=1e-5)
#: the example's tiny f32 configuration (vocab 1024, hidden 64, 2
#: layers, 4 heads), a global (32, 2) batch
TRAIN_ARGV = ["--tiny", "--device", "cpu", "--steps", "3", "--batch", "2",
              "--seq-len", "32", "--lr", "1e-2"]
TRAIN_LOSS_RTOL = 2e-5


def _qkv():
    rs = np.random.RandomState(0)
    return [rs.randn(B, H, S, D).astype(np.float32) for _ in range(3)]


def _bias():
    rs = np.random.RandomState(1)
    keep = rs.rand(B, 1, 1, S) < 0.7
    keep[..., 0] = True
    return np.where(keep, 0.0, -1e9).astype(np.float32)


def _gpt_params():
    m = jgpt.GptModel(jgpt.GptConfig(**GPT_KW, dtype=jnp.float32))
    tree = m.init(jax.random.PRNGKey(0), jnp.zeros((GPT_S, GPT_B), jnp.int32))
    rs = np.random.RandomState(7)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rs.randn(*a.shape)).astype(
            np.float32), tree)


def _gpt_ids():
    return np.random.RandomState(3).randint(0, 64, (GPT_S, GPT_B)).astype(
        np.int64)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return str(port_data.synthetic_token_corpus(
        tmp_path_factory.mktemp("cp_corpus") / "corpus.bin",
        vocab_size=1024, num_tokens=20_000))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, corpus):
    tmp = tmp_path_factory.mktemp("cp_runs")
    q, k, v = _qkv()
    out = {}
    for world in WORLDS:
        cases = {**CASES, **FAULTS}
        if world == 4:
            cases.update(DROPOUT)
        jobs = [("cp", "cp_case", dict(
            q=q, k=k, v=v, bias=_bias(),
            cases=[(n, kind, kw) for n, (kind, kw) in cases.items()],
            seed=SEED))]
        if world == 2:
            jobs.append(("gpt", "gpt_cp_case", dict(
                params_np=_gpt_params(), cfg_kwargs=GPT_KW, ids=_gpt_ids(),
                modes=MODES)))
            jobs += [(f"train_{mode}", "train_gpt_case", dict(
                argv=[*TRAIN_ARGV, "--data", corpus, "--context-parallel",
                      mode, "--cp", "2"])) for mode in MODES]
        out[world] = workers.spawn(world, jobs, tmp, timeout=200.0)
    return out


def _mesh(world):
    jps.destroy_model_parallel()
    return jps.initialize_model_parallel(
        context_parallel_size=world, devices=jax.devices()[:world])


def _jax_attention(name, world):
    """JAX's per-rank (output, (dq, dk, dv)) for case ``name``, each
    stacked (world, ...) in the case's layout."""
    kind, kw = (CASES | FAULTS)[name]
    kw = {k: v for k, v in kw.items() if k not in ("fault",)}
    with_bias = kw.pop("bias", False)
    q, k, v = (jnp.asarray(a) for a in _qkv())
    bias = jnp.asarray(_bias())
    zig = kind == "zigzag"
    if zig:
        q, k, v = (jcp.zigzag_split(a, world, axis=2) for a in (q, k, v))
        bias = jcp.zigzag_split(bias, world, axis=3)
        spec, bspec = P("cp"), P("cp")
    else:
        spec, bspec = P(None, None, "cp"), P(None, None, None, "cp")
    mesh = _mesh(world)

    def f(q, k, v, b):
        if zig:
            q, k, v, b = q[0], k[0], v[0], b[0]
        b = b if with_bias else None
        if kind == "ulysses":
            fn = lambda q, k, v: jcp.ulysses_attention(q, k, v, b, **kw)
        else:
            fn = lambda q, k, v: jcp.ring_attention(
                q, k, v, b, layout="zigzag" if zig else "contiguous", **kw)
        o, vjp = jax.vjp(fn, q, k, v)
        grads = vjp(2 * o)
        outs = (o,) + tuple(grads)
        return tuple(t[None] for t in outs)

    try:
        outs = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(spec, spec, spec, bspec),
            out_specs=(P("cp"),) * 4, check_vma=False,
        ))(q, k, v, bias)
    finally:
        jps.destroy_model_parallel()
    outs = [np.asarray(t) for t in outs]
    return outs[0], outs[1:]


def _close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_attention_matches_jax(world, name, runs):
    o, grads = _jax_attention(name, world)
    for r in range(world):
        got_o, got_g, _ = runs[world][r]["cp"][name]
        _close(got_o, o[r], f"{name} out rank {r}")
        for what, a, b in zip("qkv", got_g, grads):
            _close(a, b[r], f"{name} d{what} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_call_log(world, name, runs):
    """A ring rotates k, v (and the bias) world − 1 times forward and
    their cotangents back; Ulysses is four all-to-alls each way (three
    in, one out) and the bias's all-gather."""
    kind, kw = CASES[name]
    log = runs[world][0]["cp"][name][2]
    if kind == "ulysses":
        assert log["all-to-all"]["count"] == 8
        assert ("all-gather" in log) == kw.get("bias", False)
        return
    per_hop = (2 if kind == "ring" else 4) + (
        (1 if kind == "ring" else 2) if kw.get("bias") else 0)
    grads_back = 2 if kind == "ring" else 4
    assert set(log) == {"collective-permute"}
    assert log["collective-permute"]["count"] == (world - 1) * (
        per_hop + grads_back)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(FAULTS))
def test_dropped_dlse_fails_the_gradient_check(world, name, runs):
    """The hops' backward fed no lse cotangent: the forward is exact,
    the gradients are not."""
    base = name.replace("_dlse", "")
    o, grads = _jax_attention(name, world)
    worst = 0.0
    for r in range(world):
        got_o, got_g, _ = runs[world][r]["cp"][name]
        _close(got_o, o[r], f"fault out rank {r}")
        for a, b in zip(got_g, grads):
            worst = max(worst, float(np.abs(a - b[r]).max()
                                     / np.abs(b[r]).max()))
    assert worst > 100 * TOL, (base, worst)
    with pytest.raises(AssertionError):
        for r in range(world):
            for a, b in zip(runs[world][r]["cp"][name][1], grads):
                _close(a, b[r], "fault")


def _golden_keep(world, kind):
    """The (B, H, S, S) keep mask the ring's dropout assembles."""
    seed = torch.tensor([SEED], dtype=torch.int32)
    keep = torch.ones(B, H, S, S, dtype=torch.bool)
    if kind == "ring":
        sl = S // world
        for r in range(world):
            for src in range(world):
                m = dropout_keep_mask(tcp.fold_seed(seed, r * world + src),
                                      (B, H, sl, sl), DROP_P)
                keep[:, :, r * sl:(r + 1) * sl, src * sl:(src + 1) * sl] = m
        return keep
    half = S // (2 * world)

    def put(qc, kc, idx):
        m = dropout_keep_mask(tcp.fold_seed(seed, idx), (B, H, half, half),
                              DROP_P)
        keep[:, :, qc * half:(qc + 1) * half, kc * half:(kc + 1) * half] = m

    for r in range(world):
        for src in range(world):
            put(r, src, (r * world + src) * 4 + 0)
            put(2 * world - 1 - r, src, (r * world + src) * 4 + 1)
            put(2 * world - 1 - r, 2 * world - 1 - src,
                (r * world + src) * 4 + 2)
    return keep


def _golden(kind, causal):
    """Output and q/k/v gradients of full attention under the assembled
    mask (f32 torch, autograd)."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv())
    keep = _golden_keep(4, kind)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * D ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e9)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd",
                     torch.where(keep, p / (1 - DROP_P), 0.0), v)
    grads = torch.autograd.grad(o, (q, k, v), 2 * o.detach())
    return o.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("name", sorted(DROPOUT))
def test_dropout_matches_the_block_mask_golden(name, runs):
    kind, kw = DROPOUT[name]
    o, grads = _golden(kind, kw["causal"])
    world = 4
    layout = "zigzag" if kind == "zigzag" else "contiguous"
    for r in range(world):
        got_o, got_g, _ = runs[world][r]["cp"][name]
        want = workers._cp_local(o, world, r, layout).numpy()
        np.testing.assert_allclose(got_o, want, rtol=2e-5, atol=2e-5)
        for a, g in zip(got_g, grads):
            np.testing.assert_allclose(
                a, workers._cp_local(g, world, r, layout).numpy(),
                rtol=1e-3, atol=5e-4)
    # the mask is really applied: dropping differs from not dropping
    plain = runs[world][0]["cp"][kind if kind == "zigzag" else (
        "ring_causal" if kw["causal"] else "ring")][0]
    assert not np.allclose(runs[world][0]["cp"][name][0], plain, atol=1e-3)


def test_fold_seed_spreads_and_repeats():
    seed = torch.tensor([SEED], dtype=torch.int32)
    seeds = {int(tcp.fold_seed(seed, i)) for i in range(64)}
    assert len(seeds) == 64
    assert int(tcp.fold_seed(seed, 5)) == int(tcp.fold_seed(seed.clone(), 5))
    assert tcp.fold_seed(seed, 5).dtype == torch.int32


@pytest.mark.parametrize("cp", [1, 2, 4])
@pytest.mark.parametrize("axis", [0, 2])
def test_zigzag_layout_matches_jax(cp, axis):
    x = np.arange(2 * 3 * 16 * 2, dtype=np.float32).reshape(2, 3, 16, 2)
    x = np.moveaxis(x, 2, axis)
    got = tcp.zigzag_split(torch.from_numpy(x), cp, axis=axis)
    want = jcp.zigzag_split(jnp.asarray(x), cp, axis=axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tcp.zigzag_merge(got, cp, axis=axis),
                                  x)
    for r in range(cp):
        np.testing.assert_array_equal(
            tcp.zigzag_shard(torch.from_numpy(x), r, cp, axis=axis).numpy(),
            np.asarray(jcp.zigzag_shard(jnp.asarray(x), r, cp, axis=axis)))


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _zeros(m, shape):
    return torch.zeros(shape) if m is tcp else jnp.zeros(shape)


def test_probes_match_jax():
    """Every refusal that needs no second rank, message for message."""
    jps.destroy_model_parallel()
    tq, jq = torch.zeros(1, 2, 8, 4), jnp.zeros((1, 2, 8, 4))
    probes = [
        ("query-dependent bias", lambda m, q: m.ring_attention(
            q, q, q, _zeros(m, (1, 1, 8, 8)))),
        ("global mask", lambda m, q: m.ring_attention(
            q, q, q, _zeros(m, (1, 1, 1, 16)))),
        ("zigzag without causal", lambda m, q: m.ring_attention(
            q, q, q, layout="zigzag")),
        ("unknown layout", lambda m, q: m.ring_attention(
            q, q, q, causal=True, layout="striped")),
        ("zigzag remainder", lambda m, q: m.zigzag_shard(q, 0, 3, axis=2)),
    ]
    for what, fn in probes:
        got = _message(lambda: fn(tcp, tq))
        want = _message(lambda: fn(jcp, jq))
        assert got is not None and got == want, (what, got, want)
    # dropout without its randomness: each package names its own source
    assert "generator or a dropout_seed" in _message(
        lambda: tcp.ring_attention(tq, tq, tq, dropout_p=0.3))
    assert "dropout_rng" in _message(
        lambda: jcp.ring_attention(jq, jq, jq, dropout_p=0.3))


def test_cp_probes_match_jax(runs):
    """The refusals that need cp = 2, against JAX's under shard_map."""
    errs = runs[2][0]["cp"]["errors"]
    mesh = _mesh(2)

    def jax_message(fn, *arrays):
        try:
            jax.jit(jax.shard_map(
                fn, mesh=mesh, in_specs=(P(),) * len(arrays),
                out_specs=P(), check_vma=False))(*arrays)
        except ValueError as e:
            return str(e)
        return None

    try:
        q3 = jnp.zeros((1, 3, 4, 8))
        q2 = jnp.zeros((1, 2, 4, 8))
        heads = jax_message(lambda q: jcp.ulysses_attention(q, q, q), q3)
        bias = jax_message(lambda q, b: jcp.ulysses_attention(q, q, q, b),
                           q2, jnp.zeros((1, 1, 4, 4)))
    finally:
        jps.destroy_model_parallel()
    assert errs["heads"] == heads
    assert errs["ulysses_bias"] == bias


# ---------------------------------------------------------------------------
# GPT under context parallelism
# ---------------------------------------------------------------------------


def _jax_gpt_cp(mode):
    """JAX's loss, per-rank gradients (stacked) and cp-mean gradients."""
    cfg = jgpt.GptConfig(**GPT_KW, dtype=jnp.float32, context_parallel=mode)
    m = jgpt.GptModel(cfg)
    params = jax.tree.map(jnp.asarray, _gpt_params())
    ids = jnp.asarray(_gpt_ids().astype(np.int32))
    mesh = _mesh(2)

    def f(params, ids):
        rank = jax.lax.axis_index("cp")
        if mode == "ring_zigzag":
            local = jcp.zigzag_shard(ids, rank, 2, axis=0)
        else:
            local = jax.lax.dynamic_slice_in_dim(ids, rank * (GPT_S // 2),
                                                 GPT_S // 2, 0)
        loss, g = jax.value_and_grad(
            lambda p: jgpt.gpt_lm_loss_cp(p, m, local))(params)
        mean = jax.tree.map(lambda t: jax.lax.pmean(t, "cp"), g)
        return loss, jax.tree.map(lambda t: t[None], g), mean

    try:
        loss, per_rank, mean = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P(), P()),
            out_specs=(P(), P("cp"), P()), check_vma=False,
        ))(params, ids)
    finally:
        jps.destroy_model_parallel()
    return float(loss), per_rank, mean


def _jax_gpt_ref():
    m = jgpt.GptModel(jgpt.GptConfig(**GPT_KW, dtype=jnp.float32))
    params = jax.tree.map(jnp.asarray, _gpt_params())
    ids = jnp.asarray(_gpt_ids().astype(np.int32))
    return jax.value_and_grad(lambda p: jgpt.gpt_lm_loss(p, m, ids))(params)


def _tree_close(got, want, what, pick=lambda a: a):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(
            g, pick(np.asarray(leaf)), **GPT_TOL,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("mode", MODES)
def test_gpt_cp_matches_jax(mode, runs):
    """gpt_lm_loss_cp, each rank's gradients as JAX's shard_map has them
    (cp times the rank's share: the psum's transpose sums), and their
    cp mean."""
    loss, per_rank, mean = _jax_gpt_cp(mode)
    for r in range(2):
        got_loss, got_rank, got_mean, _ = runs[2][r]["gpt"][mode]
        assert got_loss == pytest.approx(loss, rel=2e-5)
        _tree_close(got_rank, per_rank, f"{mode} rank {r}",
                    pick=lambda a, r=r: a[r])
        _tree_close(got_mean, mean, f"{mode} mean rank {r}")


@pytest.mark.parametrize("mode", MODES)
def test_gpt_cp_mean_gradients_equal_the_unsharded_loss(mode, runs):
    loss, grads = _jax_gpt_ref()
    got_loss, _, got_mean, log = runs[2][0]["gpt"][mode]
    assert got_loss == pytest.approx(float(loss), rel=2e-5)
    _tree_close(got_mean, grads, f"{mode} vs unsharded")
    # the boundary targets and the loss's sums ride the comm wrappers
    assert "collective-permute" in log and "all-reduce" in log


# ---------------------------------------------------------------------------
# the example: train_gpt --context-parallel at world 2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_ref(corpus):
    """The example at world 1 in this process (cp = 1)."""
    return workers.train_gpt_case([*TRAIN_ARGV, "--data", corpus])


@pytest.mark.parametrize("mode", MODES)
def test_train_gpt_under_cp_equals_world_1(mode, runs, train_ref):
    """``build`` at world 2 makes cp = 2 (dp = 1, DDP) and hands each
    rank its rows of the loader's batches (``local_rows``: contiguous,
    or the zigzag pair); ``train_step`` takes ``gpt_lm_loss_cp`` and
    mean-reduces the gradients over cp after DDP.  Step 0's gradients
    equal the unsharded example's (a sum over cp in place of the mean
    would double them, which Adam's losses would hide), and so do the
    losses."""
    for r in range(2):
        got = runs[2][r][f"train_{mode}"]
        assert got["mesh"]["cp"] == 2 and got["mesh"]["dp"] == 1
        assert got["ddp"]
        np.testing.assert_allclose(got["losses"], train_ref["losses"],
                                   rtol=TRAIN_LOSS_RTOL)
        for name, want in train_ref["grads0"].items():
            np.testing.assert_allclose(
                got["grads0"][name], want, rtol=TOL,
                atol=TOL * float(np.abs(want).max()),
                err_msg=f"{mode} rank {r} {name}")


def test_train_gpt_refuses_a_zigzag_cut_that_drops_tokens():
    """--seq-len must split into 2·cp chunks under ring_zigzag (30 is
    divisible by cp = 2 but not by 4); contiguous ring takes it."""
    args = train_gpt.parse_args(["--context-parallel", "ring_zigzag",
                                 "--cp", "2", "--seq-len", "30"])
    with pytest.raises(ValueError, match="2\\*cp=4 for ring_zigzag"):
        train_gpt.check_args(args, dp=1)
    train_gpt.check_args(train_gpt.parse_args(
        ["--context-parallel", "ring", "--cp", "2", "--seq-len", "30"]), dp=1)

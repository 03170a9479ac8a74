"""Multi-process workers of the port's parallel tests (no test here).

:func:`spawn` starts ``world`` processes (the ``spawn`` start method),
each of which joins a gloo group through a ``file://`` store in the
test's temporary directory (no TCP port, so parallel test workers cannot
collide), runs a list of cases and saves their results.  A case is
``(name, function name in this module, kwargs)``; every case function
sets up its own ``parallel_state`` and tears it down.  The workers
import neither JAX nor ``apex_tpu``; the tests hold their results
against the JAX package in the parent.

A worker that raises, exits non-zero or outlives the timeout fails the
spawn: the others are killed and the error is raised with the failing
rank's traceback.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch

GROUP_TIMEOUT_S = 60.0


def port_state_guard():
    """The body of the autouse fixture of every port test file that
    reaches ``initialize_model_parallel`` in its own process (an example's
    ``main``, the trainer, a hand-built mesh): yields, then destroys the
    port's ``parallel_state``, so no test depends on which file ran
    before it in the same worker.  The examples leave the state
    initialized when ``main`` returns, as the reference's do."""
    from apex_tpu_torch import parallel_state

    yield
    parallel_state.destroy_model_parallel()


def spawn(world: int, cases, tmp_path, timeout: float = 240.0) -> list:
    """Run ``cases`` on ``world`` gloo ranks; returns each rank's
    ``{case name: result}``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = Path(tmp_path) / f"world{world}"
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / "store"
    procs = [ctx.Process(target=_main,
                         args=(r, world, str(store), cases, str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise RuntimeError(f"ranks {hung} still running after {timeout} s")
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                err = tmp / f"err{r}.txt"
                text = err.read_text() if err.exists() else "(no traceback)"
                raise RuntimeError(
                    f"rank {r} exited with {p.exitcode}:\n{text}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    out = []
    for r in range(world):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _main(rank, world, store, cases, out_dir):
    torch.set_num_threads(1)
    from apex_tpu_torch.parallel import multihost

    try:
        multihost.initialize_distributed(
            init_method=f"file://{store}", num_processes=world,
            process_id=rank, backend="gloo", device="cpu",
            timeout_s=GROUP_TIMEOUT_S)
        results = {}
        for name, fn, kwargs in cases:
            results[name] = globals()[fn](**kwargs)
        with open(os.path.join(out_dir, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    except BaseException:
        with open(os.path.join(out_dir, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        multihost.finalize_distributed()


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


def mappings_case(x, tp):
    """Every mapping's forward and its input gradient for the cotangent
    ``x * 3`` (``x`` the same full tensor on every rank; the split ones
    take this rank's slice first)."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer.tensor_parallel import mappings as mp

    ps.initialize_model_parallel(tp)
    try:
        rank = ps.get_tensor_model_parallel_rank()
        full = torch.from_numpy(x)
        out = {}
        with comm.collective_log() as log:
            for name in ("copy_to_tensor_model_parallel_region",
                         "reduce_from_tensor_model_parallel_region",
                         "scatter_to_tensor_model_parallel_region",
                         "gather_from_tensor_model_parallel_region",
                         "scatter_to_sequence_parallel_region",
                         "gather_from_sequence_parallel_region",
                         "gather_from_sequence_parallel_region_split",
                         "reduce_scatter_to_sequence_parallel_region"):
                inp = full * (rank + 1)
                if name.startswith("gather_from_tensor"):
                    inp = inp.chunk(tp, -1)[rank].contiguous()
                elif name.startswith("gather_from_sequence"):
                    inp = inp.chunk(tp, 0)[rank].contiguous()
                inp.requires_grad_(True)
                if name.endswith("_split"):
                    y = mp.gather_from_sequence_parallel_region(
                        inp, tensor_parallel_output_grad=False)
                else:
                    y = getattr(mp, name)(inp)
                (g,) = torch.autograd.grad(y, inp, y.detach() * 3 + rank)
                out[name] = (_np(y), _np(g))
        out["log"] = [dict(r) for r in log]
        return out
    finally:
        ps.destroy_model_parallel()


def _tp_model_case(kind, params_path, cfg_kwargs, tp, batch, fault=None):
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.models import convert
    from apex_tpu_torch.models.bert import BertConfig, bert_pretrain_loss
    from apex_tpu_torch.models.gpt import GptConfig, gpt_lm_loss
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer.tensor_parallel import (
        allreduce_sequence_parallel_gradients,
    )

    ps.initialize_model_parallel(tp)
    try:
        params = _load(params_path)
        if kind == "gpt":
            cfg = GptConfig(**cfg_kwargs, dtype=torch.float32)
            if fault == "swap_shard":
                # every rank loads the next rank's shard
                other = (ps.get_tensor_model_parallel_rank() + 1) % tp
                model = convert.GptModel(cfg, device="cpu")
                model.load_state_dict(convert._state_dict_from_jax(
                    convert.tp_shard_jax_params(params, other, tp), cfg))
            else:
                model = convert.from_jax_params(params, cfg, device="cpu")
            ids = torch.from_numpy(batch)
            with comm.collective_log() as log:
                loss = gpt_lm_loss(model, ids)
                loss.backward()
                n_sp = allreduce_sequence_parallel_gradients(model)
            grads = convert.to_jax_params(
                model, {n: p.grad for n, p in model.named_parameters()})
        else:
            cfg = BertConfig(**cfg_kwargs, dtype=torch.float32)
            model = convert.bert_from_jax_params(params, cfg, device="cpu")
            b = {k: torch.from_numpy(v) for k, v in batch.items()}
            with comm.collective_log() as log:
                loss = bert_pretrain_loss(model, b)
                loss.backward()
                n_sp = allreduce_sequence_parallel_gradients(model)
            grads = convert.bert_to_jax_params(
                model, {n: p.grad for n, p in model.named_parameters()})
        return {"loss": float(loss), "grads": grads, "n_sp": n_sp,
                "log": comm.collective_summary(log)}
    finally:
        ps.destroy_model_parallel()


def gpt_tp_case(params_path, cfg_kwargs, tp, ids, fault=None):
    return _tp_model_case("gpt", params_path, cfg_kwargs, tp, ids, fault)


def bert_tp_case(params_path, cfg_kwargs, tp, batch, fault=None):
    return _tp_model_case("bert", params_path, cfg_kwargs, tp, batch, fault)


# ---------------------------------------------------------------------------
# the gradient-sync engine, DDP, ZeRO
# ---------------------------------------------------------------------------


class Toy(torch.nn.Module):
    """The reference tests' DDP toy: pred = tanh(x @ w1) @ w2, mean
    squared error."""

    def __init__(self, w1, w2):
        super().__init__()
        self.w1 = torch.nn.Parameter(torch.from_numpy(w1.copy()))
        self.w2 = torch.nn.Parameter(torch.from_numpy(w2.copy()))

    def forward(self, x, y):
        pred = torch.tanh(x @ self.w1) @ self.w2
        return ((pred - y) ** 2).mean()


def _rows(a, rank, world):
    n = a.shape[0] // world
    return torch.from_numpy(a[rank * n:(rank + 1) * n].copy())


def comm_case(flats, grads, wires, chunk_counts, toy, steps):
    """Per rank: the flat collectives and ``sync_gradients`` on every
    wire and chunk count (``flats[rank]``, ``grads[rank]``), the call
    log of each sync, then DDP and ZeRO on the toy."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import (
        DistributedDataParallel,
        DistributedFusedAdam,
        DistributedFusedLAMB,
        comm,
        quantized_all_reduce_gradients,
    )

    ps.initialize_model_parallel()
    try:
        rank = ps.get_data_parallel_rank()
        world = ps.get_data_parallel_world_size()
        out = {}
        for wire in wires:
            for k in chunk_counts:
                flat = torch.from_numpy(flats[rank])
                shard = comm.reduce_scatter_flat(flat, wire=wire, chunks=k)
                full = comm.all_gather_flat(shard, wire=wire, chunks=k)
                g = {n: torch.from_numpy(v.copy())
                     for n, v in grads[rank].items()}
                with comm.collective_log() as log:
                    comm.sync_gradients(g, wire=wire, chunks=k, min_size=64)
                out[f"flat_{wire}_{k}"] = (_np(shard), _np(full))
                out[f"sync_{wire}_{k}"] = ({n: _np(v) for n, v in g.items()},
                                           [dict(r) for r in log])
        g = {n: torch.from_numpy(v.copy()) for n, v in grads[rank].items()}
        quantized_all_reduce_gradients(g, gradient_average=False,
                                       min_size=1)
        out["quantized_sum"] = {n: _np(v) for n, v in g.items()}

        x, y = toy["x"], toy["y"]
        xr, yr = _rows(x, rank, world), _rows(y, rank, world)
        # DDP on each wire: the synced gradients of one step
        for wire in ("f32", "bf16", "int8"):
            model = Toy(toy["w1"], toy["w2"])
            ddp = DistributedDataParallel(model, wire=wire, min_size=1)
            loss, gr = ddp.value_and_grad(xr, yr)
            out[f"ddp_{wire}"] = (float(loss),
                                  {n: _np(v) for n, v in gr.items()})
        # no_sync: local gradients, then one sum over the ranks
        model = Toy(toy["w1"], toy["w2"])
        ddp = DistributedDataParallel(model, gradient_average=False)
        with ddp.no_sync():
            _, local = ddp.value_and_grad(xr, yr)
            local = {n: _np(v) for n, v in local.items()}
        ddp.all_reduce_gradients()
        out["no_sync"] = (local, {n: _np(p.grad)
                                  for n, p in model.named_parameters()})
        # K = 4 accumulated microbatches against one step on their rows
        for accum in (1, 4):
            model = Toy(toy["w1"], toy["w2"])
            opt = FusedAdam(model.parameters(), lr=5e-2)
            ddp = DistributedDataParallel(model)
            step = ddp.make_step(opt, accum_steps=accum)
            losses = []
            for _ in range(steps):
                if accum == 1:
                    losses.append(float(step(xr, yr)))
                else:
                    losses.append(float(step(
                        xr.reshape(accum, -1, xr.shape[-1]),
                        yr.reshape(accum, -1, yr.shape[-1]))))
            out[f"accum{accum}"] = (losses, {n: _np(p) for n, p in
                                             model.named_parameters()})
        model = Toy(toy["w1"], toy["w2"])
        opt = FusedAdam(model.parameters(), lr=5e-2)
        ddp = DistributedDataParallel(model, wire="int8", min_size=1)
        step = ddp.make_step(opt, accum_steps=4)
        out["accum_int8"] = [float(step(xr.reshape(4, -1, 8),
                                        yr.reshape(4, -1, 4)))
                             for _ in range(15)]
        # ZeRO on both wires, steps of the toy
        for name, cls, kw in (
                ("adam", DistributedFusedAdam, dict(lr=1e-2,
                                                    weight_decay=0.01)),
                ("lamb", DistributedFusedLAMB, dict(lr=1e-2,
                                                    weight_decay=0.01))):
            for wire in ("f32", "int8"):
                model = Toy(toy["w1"], toy["w2"])
                opt = cls(model.parameters(), wire=wire, chunks=2, **kw)
                step = opt.make_train_step(lambda a, b: model(a, b))
                with comm.collective_log() as log:  # the first step's
                    losses = [float(step(xr, yr))]
                losses += [float(step(xr, yr)) for _ in range(steps - 1)]
                out[f"zero_{name}_{wire}"] = (
                    losses, {n: _np(p) for n, p in model.named_parameters()},
                    comm.collective_summary(log), opt.collective_plan(),
                    opt.spec.padded_size, opt.spec.shard_size)
        return out
    finally:
        ps.destroy_model_parallel()


# ---------------------------------------------------------------------------
# parallel_state, SyncBatchNorm, the example trainers
# ---------------------------------------------------------------------------


def parallel_state_case(tp, pp, cp):
    """This rank's coordinates, group members and the helpers' answers
    at one (tp, pp, cp) layout; one all-reduce per axis checks that the
    groups hold the members they claim."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.parallel import comm

    mesh = ps.initialize_model_parallel(tp, pp, context_parallel_size=cp)
    try:
        sums = {}
        for axis in ("dp", "pp", "cp", "tp"):
            t = torch.tensor([float(torch.distributed.get_rank())])
            comm.all_reduce(t, ps.get_group(axis))
            sums[axis] = float(t)
        return dict(
            shape=dict(mesh.shape), coords=dict(mesh.coords),
            ranks={k: list(v) for k, v in mesh.ranks.items()}, sums=sums,
            tp_src=ps.get_tensor_model_parallel_src_rank(),
            first=ps.is_pipeline_first_stage(),
            last=ps.is_pipeline_last_stage(),
            next=ps.get_pipeline_model_parallel_next_rank(),
            prev=ps.get_pipeline_model_parallel_prev_rank(),
            dp_shard=_np(ps.data_parallel_shard(torch.arange(8.0))),
        )
    finally:
        ps.destroy_model_parallel()


def broadcast_data_case():
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.transformer.tensor_parallel import broadcast_data

    ps.initialize_model_parallel(2)
    try:
        rank = torch.distributed.get_rank()
        data = {"a": torch.full((3,), float(rank)),
                "b": torch.arange(4) * (rank + 1)}
        out = broadcast_data(["a"], data, torch.float32)
        return _np(out["a"])
    finally:
        ps.destroy_model_parallel()


def syncbn_case(x, cot, weight, bias, channel_last, dtype):
    """SyncBatchNorm on this rank's slice of the batch ``x``: output,
    input gradient, parameter gradients (this rank's partials) and the
    running statistics after one training and one eval call."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.parallel import SyncBatchNorm

    ps.initialize_model_parallel()
    try:
        rank = ps.get_data_parallel_rank()
        world = ps.get_data_parallel_world_size()
        c = weight.shape[0]
        bn = SyncBatchNorm(c, channel_last=channel_last)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(weight))
            bn.bias.copy_(torch.from_numpy(bias))
        xr = _rows(x, rank, world).to(dtype).requires_grad_(True)
        y = bn(xr)
        y.backward(_rows(cot, rank, world).to(dtype))
        bn.eval()
        y_eval = bn(xr.detach())
        return dict(y=_np(y), dx=_np(xr.grad), dw=_np(bn.weight.grad),
                    db=_np(bn.bias.grad), mean=_np(bn.running_mean),
                    var=_np(bn.running_var), y_eval=_np(y_eval))
    finally:
        ps.destroy_model_parallel()


def example_case(module, argv):
    """An example trainer's ``main(argv)`` on this rank (the process
    group is up: the example's start joins it)."""
    import importlib

    from apex_tpu_torch import parallel_state as ps

    try:
        mod = importlib.import_module(f"apex_tpu_torch.examples.{module}")
        return [float(x) for x in mod.main(list(argv))]
    finally:
        ps.destroy_model_parallel()


def train_gpt_case(argv):
    """``examples.train_gpt``'s ``build`` and ``train_step`` on this rank
    (at world 1 when called in the test's own process): the losses, the
    gradients as ``train_step`` hands them to the optimizer at step 0
    (this rank's shards), the mesh and whether DDP wraps the model."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.examples import train_gpt

    try:
        args = train_gpt.parse_args(list(argv))
        _, model, opt, batches, ddp = train_gpt.build(args)
        grads0 = {}
        step = opt.step

        def read_then_step(*a, **k):
            if not grads0:
                grads0.update({n: _np(p.grad)
                               for n, p in model.named_parameters()})
            return step(*a, **k)

        opt.step = read_then_step
        losses = [float(train_gpt.train_step(model, opt, next(batches), ddp))
                  for _ in range(args.steps)]
        return dict(losses=losses, grads0=grads0,
                    mesh=dict(ps.get_mesh().shape), ddp=ddp is not None)
    finally:
        ps.destroy_model_parallel()


def ce_init_case(logits, target, g, cfg_kwargs, tp):
    """The vocab-parallel cross entropy (this rank's vocab slice of the
    full ``logits``, smoothing 0 and 0.1): loss and this slice's
    gradient for the cotangent ``g``; and a GptModel built at tp from
    generator seed 0, its weights gathered over tp to full shapes."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.models.gpt import GptConfig, GptModel
    from apex_tpu_torch.transformer.tensor_parallel import (
        vocab_parallel_cross_entropy,
    )
    from apex_tpu_torch.transformer.tensor_parallel.layers import (
        VocabParallelEmbedding,
        _TPLinear,
    )

    ps.initialize_model_parallel(tp)
    try:
        rank = ps.get_tensor_model_parallel_rank()
        out = {}
        for s in (0.0, 0.1):
            lt = torch.from_numpy(logits).chunk(tp, -1)[rank].contiguous()
            lt.requires_grad_(True)
            loss = vocab_parallel_cross_entropy(lt, torch.from_numpy(target),
                                                s)
            (grad,) = torch.autograd.grad(loss, lt, torch.from_numpy(g))
            out[f"ce_{s}"] = (_np(loss), _np(grad))
        cfg = GptConfig(**cfg_kwargs, dtype=torch.float32)
        model = GptModel(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
        full = {}
        group = ps.get_tensor_model_parallel_group()
        for name, p in model.named_parameters():
            mod = model.get_submodule(name.rpartition(".")[0])
            leaf = name.rpartition(".")[2]
            dim = None
            if isinstance(mod, VocabParallelEmbedding):
                dim = 0
            elif isinstance(mod, _TPLinear):
                dim = mod.shard_dim if leaf == "weight" else (
                    0 if mod.shard_dim == 0 else None)
            t = p.detach()
            if dim is not None:
                buf = t.new_empty((tp,) + tuple(t.shape))
                torch.distributed.all_gather_into_tensor(
                    buf.view(-1), t.contiguous().view(-1), group=group)
                t = torch.cat(buf.unbind(0), dim=dim)
            full[name] = _np(t)
        out["init"] = full
        from apex_tpu_torch.transformer.tensor_parallel import sharded_init

        def base(gen, shape, dtype, device):
            return torch.randn(shape, generator=gen, dtype=dtype)

        out["sharded_init"] = _np(sharded_init(base, (8, 12), 1)(
            torch.Generator().manual_seed(1), (8, 12 // tp)))
        return out
    finally:
        ps.destroy_model_parallel()


# ---------------------------------------------------------------------------
# dynamic axial parallelism (the OpenFold DAP)
# ---------------------------------------------------------------------------


def _dap_module(kind, dims):
    import torch

    from apex_tpu_torch.contrib import openfold as pof

    kw = dict(dtype=torch.float32, device="cpu")
    s, r, cm, cz, h = dims
    if kind.startswith("tmu_"):
        return pof.TriangleMultiplicativeUpdate(
            cz, kind[4:], hidden=cz, axis_name="dp", device="cpu")
    if kind == "pair_block":
        return pof.EvoformerPairBlock(cz, h, "dp", **kw)
    if kind == "evo_block":
        return pof.EvoformerBlock(cm, cz, h, "dp", **kw)
    return pof.DAPAxialBlock(cz, h, "dp", **kw)


def _dap_run(name, kind, params_np, inputs, dims):
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.contrib import openfold as pof
    from apex_tpu_torch.models import (
        evoformer_from_jax_params,
        evoformer_to_jax_params,
    )
    from apex_tpu_torch.parallel import comm

    mod = evoformer_from_jax_params(params_np, _dap_module(kind, dims))
    local = [pof.scatter(torch.from_numpy(x), "dp", 0) for x in inputs]
    with comm.collective_log() as log:
        outs = mod(*local)
        outs = outs if isinstance(outs, tuple) else (outs,)
        sum(o.square().sum() for o in outs).backward()
    grads = {}
    for pname, p in mod.named_parameters():
        g = p.grad.clone()
        comm.all_reduce(g, ps.get_group("dp"))
        grads[pname] = g
    return ([_np(o) for o in outs], evoformer_to_jax_params(mod, grads),
            [dict(r) for r in log])


def dap_case(modules, collectives, dims, fault_module=None):
    """Each module on this rank's rows of its inputs (``scatter``), the
    loss ``sum(out ** 2)`` summed over the outputs, the parameter
    gradients all-reduced over the dp (DAP) group; each collective with
    its cotangent ``y * 3 + rank``; then ``fault_module`` again with a
    planted fault: ``gather``'s backward slicing this rank's rows instead
    of reduce-scattering (under ``"<name>_fault"``)."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.contrib import openfold as pof

    ps.initialize_model_parallel(1)
    try:
        rank = ps.axis_rank("dp")
        out = {}
        for name, kind, params_np, inputs in modules:
            out[name] = _dap_run(name, kind, params_np, inputs, dims)
        for name, fn, x, kw in collectives:
            inp = torch.from_numpy(x) * (rank + 1)
            inp.requires_grad_(True)
            y = getattr(pof, fn)(inp, "dp", **kw)
            (g,) = torch.autograd.grad(y, inp, y.detach() * 3 + rank)
            out[name] = (_np(y), _np(g))
        for name, kind, params_np, inputs in modules:
            if name != fault_module:
                continue
            gather = pof._Gather.backward

            def sliced(ctx, g):
                n = g.shape[ctx.dim] // ps.axis_size(ctx.axis_name)
                return g.narrow(ctx.dim, rank * n, n), None, None

            pof._Gather.backward = staticmethod(sliced)
            try:
                out[name + "_fault"] = _dap_run(name, kind, params_np,
                                                inputs, dims)
            finally:
                pof._Gather.backward = gather
        return out
    finally:
        ps.destroy_model_parallel()


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _demo_step(dp, tp, params_np, batch_np, **kw):
    from apex_tpu_torch.train import build_demo, params_from_numpy

    return build_demo(dp, tp, device="cpu",
                      params=params_from_numpy(params_np, device="cpu"),
                      batch=tuple(torch.from_numpy(b) for b in batch_np),
                      **kw)


def _global_params(step):
    """The step's params gathered to their global shapes (tp shards
    concatenated along their sharded dim) as numpy."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.analysis.sharding import tree_paths
    from apex_tpu_torch.parallel import comm

    out = {}
    specs = dict(tree_paths(step.state_specs["params"]))
    for path, t in tree_paths(step.state["params"]):
        spec = tuple(specs[path])
        dims = [d for d, e in enumerate(spec) if e == "tp"]
        if dims and ps.axis_size("tp") > 1:
            d = dims[0]
            full = torch.empty((ps.axis_size("tp") * t.shape[d],)
                               + tuple(t.movedim(d, 0).shape[1:]))
            comm.all_gather_into(full, t.movedim(d, 0).contiguous(),
                                 ps.get_group("tp"))
            t = full.movedim(0, d)
        out[path] = _np(t)
    return out


def trainer_case(dp, tp, params_np, batch_np, steps, modes, bogus_plan):
    """``build_demo(dp, tp)`` (verify="error") in each update mode
    (``"<mode>[:<wire>]"``) on the reference's params and batch: the losses of ``steps`` steps, the
    final global params, the build's report and one step's call log;
    then the planted bogus plan's build error, ``track_grad_norm``'s
    norm (or its refusal) and a build per ``optimizer_kwargs``
    spelling in both modes."""
    import dataclasses

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.train import TrainBuildError, Trainer
    from apex_tpu_torch.train import demo

    out = {}
    batch = tuple(torch.from_numpy(b) for b in batch_np)
    try:
        for mode in modes:
            upd, _, wire = mode.partition(":")
            step = _demo_step(dp, tp, params_np, batch_np,
                              update_sharding=upd, wire=wire or "f32",
                              verify="error", hbm_budget=64 << 20)
            st, losses = step.state, []
            for i in range(steps):
                if i == 0:
                    with comm.collective_log() as log:
                        st, aux = step(st, batch)
                else:
                    st, aux = step(st, batch)
                losses.append(float(aux["loss"]))
            step.state = st
            step.registry.observe(1, aux["metrics"])
            out[mode] = dict(
                mode=step.mode, losses=losses, params=_global_params(step),
                findings=[f.render() for f in step.report.findings],
                plan=step.report.sections["plan"],
                log=comm.collective_summary(log),
                expect=step.expect_plan,
                metrics=step.registry.fetch()["train/loss"])
            ps.destroy_model_parallel()
        try:
            _demo_step(dp, tp, params_np, batch_np,
                       model_collectives=bogus_plan)
            out["bogus"] = None
        except TrainBuildError as e:
            out["bogus"] = str(e)
        ps.destroy_model_parallel()
        norms = {}
        for mode in ("replicate", "shard") if dp > 1 else ("replicate",):
            cfg = dataclasses.replace(
                demo.demo_config(dp, tp, update_sharding=mode,
                                 verify="off", device="cpu"),
                track_grad_norm=True)
            try:
                step = Trainer(cfg).build(
                    demo.demo_loss, _params_np_to_torch(params_np), batch)
                st, aux = step(step.state, batch)
                norms[mode] = (float(aux["grad_norm"]),
                               float(aux["metrics"]["train/grad_norm"]))
            except TrainBuildError as e:
                norms[mode] = str(e)
            ps.destroy_model_parallel()
        out["norms"] = norms
        flips = []
        if dp > 1:
            for kwargs in ({"beta1": 0.95, "beta2": 0.98},
                           {"betas": (0.95, 0.98)}):
                for mode in ("replicate", "shard"):
                    cfg = dataclasses.replace(
                        demo.demo_config(dp, tp, update_sharding=mode,
                                         verify="off", device="cpu"),
                        optimizer_kwargs=kwargs)
                    step = Trainer(cfg).build(
                        demo.demo_loss, _params_np_to_torch(params_np),
                        batch)
                    losses = []
                    st = step.state
                    for _ in range(2):
                        st, aux = step(st, batch)
                        losses.append(float(aux["loss"]))
                    flips.append((sorted(kwargs), mode, step.mode, losses))
                    ps.destroy_model_parallel()
        out["flips"] = flips
        return out
    finally:
        ps.destroy_model_parallel()


def _params_np_to_torch(params_np):
    from apex_tpu_torch.train import params_from_numpy

    return params_from_numpy(params_np, device="cpu")


def fit_case(params_np, batch_np, directory, steps, preempt_at):
    """``TrainStep.fit`` of the dp = 2 demo in ZeRO mode with the async
    engine, saving every 2 steps: once uninterrupted, once preempted at
    ``preempt_at`` (chaos SIGTERM) and resumed by a fresh build.  The
    final params (global) and ZeRO master shard of each, the resumed
    run's result, and the committed steps."""
    import os

    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.resilience import chaos

    batch = tuple(torch.from_numpy(b) for b in batch_np)
    out = {}
    try:
        for run in ("plain", "preempted"):
            d = os.path.join(directory, run)
            step = _demo_step(2, 1, params_np, batch_np, verify="off")
            assert step.mode == "zero"
            if run == "preempted":
                chaos.configure(chaos.Fault(chaos.PREEMPTION,
                                            steps=(preempt_at,)))
                try:
                    first = step.fit(lambda i: batch, steps, directory=d,
                                     save_interval_steps=2)
                finally:
                    chaos.clear()
                out["first"] = (first.last_step, first.preempted,
                                ckpt.all_steps(d))
                ps.destroy_model_parallel()
                step = _demo_step(2, 1, params_np, batch_np, verify="off")
            res = step.fit(lambda i: batch, steps, directory=d,
                           save_interval_steps=2)
            step.state = res.state
            out[run] = dict(
                params=_global_params(step),
                master=_np(res.state["opt"].tree["master"]),
                last=res.last_step, resumed=res.resumed_from,
                steps_run=res.steps_run, goodput=step.goodput.snapshot(),
                steps=ckpt.all_steps(d))
            ps.destroy_model_parallel()
        return out
    finally:
        ps.destroy_model_parallel()


def ckpt_fault_case(directory):
    """A collective save where rank 1 fails before writing its files:
    every rank raises and no step is committed; then a sound save of the
    same step commits and restores each rank's own shard."""
    import os

    from apex_tpu_torch import checkpoint as ckpt

    rank = torch.distributed.get_rank()
    state = {"w": torch.arange(4.0), "opt": ckpt.per_rank(
        {"m": torch.full((3,), float(rank)), "count": 2})}
    path = os.path.join(directory, "7")

    def hook(r):
        if r == 1:
            raise OSError("rank 1 died mid-save")

    ckpt._rank_write_hook = hook
    try:
        ckpt.save_checkpoint(path, state)
        raised = None
    except Exception as e:  # noqa: BLE001 — the planted failure
        raised = type(e).__name__
    finally:
        ckpt._rank_write_hook = None
    after_fault = ckpt.all_steps(directory)
    ckpt.save_checkpoint(path, state)
    template = {"w": torch.zeros(4), "opt": ckpt.per_rank(
        {"m": torch.zeros(3), "count": 0})}
    back = ckpt.restore_checkpoint(path, template)
    return dict(raised=raised, after_fault=after_fault,
                after=ckpt.all_steps(directory), w=_np(back["w"]),
                m=_np(back["opt"].tree["m"]),
                count=back["opt"].tree["count"],
                files=sorted(os.listdir(path)))


# ---------------------------------------------------------------------------
# amp: the guarded two-program step, the tp-synced grad scaler
# ---------------------------------------------------------------------------


def guarded_case(params_np, batches_np, accum, poison):
    """``build_guarded`` at dp = world (f32 wire, replicated Adam, the
    dynamic scaler at 2**10, ``GradGuard(warmup_steps=2)``) over
    ``batches_np`` (each a tuple of global ``(accum, rows, ...)``
    arrays); ``poison[i]`` ("nan" or a factor) spoils step i's scaled
    gradients between the two programs.  Per step: the dp-mean loss,
    the verdict, the scaler state; then the final params, the plan
    report, and the refusals."""
    from apex_tpu_torch import amp
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.analysis.sharding import P
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.resilience import GradGuard
    from apex_tpu_torch.train import TrainBuildError, TrainConfig, Trainer

    world = torch.distributed.get_world_size()
    try:
        trainer = Trainer(TrainConfig(
            mesh={"dp": world}, rules=[(r".*", P())],
            update_sharding="replicate", device="cpu"))
        g = trainer.build_guarded(
            lambda p, b: torch.mean((b[0] @ p["w"] - b[1]) ** 2),
            {"w": torch.from_numpy(params_np)},
            tx=fused_adam(1e-2),
            scaler=amp.DynamicLossScaler(init_scale=2.0 ** 10),
            guard=GradGuard(warmup_steps=2), accum=accum, verify="error",
            example_batch=tuple(torch.from_numpy(b)
                                for b in batches_np[0]))
        state, rows = g.state, []
        for i, b in enumerate(batches_np):
            loss, scaled = g.compute_grads(
                state["params"], state["scaler"],
                tuple(torch.from_numpy(x) for x in b))
            p = poison.get(i)
            if p == "nan":
                scaled = {k: torch.full_like(v, float("nan"))
                          for k, v in scaled.items()}
            elif p is not None:
                scaled = {k: v * p for k, v in scaled.items()}
            state, v = g.apply_update(scaled, state, loss)
            rows.append(dict(
                loss=float(loss), skipped=float(v.skipped),
                found_inf=float(v.found_inf), spike=bool(v.spike),
                grad_norm=float(v.grad_norm),
                scale=float(state["scaler"].loss_scale),
                tracker=int(state["scaler"].growth_tracker),
                count=int(state["opt"].count)))
        out = dict(rows=rows, w=_np(state["params"]["w"]),
                   findings=[f.render() for f in g.report.findings],
                   plan=g.report.sections["plan"])
        ps.destroy_model_parallel()
        refusals = []
        for kw in (dict(mesh={"dp": 1, "tp": world}),
                   dict(mesh={"dp": world}, update_sharding="shard")):
            try:
                Trainer(TrainConfig(rules=[(r".*", P())], device="cpu",
                                    **kw)).build_guarded(
                    lambda p, b: 0.0, {}, tx=None, scaler=None, guard=None)
                refusals.append(None)
            except TrainBuildError as e:
                refusals.append(str(e))
        out["refusals"] = refusals
        return out
    finally:
        ps.destroy_model_parallel()


def grad_scaler_case(tp):
    """``GradScaler.unscale`` on tp ranks where only the last rank's
    gradients overflow: every rank reads found_inf = 1 (and the plain
    scaler only the last)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer.amp import GradScaler

    ps.initialize_model_parallel(tp)
    try:
        rank = ps.get_tensor_model_parallel_rank()
        grads = {"w": torch.ones(4) * (float("inf") if rank == tp - 1
                                       else 1.0)}
        scaler = GradScaler(init_scale=4.0)
        state = scaler.init("cpu")
        with comm.collective_log() as log:
            _, synced = scaler.unscale(grads, state)
        _, plain = amp.DynamicLossScaler(init_scale=4.0).unscale(
            grads, state)
        return dict(synced=float(synced), plain=float(plain),
                    log=[dict(r) for r in log])
    finally:
        ps.destroy_model_parallel()


# ---------------------------------------------------------------------------
# pipeline, context and expert parallelism
# ---------------------------------------------------------------------------


def _pp_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _pp_loss(y, t):
    return torch.mean((y - t) ** 2)


def _pp_loss_head(p, y, t):
    return torch.mean((y @ p["head"] - t) ** 2)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


def p2p_case(x):
    """Every shift of ``comm``'s pipeline wire over pp = world: the value
    each rank receives for ``x * (rank + 1)`` and the gradient of its
    input for the cotangent ``y * 3 + rank``, cyclic and not, forward
    and backward; and the call log of one shift."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer.pipeline_parallel import (
        p2p_communication as p2p,
    )

    world = torch.distributed.get_world_size()
    ps.initialize_model_parallel(1, world)
    try:
        rank = ps.get_pipeline_model_parallel_rank()
        out = {}
        for name in ("send_forward_recv_forward",
                     "send_backward_recv_backward"):
            for cyclic in (False, True):
                inp = (torch.from_numpy(x) * (rank + 1)).requires_grad_(True)
                y = getattr(p2p, name)(inp, cyclic=cyclic)
                (g,) = torch.autograd.grad(y, inp, y.detach() * 3 + rank)
                out[(name, cyclic)] = (_np(y), _np(g))
        with comm.collective_log() as log:
            p2p.send_forward_recv_forward(torch.from_numpy(x))
        out["log"] = [dict(r) for r in log]
        return out
    finally:
        ps.destroy_model_parallel()


def pipeline_case(stacked, inputs, targets, cases):
    """Each case ``(name, schedule, kwargs)`` over pp = world on this
    rank's stages of ``stacked`` (numpy leaves (pp·vpp, ...), virtual
    stage ``c·pp + r`` on rank r): ``(losses, grads)``.  ``kwargs``
    takes ``vpp`` (chunks, stacked) and ``head`` (the loss through the
    stage's ``head`` leaf, ``loss_takes_params=True``)."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.transformer import pipeline_parallel as pl

    world = torch.distributed.get_world_size()
    out = {}
    for name, schedule, kwargs in cases:
        kwargs = dict(kwargs)
        vpp = kwargs.pop("vpp", None)
        head = kwargs.pop("head", False)
        ps.initialize_model_parallel(1, world, vpp)
        try:
            r = ps.get_pipeline_model_parallel_rank()
            if vpp:
                params = {k: torch.from_numpy(np.stack(
                    [v[c * world + r] for c in range(vpp)]))
                    for k, v in stacked.items()}
            else:
                params = {k: torch.from_numpy(v[r].copy())
                          for k, v in stacked.items()}
            if not head:
                params.pop("head", None)
            losses, grads = getattr(pl, schedule)(
                _pp_stage, _pp_loss_head if head else _pp_loss, params,
                (torch.from_numpy(inputs), torch.from_numpy(targets)),
                num_microbatches=inputs.shape[0], loss_takes_params=head,
                **kwargs)
            out[name] = (_np(losses),
                         None if grads is None else _tree_np(grads))
        finally:
            ps.destroy_model_parallel()
    return out


def _cp_local(x, world, rank, layout, axis=2):
    from apex_tpu_torch.transformer.context_parallel import zigzag_shard

    t = torch.from_numpy(x)
    if layout == "zigzag":
        return zigzag_shard(t, rank, world, axis=axis).contiguous()
    n = t.shape[axis] // world
    return t.narrow(axis, rank * n, n).contiguous()


def _drop_dlse():
    """Plant the ring's fault: K4's twin fed no lse cotangent."""
    from apex_tpu_torch.ops import attention

    orig = attention._Flash.backward

    def backward(ctx, do, dlse):
        return orig(ctx, do, None)

    attention._Flash.backward = staticmethod(backward)
    return lambda: setattr(attention._Flash, "backward", staticmethod(orig))


def cp_case(q, k, v, bias, cases, seed):
    """Each case ``(name, kind, kwargs)`` over cp = world on this rank's
    rows of the global (B, H, S, D) q, k, v (and the (B, 1, 1, S)
    key-padding ``bias`` when ``kwargs["bias"]``): kind "ring",
    "zigzag" or "ulysses"; ``kwargs`` takes ``causal``, ``dropout_p``
    (seeded by the int32 ``seed``) and ``fault="dlse"``.  Returns the
    local output and the q/k/v gradients for the cotangent ``2 * out``.
    Also the refusals that need cp > 1."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer import context_parallel as cpl

    world = torch.distributed.get_world_size()
    ps.initialize_model_parallel(1, 1, None, world)
    try:
        r = ps.get_context_parallel_rank()
        out = {}
        for name, kind, kw in cases:
            kw = dict(kw)
            layout = "zigzag" if kind == "zigzag" else "contiguous"
            loc = [_cp_local(a, world, r, layout).requires_grad_(True)
                   for a in (q, k, v)]
            b = (_cp_local(bias, world, r, layout, axis=3)
                 if kw.pop("bias", False) else None)
            fault = kw.pop("fault", None)
            if kw.get("dropout_p"):
                kw["dropout_seed"] = torch.tensor([seed], dtype=torch.int32)
            undo = _drop_dlse() if fault == "dlse" else None
            try:
                with comm.collective_log() as log:
                    if kind == "ulysses":
                        o = cpl.ulysses_attention(*loc, b, **kw)
                    else:
                        o = cpl.ring_attention(*loc, b, layout=layout, **kw)
                    grads = torch.autograd.grad(o, loc, 2 * o.detach())
            finally:
                if undo:
                    undo()
            out[name] = (_np(o), [_np(g) for g in grads],
                         comm.collective_summary(log))
        errors = {}
        qq = torch.zeros(1, 3, 4, 8)
        for probe, fn in (
            ("heads", lambda: cpl.ulysses_attention(qq, qq, qq)),
            ("ulysses_bias", lambda: cpl.ulysses_attention(
                torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8),
                torch.zeros(1, 2, 4, 8), torch.zeros(1, 1, 4, 4))),
        ):
            try:
                fn()
                errors[probe] = None
            except ValueError as e:
                errors[probe] = str(e)
        out["errors"] = errors
        return out
    finally:
        ps.destroy_model_parallel()


def gpt_cp_case(params_np, cfg_kwargs, ids, modes, experts=0):
    """GPT under cp = world in each mode ("ring", "ring_zigzag",
    "ulysses") from the JAX tree ``params_np``: ``gpt_lm_loss_cp`` on
    this rank's rows of ``ids`` (S, B), its gradients as the rank has
    them, and after the mean over cp (JAX tree layout)."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.models import convert
    from apex_tpu_torch.models.gpt import GptConfig, gpt_lm_loss_cp
    from apex_tpu_torch.parallel import comm

    world = torch.distributed.get_world_size()
    out = {}
    for mode in modes:
        ps.initialize_model_parallel(1, 1, None, world)
        try:
            cfg = GptConfig(**cfg_kwargs, dtype=torch.float32,
                            context_parallel=mode, num_experts=experts)
            model = convert.from_jax_params(params_np, cfg, device="cpu")
            r = ps.get_context_parallel_rank()
            local = _cp_local(ids, world, r,
                              "zigzag" if mode == "ring_zigzag"
                              else "contiguous", axis=0)
            with comm.collective_log() as log:
                loss = gpt_lm_loss_cp(model, local)
                loss.backward()
            grads = {n: p.grad for n, p in model.named_parameters()}
            rank_grads = convert.to_jax_params(
                model, {n: g.clone() for n, g in grads.items()})
            comm.sync_gradients(list(grads.values()), "cp")
            out[mode] = (float(loss.detach()), rank_grads,
                         convert.to_jax_params(model, grads),
                         comm.collective_summary(log))
        finally:
            ps.destroy_model_parallel()
    return out


def moe_case(router, w1, w2, x, cfg_kwargs, with_sync):
    """SwitchMoe at ep = dp = world over this rank's batch columns of
    ``x`` (S, B, H), the experts cut from the global (E, ...) weights:
    the output, the aux loss, the gradients of ``mean(y**2) + 0.01 aux``
    (before and, with ``with_sync``, after ``sync_moe_gradients``), the
    call log; and the ep-invariant init (this rank's seeded experts)."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer.moe import (
        MoeConfig,
        SwitchMoe,
        sync_moe_gradients,
    )

    world = torch.distributed.get_world_size()
    ps.initialize_model_parallel(1)
    try:
        r = ps.get_data_parallel_rank()
        cfg = MoeConfig(**cfg_kwargs, dtype=torch.float32)
        m = SwitchMoe(cfg, device="cpu")
        e_l = cfg.num_experts // world
        seeded = {n: _np(p) for n, p in m.named_parameters()}
        with torch.no_grad():
            m.router.copy_(torch.from_numpy(router))
            m.expert_w1.copy_(torch.from_numpy(w1[r * e_l:(r + 1) * e_l]))
            m.expert_w2.copy_(torch.from_numpy(w2[r * e_l:(r + 1) * e_l]))
        xl = torch.from_numpy(x).chunk(world, dim=1)[r].contiguous()
        with comm.collective_log() as log:
            y, aux = m(xl)
            loss = torch.mean(y ** 2) + 0.01 * aux
            loss.backward()
        raw = {n: _np(p.grad) for n, p in m.named_parameters()}
        synced = None
        if with_sync:
            sync_moe_gradients(m)
            synced = {n: _np(p.grad) for n, p in m.named_parameters()}
        return dict(y=_np(y), aux=float(aux), raw=raw, synced=synced,
                    log=comm.collective_summary(log), seeded=seeded)
    finally:
        ps.destroy_model_parallel()


def moe_stats_case(logits, top_k, capacity, scales):
    """``moe_dispatch_combine`` with its stats averaged over cp = world
    on this rank's rows of the global router ``logits``: for each
    ``stats_grad_scale`` in ``scales``, the aux loss and the gradient of
    ``aux + sum(combine * w)`` (w fixed) w.r.t. the rank's logits."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.transformer.moe import moe_dispatch_combine

    world = torch.distributed.get_world_size()
    ps.initialize_model_parallel(1, 1, None, world)
    try:
        r = ps.get_context_parallel_rank()
        out = {}
        for scale in scales:
            lg = torch.from_numpy(logits).chunk(world)[r].clone()
            lg.requires_grad_(True)
            probs = torch.softmax(lg, dim=-1)
            d, c, aux = moe_dispatch_combine(probs, top_k, capacity, "cp",
                                             scale)
            w = torch.arange(c.numel(), dtype=torch.float32).reshape(
                c.shape) / c.numel()
            (g,) = torch.autograd.grad(aux + (c * w).sum(), lg)
            out[scale] = (float(aux.detach()), _np(d), _np(c), _np(g))
        return out
    finally:
        ps.destroy_model_parallel()


# ---------------------------------------------------------------------------
# observability: the fleet view over the dp group
# ---------------------------------------------------------------------------


def fleet_case(names, rows, values, every, local_world_size):
    """``FleetAggregator`` over the dp group: ``gather_rows(rows)`` (each
    rank contributes its own row); the double buffer over ``values``
    (a list of per-step ``(world, n)`` rows: rank r observes row r), with
    the gathers dispatched and the handles waited on after each step;
    ``fetch()``; the straggler rule over the gathered rows; and the host
    map with ``LOCAL_WORLD_SIZE`` set to ``local_world_size`` (as a
    launcher sets it)."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.observability import FleetAggregator, FleetView
    from apex_tpu_torch.observability.health import StragglerRule, Watchdog

    ps.initialize_model_parallel()
    os.environ["LOCAL_WORLD_SIZE"] = str(local_world_size)
    try:
        rank = ps.get_data_parallel_rank()
        agg = FleetAggregator(names, every=every, publish=False)
        out = {"gathered": agg.gather_rows(rows), "cadence": []}
        agg.gathers = agg.waits = 0
        for step, row in enumerate(values):
            agg.observe(step, dict(zip(names, (float(v) for v in
                                              row[rank]))))
            view = agg.view()
            out["cadence"].append((agg.gathers, agg.waits,
                                   None if view is None else view.step))
        view = agg.fetch()
        out["fetched"] = (view.step, view.rows.copy(), view.labels)
        agg._view = FleetView(10, agg.names, agg.gather_rows(rows))
        wd = Watchdog([StragglerRule(zmax=3.0)], fleet=agg)
        out["events"] = [(e.rule, e.host, e.value, e.message)
                         for e in wd.check(10)]
        out["collapsed"] = agg._collapse(9, rows)
        out["row_host"] = list(agg._row_host)
        return out
    finally:
        os.environ.pop("LOCAL_WORLD_SIZE", None)
        ps.destroy_model_parallel()


# ---------------------------------------------------------------------------
# the ImageNet amp example
# ---------------------------------------------------------------------------


def imagenet_case(argv, variables_path, model_kwargs):
    """``examples.imagenet.main_amp.main(argv)`` on this rank, the model
    a ``ResNetConfig(**model_kwargs)`` holding the JAX model's variables
    (a pickle of numpy arrays): the losses and the model's running
    statistics at the end, in the JAX layout."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.examples.imagenet import main_amp
    from apex_tpu_torch.models import resnet

    try:
        args = main_amp.parse_args(list(argv))
        cfg = resnet.resnet50_config(**model_kwargs,
                                     num_classes=args.num_classes,
                                     use_syncbn=args.sync_bn,
                                     dtype=torch.float32)
        model = resnet.from_jax_variables(_load(variables_path), cfg,
                                          device="cpu")
        out = main_amp.main(list(argv), model=model)
        return {"losses": out["losses"],
                "batch_stats": resnet.to_jax_variables(
                    out["model"])["batch_stats"]}
    finally:
        ps.destroy_model_parallel()

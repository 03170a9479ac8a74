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

"""GPT causal-LM training over the parallelism menu: data, tensor
(+ sequence), context and expert parallelism.

The port's counterpart of ``examples/gpt/train_gpt.py``: ``GptModel`` ->
``gpt_lm_loss`` (``gpt_lm_loss_cp`` under ``--context-parallel``) ->
``loss.backward()`` -> the sequence-parallel gradient sum (``--tp > 1
--sequence-parallel``) -> the dp sync (``DistributedDataParallel``, the
reduce-scatter of ``DistributedFusedAdam`` with ``--zero``, or
``sync_moe_gradients`` with ``--num-experts``, which leaves the
dp-sharded experts unreduced) -> the mean over cp -> the optimizer
step, over the packed-corpus loader.  ``--tp`` shards the model over tp
ranks and ``--cp`` (with ``--context-parallel ring|ring_zigzag|
ulysses``) the sequence over cp ranks; dp is the world over tp * cp,
each dp rank trains on its columns of the global ``--batch`` and each cp
rank on its rows of them (contiguous, or the zigzag pair).  Experts
shard over dp.  On the card every LayerNorm and attention call runs
through the hand-written kernels K1-K4 in both directions.

    python -m apex_tpu_torch.examples.train_gpt --steps 8 --batch 8 --seq-len 2048
    # tp = 2 with sequence parallelism on two cards:
    torchrun --nproc-per-node 2 -m apex_tpu_torch.examples.train_gpt \
        --tp 2 --sequence-parallel --steps 8 --batch 8 --seq-len 2048
    # ring attention over cp = 2 ranks, 8 experts:
    torchrun --nproc-per-node 2 -m apex_tpu_torch.examples.train_gpt \
        --context-parallel ring --cp 2 --seq-len 4096
    python -m apex_tpu_torch.examples.train_gpt --num-experts 8
    # tiny f32 run on the CPU (the plain PyTorch versions):
    python -m apex_tpu_torch.examples.train_gpt --tiny --device cpu --steps 3

Without ``--data`` it trains on a synthetic zipf corpus that it writes
once into the temporary directory.  ``--tiny`` is the CPU configuration
(f32, head dim 16).  The rendezvous flags (``--backend``,
``--init-method``, ``--world-size``, ``--rank``) are those of
:mod:`apex_tpu_torch.examples._launch`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.data import DataLoader, TokenFileDataset, synthetic_token_corpus
from apex_tpu_torch.examples._launch import (
    add_distributed_args,
    start_distributed,
)
from apex_tpu_torch.models.gpt import (
    GptConfig,
    GptModel,
    gpt_lm_loss,
    gpt_lm_loss_cp,
)
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import (
    DistributedDataParallel,
    DistributedFusedAdam,
    comm,
)
from apex_tpu_torch.transformer.context_parallel import zigzag_shard
from apex_tpu_torch.transformer.moe import sync_moe_gradients
from apex_tpu_torch.transformer.tensor_parallel import (
    allreduce_sequence_parallel_gradients,
)

__all__ = ["TrainRun", "build", "main", "parse_args", "train", "train_step"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--batch", type=int, default=8, help="global batch")
    p.add_argument("--seq-len", type=int, default=512, help="global seq len")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sequence-parallel", action="store_true")
    p.add_argument("--context-parallel",
                   choices=["ring", "ring_zigzag", "ulysses"], default=None)
    p.add_argument("--cp", type=int, default=2, help="cp degree when used")
    p.add_argument("--num-experts", type=int, default=0)
    p.add_argument("--zero", action="store_true",
                   help="shard the Adam update over dp (DistributedFusedAdam)")
    p.add_argument("--wire", choices=["f32", "bf16", "int8"], default="f32",
                   help="the dp gradient sync's wire format")
    p.add_argument("--data", default=None, help="packed uint16 token file")
    p.add_argument("--num-layers", type=int, default=None,
                   help="depth (default: the configuration's)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    add_distributed_args(p)
    return p.parse_args(argv)


def context_parallel_size(args) -> int:
    return args.cp if args.context_parallel else 1


def check_args(args, dp: int) -> None:
    """The reference's refusals: the batch over dp, the sequence over cp
    (over 2·cp under zigzag); and ``--zero``, which shards the update
    over dp, beside the experts or cp."""
    cp = context_parallel_size(args)
    if args.batch % dp:
        raise ValueError(f"--batch ({args.batch}) must be divisible by "
                         f"dp={dp}")
    if args.seq_len % cp:
        raise ValueError(f"--seq-len ({args.seq_len}) must be divisible "
                         f"by cp={cp}")
    if args.context_parallel == "ring_zigzag" and args.seq_len % (2 * cp):
        # two chunks a rank: a cp-divisible length would drop tokens
        raise ValueError(f"--seq-len ({args.seq_len}) must be divisible "
                         f"by 2*cp={2 * cp} for ring_zigzag")
    if args.zero and (args.num_experts or cp > 1):
        raise ValueError("--zero shards the update over dp: it takes "
                         "neither --num-experts nor --context-parallel")


def corpus(args, vocab: int) -> str:
    if args.data:
        return args.data
    return synthetic_token_corpus(
        os.path.join(tempfile.gettempdir(),
                     f"apex_tpu_torch_gpt_corpus_v{vocab}.bin"),
        vocab_size=vocab, zipf_a=1.2, seed=1,
    )


def config(args) -> GptConfig:
    dims = (
        dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, dtype=torch.float32)
        if args.tiny
        else dict(vocab_size=50304, remat=True)
    )
    if args.num_layers is not None:
        dims["num_layers"] = args.num_layers
    return GptConfig(**dims, max_seq_len=args.seq_len,
                     sequence_parallel=args.sequence_parallel,
                     context_parallel=args.context_parallel,
                     num_experts=args.num_experts)


def loss_fn(model: GptModel, ids):
    """The step's loss: ``gpt_lm_loss_cp`` over cp ranks, else
    ``gpt_lm_loss``."""
    if model.cfg.context_parallel and ps.axis_size(ps.CONTEXT_PARALLEL_AXIS) > 1:
        return gpt_lm_loss_cp(model, ids)
    return gpt_lm_loss(model, ids)


def local_rows(ids: torch.Tensor, cfg: GptConfig) -> torch.Tensor:
    """This cp rank's rows of a (S, B) batch: contiguous, or the zigzag
    pair of chunks."""
    cp = ps.axis_size(ps.CONTEXT_PARALLEL_AXIS)
    if not cfg.context_parallel or cp == 1:
        return ids
    rank = ps.axis_rank(ps.CONTEXT_PARALLEL_AXIS)
    if cfg.context_parallel == "ring_zigzag":
        return zigzag_shard(ids, rank, cp, axis=0)
    s = ids.shape[0] // cp
    return ids[rank * s:(rank + 1) * s]


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` did: the per-step losses and host seconds (the
    device synchronised before and after each step), and the state to go
    on from."""

    cfg: GptConfig
    model: GptModel
    optimizer: object
    batches: Iterator[torch.Tensor]
    losses: List[float]
    step_seconds: List[float]
    tokens_per_step: int
    ddp: Optional[DistributedDataParallel] = None


def build(args):
    """``(cfg, model, optimizer, batches, ddp)``: the process group and
    the tp/cp/dp groups (:func:`start_distributed`), the model (seed 0,
    this rank's tp and expert shards) on ``args.device``, FusedAdam (or
    DistributedFusedAdam with ``--zero``), an endless iterator of this
    rank's (S / cp, B / dp) int64 tokens on that device, and the DDP
    wrapper (None with ``--zero`` or ``--num-experts``)."""
    dev = resolve_device(args.device)
    start_distributed(args, args.tp,
                      context_parallel_size=context_parallel_size(args))
    dp = ps.get_data_parallel_world_size()
    check_args(args, dp)
    cfg = config(args)
    model = GptModel(cfg, device=dev)  # weights seeded with 0
    ddp = None
    if args.zero:
        opt = DistributedFusedAdam(model.parameters(), lr=args.lr,
                                   wire=args.wire)
    else:
        opt = FusedAdam(model.parameters(), lr=args.lr)
        if not cfg.num_experts:
            ddp = DistributedDataParallel(model, loss_fn, wire=args.wire)
    ds = TokenFileDataset(corpus(args, cfg.vocab_size), seq_len=args.seq_len)
    loader = DataLoader(ds, batch_size=args.batch, seed=7)
    per = args.batch // dp
    lo = ps.get_data_parallel_rank() * per
    batches = (local_rows(torch.as_tensor(b[lo:lo + per].T.astype(np.int64),
                                          device=dev), cfg)
               for b in loader)
    return cfg, model, opt, batches, ddp


def train_step(model: GptModel, opt, ids: torch.Tensor,
               ddp: Optional[DistributedDataParallel] = None):
    """One step on this rank's token ids (S / cp, B / dp); returns the
    loss (a device scalar: the dp mean under ``ddp``, a ZeRO optimizer
    or experts).  Without ``ddp`` and at world 1, the plain FusedAdam
    step."""
    cfg = model.cfg
    sp_tp = cfg.sequence_parallel and ps.axis_size(ps.TENSOR_PARALLEL_AXIS) > 1
    if ddp is not None:
        loss, _ = ddp.value_and_grad(ids)
    else:
        loss = loss_fn(model, ids)
        loss.backward()
    if cfg.num_experts:
        sync_moe_gradients(
            model, sequence_parallel_axis=(ps.TENSOR_PARALLEL_AXIS
                                           if sp_tp else None))
        loss = comm.mean_over(loss)
    elif cfg.sequence_parallel:
        allreduce_sequence_parallel_gradients(model)
    if ps.axis_size(ps.CONTEXT_PARALLEL_AXIS) > 1:
        # cp is a data axis for the gradients
        comm.sync_gradients([p.grad for p in model.parameters()
                             if p.grad is not None],
                            ps.CONTEXT_PARALLEL_AXIS)
    opt.step()
    opt.zero_grad(set_to_none=True)
    if ddp is None and isinstance(opt, DistributedFusedAdam):
        return comm.mean_over(loss)
    return loss.detach()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(args) -> TrainRun:
    cfg, model, opt, batches, ddp = build(args)
    n_params = sum(p.numel() for p in model.parameters())
    mesh = ps.get_mesh()
    print(f"GPT {n_params / 1e6:.1f}M params/rank | device={model.device} "
          f"batch={args.batch} seq_len={args.seq_len} remat={cfg.remat} "
          f"dp={mesh.shape['dp']} tp={mesh.shape['tp']} "
          f"cp={mesh.shape['cp']}({cfg.context_parallel or '-'}) "
          f"sp={cfg.sequence_parallel} experts={cfg.num_experts} "
          f"zero={args.zero} wire={args.wire}",
          flush=True)
    losses, seconds = [], []
    for step in range(args.steps):
        ids = next(batches)
        _sync(model.device)
        t0 = time.perf_counter()
        loss = train_step(model, opt, ids, ddp)
        losses.append(float(loss))
        _sync(model.device)
        seconds.append(time.perf_counter() - t0)
        print(f"step {step}: loss {losses[-1]:.4f} "
              f"{seconds[-1] * 1e3:.1f} ms", flush=True)
    return TrainRun(cfg, model, opt, batches, losses, seconds,
                    args.batch * args.seq_len, ddp)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Parse ``argv``, train, and return the per-step losses."""
    return train(parse_args(argv)).losses


if __name__ == "__main__":
    main()

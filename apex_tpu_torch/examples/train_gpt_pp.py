"""Pipeline-parallel GPT-style LM training: the pipeline schedules end
to end.

The port's counterpart of ``examples/gpt/train_gpt_pp.py``, with its
flags and defaults:

- the **uniform-stage contract**: every pp rank runs the same
  ``stage_fn`` over a ``BertEncoderCore`` of ``--layers / (pp·chunks)``
  layers; rank 0's first chunk also embeds (the token ids ride in
  channel 0 of the activation and are swapped for the embedding);
- ``loss_takes_params=True``: the last rank computes the cross entropy
  through the **tied unembedding** (the embedding table in its own
  stage params), Megatron's post-process pattern;
- the **embedding-grad all-reduce across pp** (Megatron's
  ``allreduce_embedding_grads``): rank 0's embedding gradient and the
  last rank's tied-head gradient are summed over pp, so every rank's
  copy stays identical;
- the 1F1B schedule, the hand-scheduled one (``--hand-1f1b``, with
  ``--stash``), or with ``--vpp`` the interleaved ones, then FusedAdam
  on each stage.

One process per pp rank, through :mod:`._launch` as the other examples:

    torchrun --nproc-per-node 4 -m apex_tpu_torch.examples.train_gpt_pp --pp 4
    # two ranks over gloo sharing one card, two chunks a rank:
    STORE=$(mktemp -u); for r in 0 1; do python -m \\
        apex_tpu_torch.examples.train_gpt_pp --pp 2 --vpp 2 --backend gloo \\
        --init-method file://$STORE --world-size 2 --rank $r & done; wait

The reference's ``--real-tpu`` has no counterpart: the port runs on the
card unless ``--device cpu`` asks otherwise.  Each stage holds its own
draws (a generator seeded from its rank and chunk), the embedding the
same on every rank.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.examples._launch import (
    add_distributed_args,
    start_distributed,
)
from apex_tpu_torch.models.bert import BertConfig, BertEncoderCore, LayerNorm
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import comm
from apex_tpu_torch.train.trainer import module_loss, module_params
from apex_tpu_torch.transformer.pipeline_parallel import (
    forward_backward_pipelining_1f1b,
    forward_backward_pipelining_interleaved_1f1b,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
)

__all__ = ["main", "parse_args", "stage_fns", "init_stage_params"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pp", type=int, default=4)
    p.add_argument("--vpp", type=int, default=0,
                   help="virtual chunks/rank (0 = non-interleaved)")
    p.add_argument("--hand-1f1b", action="store_true",
                   help="the hand-scheduled 1F1B (explicit stash) instead "
                        "of the checkpointed one; with --vpp, the hand "
                        "interleaved schedule")
    p.add_argument("--stash", choices=["residuals", "input"],
                   default="residuals",
                   help="what a hand-1F1B in-flight microbatch keeps "
                        "(residuals = no recompute, input = least memory)")
    p.add_argument("--layers", type=int, default=4, help="total layers")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--nm", type=int, default=4, help="microbatches/step")
    p.add_argument("--mb", type=int, default=2, help="microbatch size")
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--device", default="cuda")
    add_distributed_args(p)
    return p.parse_args(argv)


@torch.no_grad()
def init_core(core: torch.nn.Module, generator: torch.Generator) -> None:
    """The BERT init on a stage's layers: matmul weights N(0, 1/fan_in),
    biases 0, LayerNorm scale 1 and bias 0."""
    for mod in core.modules():
        if isinstance(mod, (ColumnParallelLinear, RowParallelLinear)):
            mod.load_full_(torch.randn(
                (mod.output_size, mod.input_size), generator=generator,
                device=generator.device) * mod.input_size ** -0.5)
            mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()


def init_stage_params(core, rank: int, chunk: int, vocab: int, hidden: int,
                      device) -> dict:
    """One chunk's params: the core drawn from a generator seeded with
    the rank and chunk, the embedding N(0, 1/H) from seed 99 (the same
    on every rank and chunk), and ``is_chunk0`` (only virtual stage 0
    embeds; an f32 flag whose gradient is zeroed before the update)."""
    gen = torch.Generator(device="cpu").manual_seed(1000 * rank + 17 + chunk)
    init_core(core, gen)
    embed = torch.randn((vocab, hidden), generator=torch.Generator(
        device="cpu").manual_seed(99)) / np.sqrt(hidden)
    return {"core": {k: v.clone() for k, v in module_params(core).items()},
            "embed": embed.to(device),
            "is_chunk0": torch.tensor(float(chunk == 0), device=device)}


def stage_fns(core, vocab: int, hidden: int):
    """``(stage_fn, loss_fn)`` of the uniform stage over ``core``."""
    run_core = module_loss(core, lambda m, h: m(h))

    def stage_fn(p, x):
        # only the first virtual stage consumes the ids
        if ps.is_pipeline_first_stage(ignore_virtual=True):
            ids = x[..., 0].long().clamp(0, vocab - 1)
            emb = p["embed"][ids] * float(np.sqrt(hidden))
            x = torch.where(p["is_chunk0"] > 0, emb, x)
        return run_core(p["core"], x)

    def loss_fn(p, y, tgt):
        # the tied unembedding through this rank's copy of the table
        logits = torch.einsum("sbh,vh->sbv", y, p["embed"])
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, tgt[..., None]).mean()

    return stage_fn, loss_fn


def _schedule(args):
    if args.vpp and args.hand_1f1b:
        return (f"hand-interleaved-1F1B vpp={args.vpp} stash={args.stash}",
                forward_backward_pipelining_interleaved_1f1b,
                dict(num_model_chunks=args.vpp, stash=args.stash))
    if args.vpp:
        return (f"interleaved vpp={args.vpp}",
                forward_backward_pipelining_with_interleaving,
                dict(num_model_chunks=args.vpp))
    if args.hand_1f1b:
        return (f"hand-1F1B stash={args.stash}",
                forward_backward_pipelining_1f1b, dict(stash=args.stash))
    return "1F1B", forward_backward_pipelining_without_interleaving, {}


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Parse ``argv``, train, and return the per-step mean losses."""
    args = parse_args(argv)
    pp, vpp = args.pp, args.vpp
    n_chunks = max(vpp, 1)
    if args.layers % (pp * n_chunks):
        raise SystemExit("--layers must divide pp * max(vpp, 1)")
    if vpp and args.nm % pp:
        raise SystemExit("interleaving requires --nm divisible by --pp")
    dev = resolve_device(args.device)
    start_distributed(args, 1, pipeline_model_parallel_size=pp,
                      virtual_pipeline_model_parallel_size=vpp or None)
    if ps.get_data_parallel_world_size() != 1:
        raise SystemExit("the example runs one process per pp rank "
                         "(world size = --pp)")
    rank = ps.get_pipeline_model_parallel_rank()
    H, V, S, MB = args.hidden, args.vocab, args.seq, args.mb
    cfg = BertConfig(vocab_size=V, hidden_size=H, num_layers=args.layers,
                     num_heads=4, intermediate_size=4 * H,
                     max_position_embeddings=S, dtype=torch.float32)
    core = BertEncoderCore(cfg, args.layers // (pp * n_chunks), dev)
    chunks = [init_stage_params(core, rank, c, V, H, dev)
              for c in range(n_chunks)]
    if vpp:
        params = {"core": {k: torch.stack([c["core"][k] for c in chunks])
                           for k in chunks[0]["core"]},
                  "embed": torch.stack([c["embed"] for c in chunks]),
                  "is_chunk0": torch.stack([c["is_chunk0"]
                                            for c in chunks])}
    else:
        params = chunks[0]
    names = sorted(params["core"])
    leaves = [params["embed"], params["is_chunk0"],
              *(params["core"][k] for k in names)]
    opt = FusedAdam(leaves, lr=args.lr)
    stage_fn, loss_fn = stage_fns(core, V, H)
    name, schedule, kw = _schedule(args)

    # a fixed random LM task (next token over a zipf stream)
    rs = np.random.RandomState(0)
    tokens = rs.zipf(1.5, size=200_000) % V

    def batch(step):
        r = np.random.RandomState(1000 + step)
        starts = r.randint(0, len(tokens) - S - 1, size=(args.nm, MB))
        ids = np.stack([[tokens[s:s + S + 1] for s in row] for row in starts])
        ids = torch.as_tensor(ids, device=dev)  # (nm, MB, S + 1)
        x = torch.zeros((args.nm, S, MB, H), device=dev)
        x[..., 0] = ids[..., :-1].transpose(1, 2).float()
        return x, ids[..., 1:].transpose(1, 2).contiguous()

    print(f"pipeline LM: pp={pp} ({name}), layers={args.layers}, "
          f"nm={args.nm}, mb={MB}, seq={S}, device={dev}", flush=True)
    out = []
    for step in range(args.steps):
        xs, tgts = batch(step)
        t0 = time.perf_counter()
        losses, grads = schedule(stage_fn, loss_fn, params, (xs, tgts),
                                 num_microbatches=args.nm,
                                 loss_takes_params=True, **kw)
        # allreduce_embedding_grads: the input embedding's and the tied
        # head's gradients summed over pp
        comm.all_reduce(grads["embed"], ps.get_pipeline_model_parallel_group())
        grads["is_chunk0"].zero_()
        for leaf, g in zip(leaves, [grads["embed"], grads["is_chunk0"],
                                    *(grads["core"][k] for k in names)]):
            leaf.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        loss = float(losses.mean())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"step {step:3d}  loss {loss:7.4f}  "
              f"({(time.perf_counter() - t0) * 1e3:6.1f} ms)", flush=True)
        if not np.isfinite(loss):
            raise SystemExit("non-finite loss")
        out.append(loss)
    ps.destroy_model_parallel()
    return out


if __name__ == "__main__":
    main()

"""GPT causal-LM training on one GPU.

The port's counterpart of ``examples/gpt/train_gpt.py`` at tensor and
context parallelism 1 and no experts: ``GptModel`` -> ``gpt_lm_loss`` ->
``loss.backward()`` -> ``FusedAdam.step()`` over the packed-corpus
loader.  On the card every LayerNorm and attention call runs through
the hand-written kernels K1-K4 in both directions.

    python -m apex_tpu_torch.examples.train_gpt --steps 8 --batch 8 --seq-len 2048
    # tiny f32 run on the CPU (the plain PyTorch versions):
    python -m apex_tpu_torch.examples.train_gpt --tiny --device cpu --steps 3

Without ``--data`` it trains on a synthetic zipf corpus that it writes
once into the temporary directory.  ``--tiny`` is the CPU configuration
(f32, head dim 16): the card's flash kernels take bf16 and head dim 64.
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

from apex_tpu_torch.data import DataLoader, TokenFileDataset, synthetic_token_corpus
from apex_tpu_torch.models.gpt import GptConfig, GptModel, gpt_lm_loss
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import FusedAdam

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
    p.add_argument("--num-experts", type=int, default=0)
    p.add_argument("--data", default=None, help="packed uint16 token file")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _check_single_gpu(args) -> None:
    unported = [
        name for name, on in (
            (f"--tp {args.tp}", args.tp != 1),
            ("--sequence-parallel", args.sequence_parallel),
            (f"--context-parallel {args.context_parallel}",
             args.context_parallel is not None),
            (f"--num-experts {args.num_experts}", args.num_experts != 0),
        ) if on
    ]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: tensor, sequence and context "
            "parallelism and experts are not ported yet (ROADMAP items 5 and 7); "
            "the example trains on one GPU"
        )


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
    return GptConfig(**dims, max_seq_len=args.seq_len)


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` did: the per-step losses and host seconds (the
    device synchronised before and after each step), and the state to go
    on from."""

    cfg: GptConfig
    model: GptModel
    optimizer: FusedAdam
    batches: Iterator[torch.Tensor]
    losses: List[float]
    step_seconds: List[float]
    tokens_per_step: int


def build(args):
    """``(cfg, model, optimizer, batches)``: the model (seed 0) on
    ``args.device``, FusedAdam, and an endless iterator of (S, B) int64
    token batches on that device."""
    _check_single_gpu(args)
    dev = resolve_device(args.device)
    cfg = config(args)
    model = GptModel(cfg, device=dev)  # weights seeded with 0
    opt = FusedAdam(model.parameters(), lr=args.lr)
    ds = TokenFileDataset(corpus(args, cfg.vocab_size), seq_len=args.seq_len)
    loader = DataLoader(ds, batch_size=args.batch, seed=7)
    batches = (torch.as_tensor(b.T.astype(np.int64), device=dev)
               for b in loader)
    return cfg, model, opt, batches


def train_step(model: GptModel, opt: FusedAdam, ids: torch.Tensor):
    """One step on token ids (S, B); returns the loss (a device scalar)."""
    loss = gpt_lm_loss(model, ids)
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss.detach()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(args) -> TrainRun:
    cfg, model, opt, batches = build(args)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"GPT {n_params / 1e6:.1f}M params | device={model.device} "
          f"batch={args.batch} seq_len={args.seq_len} remat={cfg.remat}",
          flush=True)
    losses, seconds = [], []
    for step in range(args.steps):
        ids = next(batches)
        _sync(model.device)
        t0 = time.perf_counter()
        loss = train_step(model, opt, ids)
        losses.append(float(loss))
        _sync(model.device)
        seconds.append(time.perf_counter() - t0)
        print(f"step {step}: loss {losses[-1]:.4f} "
              f"{seconds[-1] * 1e3:.1f} ms", flush=True)
    return TrainRun(cfg, model, opt, batches, losses, seconds,
                    args.batch * args.seq_len)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Parse ``argv``, train, and return the per-step losses."""
    return train(parse_args(argv)).losses


if __name__ == "__main__":
    main()

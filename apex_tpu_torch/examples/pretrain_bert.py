"""BERT-Large phase-1 pretraining on one GPU.

The port's counterpart of ``examples/bert/pretrain_bert.py`` at data
parallelism 1: the packed-corpus loader -> the MLM corruption and the
fixed-K prediction triple (``bert_mlm_batches``) ->
``BertForPreTraining(BertConfig(remat=True))`` -> ``bert_pretrain_loss``
-> ``loss.backward()`` -> ``FusedLAMB.step()`` (lr 1e-3, weight decay
0.01), bf16 compute on f32 weights.  On the card every LayerNorm runs
through K1/K2 and every attention through K3/K4 with the key-padding
bias.

    python -m apex_tpu_torch.examples.pretrain_bert --steps 8 --batch 128
    # tiny f32 run on the CPU (the plain PyTorch versions):
    python -m apex_tpu_torch.examples.pretrain_bert --tiny --device cpu --steps 3

Without ``--data`` it trains on a synthetic zipf corpus (ids 1000 and
up) that it writes once into the temporary directory.  ``--tiny`` is the
CPU configuration (f32, head dim 16): the card's flash kernels take
bf16 and head dim 64.  The JAX example's ``--chunk`` (steps per jitted
scan) has no counterpart in eager PyTorch; checkpointing and data
parallelism are not ported yet (``--ckpt-dir`` and ``--resume`` raise).
:func:`train_step` trains with dropout when it is given a generator.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from apex_tpu_torch.data import (
    DataLoader,
    TokenFileDataset,
    bert_mlm_batches,
    synthetic_token_corpus,
)
from apex_tpu_torch.models.bert import (
    BertConfig,
    BertForPreTraining,
    bert_pretrain_loss,
)
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import FusedLAMB

__all__ = ["TrainRun", "build", "main", "parse_args", "train", "train_step"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--batch", type=int, default=32, help="global batch")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--data", default=None,
                   help="packed token file (uint16); default: synthesize a "
                   "corpus")
    p.add_argument("--max-predictions-per-seq", type=int, default=20,
                   help="fixed-K masked-position MLM head (0 = dense labels "
                   "over all positions)")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def config(args) -> BertConfig:
    if args.tiny:
        return BertConfig(vocab_size=2048, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128,
                          max_position_embeddings=args.seq_len,
                          dtype=torch.float32)
    return BertConfig(remat=True)


def corpus(args, vocab: int) -> str:
    if args.data:
        return args.data
    return synthetic_token_corpus(
        os.path.join(tempfile.gettempdir(),
                     f"apex_tpu_torch_bert_corpus_v{vocab}.bin"),
        vocab_size=vocab, num_tokens=2_000_000, floor=1000,
    )


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's numpy arrays as tensors on ``device``; to the card
    through pinned memory, so the copies do not wait for the card."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(value)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def batch_stream(args, cfg: BertConfig, device) -> Iterator[Dict]:
    """Endless batch dicts on ``device``.  With the fixed-K triple the
    dense labels are dropped: the loss reads only the triple."""
    ds = TokenFileDataset(corpus(args, cfg.vocab_size), seq_len=args.seq_len)
    loader = DataLoader(ds, batch_size=args.batch, seed=1234)
    stream = bert_mlm_batches(
        loader, seed=42, mask_prob=0.15, mask_id=103,
        vocab_size=cfg.vocab_size, special_floor=1000,
        max_predictions_per_seq=args.max_predictions_per_seq or None,
    )
    for batch in stream:
        if args.max_predictions_per_seq:
            batch.pop("mlm_labels")
        yield _to_device(batch, device)


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` did: the per-step losses and host seconds (the
    device synchronised before and after each step), and the state to go
    on from."""

    cfg: BertConfig
    model: BertForPreTraining
    optimizer: FusedLAMB
    batches: Iterator[Dict[str, torch.Tensor]]
    losses: List[float]
    step_seconds: List[float]
    sequences_per_step: int
    tokens_per_step: int


def build(args):
    """``(cfg, model, optimizer, batches)``: the model (seed 0) on
    ``args.device``, FusedLAMB, and the endless batch stream."""
    if args.ckpt_dir or args.resume:
        raise NotImplementedError(
            "checkpointing is not ported yet (ROADMAP A9); the example "
            "trains from a fresh seeded model"
        )
    if args.max_predictions_per_seq < 0:
        raise ValueError("--max-predictions-per-seq must be >= 0")
    dev = resolve_device(args.device)
    cfg = config(args)
    model = BertForPreTraining(cfg, device=dev)  # weights seeded with 0
    opt = FusedLAMB(model.parameters(), lr=args.lr, weight_decay=0.01)
    return cfg, model, opt, batch_stream(args, cfg, dev)


def train_step(model: BertForPreTraining, opt: FusedLAMB,
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None):
    """One step; returns the loss (a device scalar).  With a CPU
    ``generator`` the step trains with dropout (``deterministic=False``),
    its seeds drawn from it."""
    loss = bert_pretrain_loss(model, batch, deterministic=generator is None,
                              generator=generator)
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
    print(f"BERT {n_params / 1e6:.1f}M params | device={model.device} "
          f"batch={args.batch} seq_len={args.seq_len} remat={cfg.remat} "
          f"K={args.max_predictions_per_seq}", flush=True)
    losses, seconds = [], []
    for step in range(args.steps):
        batch = next(batches)
        _sync(model.device)
        t0 = time.perf_counter()
        loss = train_step(model, opt, batch)
        losses.append(float(loss))
        _sync(model.device)
        seconds.append(time.perf_counter() - t0)
        print(f"step {step}: loss {losses[-1]:.4f} "
              f"{seconds[-1] * 1e3:.1f} ms", flush=True)
    return TrainRun(cfg, model, opt, batches, losses, seconds, args.batch,
                    args.batch * args.seq_len)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Parse ``argv``, train, and return the per-step losses."""
    return train(parse_args(argv)).losses


if __name__ == "__main__":
    main()

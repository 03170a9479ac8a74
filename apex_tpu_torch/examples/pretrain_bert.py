"""BERT-Large phase-1 pretraining, data-parallel over the world.

The port's counterpart of ``examples/bert/pretrain_bert.py``: the
packed-corpus loader -> the MLM corruption and the fixed-K prediction
triple (``bert_mlm_batches``) -> this dp rank's columns of the global
batch -> ``BertForPreTraining(BertConfig(remat=True))`` ->
``bert_pretrain_loss`` -> ``loss.backward()`` under
``DistributedDataParallel`` (gradients averaged over the world; the
dp-mean loss) -> ``FusedLAMB.step()`` (lr 1e-3, weight decay 0.01),
bf16 compute on f32 weights.  The batches reach the device
through ``DevicePrefetcher`` (two batches ahead, pinned memory, as the
JAX example's ``DevicePrefetcher``).  On the card every LayerNorm runs
through K1/K2 and every attention through K3/K4 with the key-padding
bias.

    python -m apex_tpu_torch.examples.pretrain_bert --steps 8 --batch 128
    # data-parallel over two cards (global batch 128, 64 a rank):
    torchrun --nproc-per-node 2 -m apex_tpu_torch.examples.pretrain_bert \
        --steps 8 --batch 128
    # checkpoint every 2 steps, then resume from the newest checkpoint:
    python -m apex_tpu_torch.examples.pretrain_bert --steps 4 --ckpt-dir D --save-every 2
    python -m apex_tpu_torch.examples.pretrain_bert --steps 8 --ckpt-dir D --resume
    # tiny f32 run on the CPU (the plain PyTorch versions):
    python -m apex_tpu_torch.examples.pretrain_bert --tiny --device cpu --steps 3

Without ``--data`` it trains on a synthetic zipf corpus (ids 1000 and
up) that it writes once into the temporary directory.  ``--tiny`` is the
CPU configuration (f32, head dim 16): the card's flash kernels take
bf16 and head dim 64.  With ``--ckpt-dir`` the run saves the params, the
LAMB state and the step count through :class:`CheckpointManager`
(``max_to_keep=2``, every ``--save-every`` steps, a checkpoint's number
being the steps done); ``--resume`` restores the newest one in place,
seeks the batch stream to it (``bert_mlm_batches(start_step=...)``) and
trains on up to ``--steps``, so the resumed steps are an uninterrupted
run's, bit for bit.  The JAX example's ``--chunk`` (steps per jitted
scan) has no counterpart in eager PyTorch.  At world size > 1 every
rank takes part in each save (the state is replicated, so rank 0 writes
it) and the step is committed only after every rank has finished;
every rank restores it.
:func:`train_step` trains with dropout when it is given a generator.
The rendezvous flags (``--backend``, ``--init-method``,
``--world-size``, ``--rank``) are those of
:mod:`apex_tpu_torch.examples._launch`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_training_state,
    snapshot_training_state,
)
from apex_tpu_torch.data import (
    DataLoader,
    DevicePrefetcher,
    TokenFileDataset,
    bert_mlm_batches,
    synthetic_token_corpus,
)
from apex_tpu_torch.examples._launch import (
    add_distributed_args,
    start_distributed,
)
from apex_tpu_torch.models.bert import (
    BertConfig,
    BertForPreTraining,
    bert_pretrain_loss,
)
from apex_tpu_torch.models.convert import load_optimizer_state, optimizer_state
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.parallel import DistributedDataParallel

__all__ = ["MLMBatches", "TrainRun", "build", "main", "parse_args", "train",
           "train_step", "training_state"]


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
    p.add_argument("--ckpt-dir", default=None, help="checkpoint directory")
    p.add_argument("--save-every", type=int, default=8,
                   help="checkpoint every N steps")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in --ckpt-dir")
    p.add_argument("--num-layers", type=int, default=None,
                   help="depth (default: the configuration's)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    add_distributed_args(p)
    return p.parse_args(argv)


def config(args) -> BertConfig:
    depth = ({} if getattr(args, "num_layers", None) is None
             else {"num_layers": args.num_layers})
    if args.tiny:
        return BertConfig(**{**dict(vocab_size=2048, hidden_size=64,
                                    num_layers=2, num_heads=4,
                                    intermediate_size=128,
                                    max_position_embeddings=args.seq_len,
                                    dtype=torch.float32), **depth})
    return BertConfig(remat=True, **depth)


def corpus(args, vocab: int) -> str:
    if args.data:
        return args.data
    return synthetic_token_corpus(
        os.path.join(tempfile.gettempdir(),
                     f"apex_tpu_torch_bert_corpus_v{vocab}.bin"),
        vocab_size=vocab, num_tokens=2_000_000, floor=1000,
    )


class MLMBatches:
    """The example's batches as a loader: ``iter_from(step)`` yields the
    batch dicts of :func:`bert_mlm_batches` from global step ``step`` on
    (the MLM corruption keyed by step), with the dense labels dropped
    under the fixed-K triple; the identity fields
    (:func:`apex_tpu_torch.goodput.stream_state`) are the token
    loader's.  A :class:`~apex_tpu_torch.goodput.ResumableStream` over it
    serves ``run_resilient``."""

    def __init__(self, args, cfg: BertConfig):
        ds = TokenFileDataset(corpus(args, cfg.vocab_size),
                              seq_len=args.seq_len)
        self.tokens = DataLoader(ds, batch_size=args.batch, seed=1234)
        self.vocab_size = cfg.vocab_size
        self.k = args.max_predictions_per_seq

    def __getattr__(self, name):  # seed, rank, world, batch_size, ...
        return getattr(self.__dict__["tokens"], name)

    def iter_from(self, step: int = 0) -> Iterator[Dict]:
        """The batch dicts from global step ``step`` on, each cut to this
        dp rank's columns of the global batch
        (:func:`dp_columns`)."""
        stream = bert_mlm_batches(
            self.tokens, seed=42, mask_prob=0.15, mask_id=103,
            vocab_size=self.vocab_size, special_floor=1000,
            start_step=step, max_predictions_per_seq=self.k or None,
        )
        drop = ("mlm_labels",) if self.k else ()
        return ({k: dp_columns(k, v) for k, v in b.items() if k not in drop}
                for b in stream)


#: the batch axis of each field (ids, labels and the triple are (S or K,
#: B); the mask is (B, S); the NSP labels (B,))
_BATCH_AXIS = {"attention_mask": 0, "nsp_labels": 0}


def dp_columns(key: str, value):
    """This dp rank's contiguous slice of the global batch along the
    field's batch axis (the whole field at dp = 1)."""
    dp = ps.axis_size(ps.DATA_PARALLEL_AXIS)
    if dp == 1:
        return value
    axis = _BATCH_AXIS.get(key, 1)
    per = value.shape[axis] // dp
    lo = ps.axis_rank(ps.DATA_PARALLEL_AXIS) * per
    return value.take(range(lo, lo + per), axis=axis)


def batch_stream(args, cfg: BertConfig, device, start_step: int = 0
                 ) -> DevicePrefetcher:
    """Batch dicts on ``device`` from global step ``start_step`` on,
    prefetched two ahead by a :class:`DevicePrefetcher`.  With the
    fixed-K triple the dense labels are dropped: the loss reads only the
    triple."""
    return DevicePrefetcher(MLMBatches(args, cfg).iter_from(start_step),
                            device=device, depth=2)


def training_state(model: BertForPreTraining, opt: FusedLAMB, step: int
                   ) -> dict:
    """The checkpointed tree: the parameters and the LAMB state as the
    live tensors (a restore with this tree as the template loads them
    back in place), the LAMB count and ``step`` (steps done)."""
    return snapshot_training_state(
        {k: p.detach() for k, p in model.named_parameters()},
        optimizer_state(opt, model), step=step)


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` did: the per-step losses and host seconds (the
    device synchronised before and after each step) of the steps it ran,
    the checkpoint step it resumed from (None on a fresh start), and the
    state to go on from.  :meth:`close` stops the batch prefetcher."""

    cfg: BertConfig
    model: BertForPreTraining
    optimizer: FusedLAMB
    batches: DevicePrefetcher
    losses: List[float]
    step_seconds: List[float]
    sequences_per_step: int
    tokens_per_step: int
    resumed_from: Optional[int] = None
    checkpoints: Optional[List[int]] = None
    ddp: Optional[DistributedDataParallel] = None

    def close(self) -> None:
        self.batches.close()


def build(args):
    """``(cfg, model, optimizer, batches, start_step)``: the process group
    and the dp group (:func:`start_distributed`), the model (seed 0) on
    ``args.device`` and FusedLAMB, restored in place from the newest
    checkpoint of ``--ckpt-dir`` under ``--resume`` (``start_step`` its
    steps done, else 0), and this dp rank's batch stream from
    ``start_step`` on."""
    if args.max_predictions_per_seq < 0:
        raise ValueError("--max-predictions-per-seq must be >= 0")
    if args.save_every < 1:
        raise ValueError("--save-every must be >= 1")
    dev = resolve_device(args.device)
    start_distributed(args)
    dp = ps.get_data_parallel_world_size()
    if args.batch % dp:
        raise ValueError(f"--batch ({args.batch}) must be divisible by "
                         f"dp={dp}")
    cfg = config(args)
    model = BertForPreTraining(cfg, device=dev)  # weights seeded with 0
    opt = FusedLAMB(model.parameters(), lr=args.lr, weight_decay=0.01)
    start_step = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        with CheckpointManager(args.ckpt_dir) as mgr:
            restored = mgr.restore(template=training_state(model, opt, 0))
        _, opt_state, start_step, _, _ = restore_training_state(restored)
        load_optimizer_state(opt, model, opt_state)
        print(f"resumed from step {start_step} ({args.ckpt_dir})", flush=True)
    return cfg, model, opt, batch_stream(args, cfg, dev, start_step), start_step


def train_step(model: BertForPreTraining, opt: FusedLAMB,
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               ddp: Optional[DistributedDataParallel] = None):
    """One step on this rank's batch; returns the loss (a device scalar;
    the dp mean under ``ddp``, which averages the gradients over the
    world).  With a CPU ``generator`` the step trains with dropout
    (``deterministic=False``), its seeds drawn from it."""
    if ddp is not None:
        loss, _ = ddp.value_and_grad(batch, generator)
    else:
        loss = bert_pretrain_loss(model, batch,
                                  deterministic=generator is None,
                                  generator=generator)
        loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss.detach()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _loss(model, batch, generator=None):
    return bert_pretrain_loss(model, batch, deterministic=generator is None,
                              generator=generator)


def train(args) -> TrainRun:
    cfg, model, opt, batches, start = build(args)
    ddp = DistributedDataParallel(model, _loss)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"BERT {n_params / 1e6:.1f}M params | device={model.device} "
          f"batch={args.batch} seq_len={args.seq_len} remat={cfg.remat} "
          f"K={args.max_predictions_per_seq} "
          f"dp={ps.get_data_parallel_world_size()}", flush=True)
    mgr = (CheckpointManager(args.ckpt_dir, max_to_keep=2,
                             save_interval_steps=args.save_every)
           if args.ckpt_dir else None)
    losses, seconds = [], []
    try:
        for step in range(start, args.steps):
            batch = next(batches)
            _sync(model.device)
            t0 = time.perf_counter()
            loss = train_step(model, opt, batch, ddp=ddp)
            losses.append(float(loss))
            _sync(model.device)
            seconds.append(time.perf_counter() - t0)
            print(f"step {step}: loss {losses[-1]:.4f} "
                  f"{seconds[-1] * 1e3:.1f} ms", flush=True)
            if mgr is not None:
                mgr.save(step + 1, training_state(model, opt, step + 1))
    except BaseException:
        batches.close()
        raise
    if start >= args.steps:
        print(f"nothing to do: resumed step {start} >= --steps {args.steps}",
              flush=True)
    steps = None
    if mgr is not None:
        steps = mgr.all_steps()
        print(f"checkpoints at steps {steps} in {args.ckpt_dir}", flush=True)
    return TrainRun(cfg, model, opt, batches, losses, seconds, args.batch,
                    args.batch * args.seq_len,
                    start if args.resume and start else None, steps, ddp)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Parse ``argv``, train, and return the losses of the steps run."""
    run = train(parse_args(argv))
    run.close()
    return run.losses


if __name__ == "__main__":
    main()

"""ResNet-50 mixed-precision training with data parallelism and
optional SyncBatchNorm.

The port's counterpart of ``examples/imagenet/main_amp.py`` (``main``,
``train``, ``data_prefetcher``; ≙ the reference's torchvision resnet50 +
``apex.parallel.SyncBatchNorm`` recipe): ``amp.initialize`` at
``--opt-level`` O0–O3 (the model in bf16 unless O0, the compute cast by
``handle.policy.cast_to_compute``), an f32 log-softmax loss,
``fused_sgd(lr, momentum=0.9)`` through :meth:`AmpHandle.step`, the
gradients averaged over the dp group (``all_reduce_gradients``) and the
loss reported as its dp mean.  Each dp rank trains on its rows of the
global ``--batch-size``; ``--sync-bn`` takes the batch statistics over
the whole dp group.  The running statistics come back from each step's
forward as new state and are stored once the step is taken.

With no ImageNet on disk it trains on synthetic data drawn from the
reference's ``RandomState(0)`` stream (shape-identical), like the
reference's dry runs; a host thread stages the next batch on the card
while the step runs (``data_prefetcher``: pinned memory, a
``non_blocking`` copy on a side stream the step waits for).

    python -m apex_tpu_torch.examples.imagenet.main_amp --opt-level O2 \\
        --batch-size 128 --image-size 224 --steps 30
    # dp = 2 with SyncBatchNorm (one process per card):
    torchrun --nproc-per-node 2 -m apex_tpu_torch.examples.imagenet.main_amp \\
        --sync-bn --batch-size 256
    # on the CPU (the same code, f32 at O0):
    python -m apex_tpu_torch.examples.imagenet.main_amp --device cpu \\
        --opt-level O0 --batch-size 4 --image-size 32 --steps 2

It reaches no hand-written kernel: convolutions and batch norm are
PyTorch's (cuDNN), as the reference runs them outside Pallas.  The
rendezvous flags (``--backend``, ``--init-method``, ``--world-size``,
``--rank``) are those of :mod:`apex_tpu_torch.examples._launch`.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import amp
from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.data import DevicePrefetcher
from apex_tpu_torch.examples._launch import (
    add_distributed_args,
    start_distributed,
)
from apex_tpu_torch.models.resnet import ResNet, forward_flops, resnet50_config
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import fused_sgd
from apex_tpu_torch.parallel import all_reduce_gradients, comm
from apex_tpu_torch.train import module_loss, module_params

__all__ = ["parse_args", "data_prefetcher", "synthetic_loader", "xent",
           "main"]

#: the card's dense bf16 peak (H100 SXM data sheet), MFU's denominator
PEAK_FLOPS = 989e12


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--opt-level", default="O1",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--loss-scale", default=None,
                   help="a number or 'dynamic' (default: the opt level's)")
    p.add_argument("--batch-size", type=int, default=64, help="global batch")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--sync-bn", action="store_true")
    p.add_argument("--device", default="cuda")
    add_distributed_args(p)
    return p.parse_args(argv)


def data_prefetcher(it, device, depth: int = 2) -> DevicePrefetcher:
    """≙ main_amp.py :: data_prefetcher: a host thread stages the next
    batches (pinned memory, a ``non_blocking`` copy on a side stream;
    the consumer's stream waits for the copy's event and records the
    batch's memory) while the step runs."""
    return DevicePrefetcher(it, device, depth, board_key=None)


def synthetic_loader(args, steps: int, rank: int = 0, dp: int = 1):
    """The reference's synthetic batches (``RandomState(0)``: images
    ``randn(B, S, S, 3)`` f32, labels ``randint(0, classes, (B,))``),
    this rank's contiguous rows of each global batch."""
    rng = np.random.RandomState(0)
    b = args.batch_size // dp
    for _ in range(steps):
        x = rng.randn(args.batch_size, args.image_size, args.image_size,
                      3).astype(np.float32)
        y = rng.randint(0, args.num_classes, (args.batch_size,))
        yield {"image": x[rank * b:(rank + 1) * b],
               "label": y[rank * b:(rank + 1) * b]}


def xent(logits, labels):
    """The reference's loss: the mean of -log_softmax in f32 at the
    labels."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None].long()).mean()


def main(argv: Optional[Sequence[str]] = None, *,
         model: Optional[ResNet] = None) -> dict:
    """Train ``--steps`` steps; returns the per-step dp-mean losses, the
    loss scales, the synchronized step times (s), img/s, MFU (3x the
    forward's convolution and fc FLOPs over 989 TFLOP/s, on the card),
    the peak memory, and the model, its final parameters and amp state.
    ``model`` is ResNet-50 made from seed 0 (the reference's
    ``PRNGKey(0)``) when None; one passed in (a cut one, or one carrying
    a JAX model's weights) must have the flags' classes, norm branch and
    dtype."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    start_distributed(args)
    dp = ps.get_data_parallel_world_size()
    rank = ps.get_data_parallel_rank()
    if args.batch_size % dp:
        raise SystemExit(f"--batch-size must be divisible by dp={dp}")
    cfg = resnet50_config(
        num_classes=args.num_classes, use_syncbn=args.sync_bn,
        dtype=torch.float32 if args.opt_level == "O0" else torch.bfloat16)
    if model is None:
        model = ResNet(cfg, device=dev,
                       generator=torch.Generator().manual_seed(0))
    flags = (cfg.num_classes, cfg.use_syncbn, cfg.dtype)
    if (model.cfg.num_classes, model.cfg.use_syncbn, model.cfg.dtype) != flags:
        raise ValueError(f"model {model.cfg} does not match the flags' "
                         f"classes, norm and dtype {flags}")
    model = model.to(memory_format=torch.channels_last)
    loss_scale = args.loss_scale
    if loss_scale not in (None, "dynamic"):
        loss_scale = float(loss_scale)
    params, handle = amp.initialize(
        module_params(model), fused_sgd(args.lr, momentum=0.9),
        opt_level=args.opt_level, loss_scale=loss_scale)
    amp_state = handle.init(params)
    run = module_loss(model, lambda m, image: m(image, train=True))

    def train_step(params, amp_state, batch):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        logits, new_stats = run(handle.policy.cast_to_compute(leaves),
                                batch["image"])
        loss = xent(logits, batch["label"])
        grads = dict(zip(leaves, torch.autograd.grad(
            handle.scale_loss(loss, amp_state), list(leaves.values()))))
        all_reduce_gradients(grads)
        params, amp_state, _ = handle.step(params, grads, amp_state)
        model.load_batch_stats(new_stats)
        return params, amp_state, comm.pmean(loss.detach(),
                                             ps.DATA_PARALLEL_AXIS)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, scales, step_s = [], [], []
    with data_prefetcher(synthetic_loader(args, args.steps, rank, dp),
                         dev) as loader:
        sync()
        t0 = time.perf_counter()
        for i, batch in enumerate(loader):
            t = time.perf_counter()
            params, amp_state, loss = train_step(params, amp_state, batch)
            sync()
            step_s.append(time.perf_counter() - t)
            losses.append(float(loss))
            scales.append(float(handle.state_dict(amp_state)["loss_scale"]))
            if i % 10 == 0:
                print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                      f"scale {scales[-1]:.0f}", flush=True)
        dt = time.perf_counter() - t0
    seen = args.batch_size * len(losses)
    print(f"done: {seen} images in {dt:.1f}s = {seen / dt:.1f} img/s "
          f"(opt_level={args.opt_level}, dp={dp}, sync_bn={args.sync_bn})",
          flush=True)
    out = dict(losses=losses, loss_scales=scales, step_s=step_s,
               images_per_s=seen / dt, model=model, params=params,
               amp_state=amp_state)
    if dev.type == "cuda":
        steady = sorted(step_s[2:12]) or step_s
        per_s = args.batch_size / steady[len(steady) // 2]
        out.update(
            device=torch.cuda.get_device_name(dev),
            median_step_s=steady[len(steady) // 2], steady_images_per_s=per_s,
            mfu=3 * forward_flops(cfg, args.image_size) * per_s / PEAK_FLOPS,
            peak_bytes=torch.cuda.max_memory_allocated(dev))
    return out


if __name__ == "__main__":
    main()

"""Train, checkpoint, restore, serve: the handoff, end to end.

The port's counterpart of ``examples/simple/serve/serve_gpt.py``.  Phase
1 trains a tiny GPT under :func:`~apex_tpu_torch.resilience.run_resilient`
(step-numbered checkpoints, auto-resume); phase 2 restores the newest
checkpoint from disk and holds it to the trained weights bit for bit;
phase 3 builds the serving engine with its build checks on
(``ServeConfig(verify=True)``: every program's recorded warm-up linted,
its memory estimate against ``--hbm-budget``), prints the zero-ERROR
verdict, and serves a few requests through the continuous-batching
scheduler with a serving :class:`~apex_tpu_torch.observability.Watchdog`.
The serving telemetry goes to the ``--metrics-out`` JSONL in the
bench-line schema::

    python -m apex_tpu_torch.examples.serve_gpt --dir /tmp/serve_demo \\
        --metrics-out serve.jsonl
    # on the CPU (the plain PyTorch versions), int8 KV pages:
    python -m apex_tpu_torch.examples.serve_gpt --device cpu --kv-wire int8

On the card the model computes in bf16 (the kernels' type), on the CPU in
f32.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch import checkpoint
from apex_tpu_torch import observability as obs
from apex_tpu_torch.models.gpt import GptConfig, GptModel, gpt_lm_loss
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import FusedAdamState, fused_adam
from apex_tpu_torch.resilience import run_resilient
from apex_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
    ServeConfig,
)
from apex_tpu_torch.train import module_loss

__all__ = ["build_serving", "main", "model_config", "parse_args"]

SEQ, BATCH = 32, 4


def model_config(device: torch.device) -> GptConfig:
    """Tiny on purpose: the example is about the pipeline, and it
    finishes in seconds on the CPU."""
    return GptConfig(
        vocab_size=96, hidden_size=48, num_layers=2, num_heads=4,
        intermediate_size=96, max_seq_len=256,
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32)


def build_serving(cfg: GptConfig, model: GptModel, *, kv_wire="f32",
                  weight_wire="f32", registry=None, verify=True,
                  hbm_budget_bytes=None, device="cuda") -> InferenceEngine:
    """The example's engine (``tools/graph_lint.py --target serve`` lints
    the same programs: it passes ``verify=False`` and renders
    ``engine.lint()``)."""
    return InferenceEngine(
        cfg, model,
        ServeConfig(page_size=8, num_pages=64, max_batch=4,
                    max_pages_per_seq=8, kv_wire=kv_wire,
                    weight_wire=weight_wire, verify=verify,
                    hbm_budget_bytes=hbm_budget_bytes),
        registry=registry, device=device)


def _init(cfg, device):
    model = GptModel(cfg, device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    params = {name.replace(".", "/"): p.detach().clone()
              for name, p in model.named_parameters()}
    tx = fused_adam(1e-3)
    state = {"params": params, "opt": tx.init(params)._asdict()}
    return model, tx, state


def train(args, cfg, device):
    """Phase 1: resilient training with step-numbered checkpoints."""
    model, tx, state = _init(cfg, device)
    loss_fn = module_loss(model, gpt_lm_loss)
    rs = np.random.RandomState(0)
    data = torch.as_tensor(rs.randint(0, cfg.vocab_size, size=(4096,)),
                           dtype=torch.int64, device=device)
    losses = []

    def batch_fn(step):
        lo = (step * SEQ * BATCH) % (data.shape[0] - SEQ * BATCH)
        return data[lo: lo + SEQ * BATCH].reshape(SEQ, BATCH)

    def step_fn(state, ids):
        params = {k: v.detach().requires_grad_()
                  for k, v in state["params"].items()}
        loss = loss_fn(params, ids)
        grads = torch.autograd.grad(loss, list(params.values()))
        updates, opt = tx.update(dict(zip(params, grads)),
                                 FusedAdamState(**state["opt"]),
                                 state["params"])
        new = {k: (state["params"][k] + updates[k]).detach()
               for k in params}
        losses.append(float(loss.detach()))
        return {"params": new, "opt": opt._asdict()}, {"loss": loss.detach()}

    result = run_resilient(
        step_fn, state, batch_fn,
        directory=os.path.join(args.dir, "checkpoint"),
        num_steps=args.train_steps, save_interval_steps=args.save_every,
        max_to_keep=2)
    if losses:
        print(f"trained {result.steps_run} steps (resumed_from="
              f"{result.resumed_from}); loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}")
    else:
        print(f"training resumed complete at step {result.last_step}")
    return model, result.state


def restore(args, template):
    """Phase 2: the weights come from disk, not from memory."""
    ckpt_dir = os.path.join(args.dir, "checkpoint")
    step = checkpoint.latest_step(ckpt_dir)
    if step is None:
        raise SystemExit(f"no checkpoint under {ckpt_dir}: train first")
    with checkpoint.CheckpointManager(ckpt_dir) as mgr:
        restored = mgr.restore(step, template=template)
    print(f"restored checkpoint step {step} from {ckpt_dir}")
    return restored["params"]


def serve(args, cfg, model, params, device):
    """Phase 3: the engine's build checks, then the scheduler."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name.replace(".", "/")])
    registry = obs.MetricRegistry(fetch_every=1)
    engine = build_serving(
        cfg, model, kv_wire=args.kv_wire, weight_wire=args.weight_wire,
        registry=registry, hbm_budget_bytes=args.hbm_budget,
        device=device).build()
    errors = {n: len(r.errors()) for n, r in engine.reports.items()}
    peak = max(r.sections["peak_hbm_bytes"] for r in engine.reports.values())
    print(f"engine built: graph lint ERRORs per program = {errors}; "
          f"estimated peak {peak} bytes")
    if any(errors.values()):
        raise SystemExit("the engine's build checks found ERRORs")

    reporter = None
    if args.metrics_out:
        reporter = obs.Reporter([obs.JSONLSink(args.metrics_out)],
                                registry=registry)
    watchdog = obs.Watchdog(
        obs.serve_rules(ttft={"deadline_ms": args.slo_ttft_ms}),
        registry=registry, reporter=reporter, check_every=1,
        on_unhealthy=lambda ev: print(
            f"  [health/{ev.severity}] {ev.rule}: {ev.message}"))
    sched = ContinuousBatchingScheduler(engine, registry=registry)
    rs = np.random.RandomState(1)
    for _ in range(args.requests):
        sched.submit(Request(
            prompt=[int(t) for t in rs.randint(
                0, cfg.vocab_size, size=int(rs.choice([8, 12, 20])))],
            max_new_tokens=int(rs.choice([4, 8])),
            slo_ttft_ms=args.slo_ttft_ms))
    step = 0
    while sched.pending:
        sched.step()
        step += 1
        watchdog.on_step(step)
        if reporter is not None:
            reporter.report(step)
    registry.fetch()
    vals = registry.values()
    if reporter is not None:
        reporter.report(step)
        reporter.close()
    print("served %d requests (%d shed): ttft=%.2fms tokens/s=%.1f "
          "batch_fill=%.2f" % (
              len(sched.completed), len(sched.shed),
              vals.get("serve/ttft_ms", float("nan")),
              vals.get("serve/tokens_per_s", 0.0),
              vals.get("serve/batch_fill", 0.0)))
    for r in sched.completed[:3]:
        print(f"  request {r.rid}: prompt[:6]={r.prompt[:6]} -> "
              f"tokens={r.tokens}")
    return engine, sched


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=None,
                    help="checkpoint directory (default: a new one under "
                    "the temporary directory)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train-steps", type=int, default=12)
    # every step, so the newest step on disk is the trained state and the
    # bit-for-bit proof below is exact
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slo-ttft-ms", type=float, default=5000.0)
    ap.add_argument("--kv-wire", default="f32", choices=["f32", "int8"])
    ap.add_argument("--weight-wire", default="f32", choices=["f32", "int8"])
    ap.add_argument("--hbm-budget", type=int, default=None,
                    help="estimated peak-memory budget of each program, "
                    "bytes (the build fails above it)")
    ap.add_argument("--metrics-out", default=None,
                    help="serving telemetry JSONL (bench-line schema)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.dir is None:
        args.dir = tempfile.mkdtemp(prefix="apex_tpu_torch_serve_")
    cfg = model_config(device)
    model, final = train(args, cfg, device)
    _, _, template = _init(cfg, device)
    params = restore(args, template)
    leaves = sorted(final["params"])
    worst = max(float((params[k] - final["params"][k]).abs().max())
                for k in leaves)
    if worst != 0.0:
        raise SystemExit(f"restored params drifted from the training "
                         f"result: max |delta| = {worst}")
    print(f"train->serve handoff round-trips: restored == trained "
          f"({len(leaves)} leaves, bit for bit)")
    return serve(args, cfg, model, params, device)


if __name__ == "__main__":
    main()

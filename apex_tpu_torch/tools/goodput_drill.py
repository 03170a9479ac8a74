"""Chaos-storm goodput drill — the goodput acceptance gate.

Counterpart of ``tools/goodput_drill.py``.  Drives the resilient
example's real training program
(:func:`apex_tpu_torch.examples.train_resilient.build_training`: the
guarded two-program step of :meth:`~apex_tpu_torch.train.Trainer.
build_guarded`) through an ``APEX_TPU_CHAOS``-style preemption storm,
fed by the goodput subsystem's resumable stream
(:class:`~apex_tpu_torch.goodput.ResumableStream` over a synthetic token
corpus), checkpointed by the async engine
(:class:`~apex_tpu_torch.goodput.AsyncCheckpointEngine`), and proves
the three headline numbers:

1. **goodput >= 99%** — the :class:`~apex_tpu_torch.observability.
   GoodputAccountant` ledger across every relaunch of the storm (a
   preemption every ``--preempt-every`` steps, plus one save I/O fault
   that must heal on retry);
2. **bit-exact resume** — the stormed run's per-step loss sequence
   equals an uninterrupted reference run's, bit for bit (the stream
   cursor rides inside every checkpoint and is verified on restore);
3. **checkpoint stall < 1%** — the step path's snapshot + enqueue time
   over wall time (``goodput/ckpt/stall_frac``), watched live by
   :func:`~apex_tpu_torch.observability.goodput_rules` (zero pages on a
   healthy storm).

It then plants the two on-disk shapes of a death mid-write in the
port's own checkpoint format — a staging directory
(``<step>.apex-ckpt-tmp-<pid>-<n>``: the write died before its commit
rename) and a digit-named, half-written step directory newer than every
complete step (a payload, no commit marker) — and proves that the
previous checkpoint stays the resume anchor (``latest_step`` ignores
both; a relaunch resumes from it).

The training runs on ``--device`` (the card by default; ``--device
cpu`` runs it on the CPU).  The default ``--dir`` is a directory under
the temporary directory (``$TMPDIR``).

Usage::

    python -m apex_tpu_torch.tools.goodput_drill --steps 60 \\
        --preempt-every 12 --json out.json

Exit code: 0 when every gate holds (``goodput drill: PASS``), 1
otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

#: the default drill directory (removed and re-made by each drill)
DEFAULT_DIR = os.path.join(tempfile.gettempdir(),
                           "apex_tpu_torch_goodput_drill")


def _make_stream(workdir, rows, seed=17, prefetch=2, device="cuda"):
    """A resumable stream over a synthetic token corpus sized so the
    drill crosses epoch boundaries (the seek math's hard case)."""
    from apex_tpu_torch.data import (
        DataLoader,
        TokenFileDataset,
        synthetic_token_corpus,
    )
    from apex_tpu_torch.goodput import ResumableStream

    corpus = synthetic_token_corpus(
        os.path.join(workdir, "drill_corpus.bin"),
        vocab_size=4096, num_tokens=rows * 12 * 24, seed=seed,
    )
    ds = TokenFileDataset(corpus, seq_len=12)
    loader = DataLoader(ds, batch_size=rows, seed=seed)
    return ResumableStream(loader, prefetch=prefetch, device=device), loader


def run_drill(
    steps: int = 60,
    preempt_every: int = 12,
    save_every: int = 8,
    step_floor_ms: float = 75.0,
    workdir: str = DEFAULT_DIR,
    device="cuda",
) -> dict:
    """Run the reference + storm pair and return the evidence dict.

    ``step_floor_ms`` floors each step's wall time so the toy step
    stands in for a realistic device step: the <1% stall bound is a
    claim about checkpoint overhead relative to a real step's time (the
    reference's 75 ms, a mid-size model's step)."""
    import shutil

    from apex_tpu_torch.ops._dispatch import resolve_device

    device = resolve_device(device)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir, exist_ok=True)

    # Size the queue to absorb every save of one invocation, so the
    # stall fraction measures the engine's step-path cost (the
    # snapshot), not the disk's weather; bounded backpressure itself is
    # held by the unit tests
    saves_per_invocation = -(-steps // save_every) + 2
    prior_depth = os.environ.get("APEX_TPU_CKPT_QUEUE")
    os.environ["APEX_TPU_CKPT_QUEUE"] = str(max(8, saves_per_invocation))
    try:
        return _run_drill_inner(
            steps, preempt_every, save_every, step_floor_ms, workdir,
            device,
        )
    finally:
        if prior_depth is None:
            os.environ.pop("APEX_TPU_CKPT_QUEUE", None)
        else:
            os.environ["APEX_TPU_CKPT_QUEUE"] = prior_depth


def _run_drill_inner(steps, preempt_every, save_every, step_floor_ms,
                     workdir, device) -> dict:
    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.examples.train_resilient import build_training
    from apex_tpu_torch.goodput import verify_stream_state
    from apex_tpu_torch.observability.metrics import board
    from apex_tpu_torch.observability.spans import SpanRecorder
    from apex_tpu_torch.resilience import ObserverFanout, chaos, run_resilient

    t = build_training(accum=1, wire="f32", fetch_every=8,
                       device=device.type)
    rows, registry = t["rows"], t["registry"]
    compute_grads, apply_update = t["compute_grads"], t["apply_update"]
    rs = np.random.RandomState(3)
    w_true = torch.from_numpy(rs.randn(8, 4).astype(np.float32)).to(device)

    def make_batch(toks):
        x = torch.as_tensor(toks[:, :8], device=device).to(
            torch.float32) / 4096.0 - 0.5
        return (x.reshape(1, rows, 8), (x @ w_true).reshape(1, rows, 4))

    def run(directory, stream, *, faults=(), losses=None, observers=(),
            spans=None, num_steps=steps, acct=None):
        """run_resilient in a relaunch loop (each preemption = one
        process death + restart), accumulating one ledger."""
        cur = {"step": -1}

        def batch_fn(step):
            cur["step"] = step
            return make_batch(stream(step))

        def step_fn(state, batch):
            t0 = time.monotonic()
            inner = state["train"]
            loss, scaled = compute_grads(
                inner["params"], inner["scaler"], batch
            )
            scaled = chaos.corrupt_tree(scaled, cur["step"])
            new_inner, verdict = apply_update(scaled, inner, loss)
            registry.observe(cur["step"], new_inner["metrics"])
            if losses is not None:
                losses[cur["step"]] = float(loss)
            if step_floor_ms > 0:  # emulate a realistic device step
                rest = step_floor_ms / 1e3 - (time.monotonic() - t0)
                if rest > 0:
                    time.sleep(rest)
            return (
                {"train": new_inner,
                 "stream": stream.state(cur["step"] + 1)},
                {"skipped": verdict.skipped},
            )

        init = {"train": t["state"], "stream": stream.state(0)}
        acct = acct if acct is not None else obs.GoodputAccountant()
        ledger = {"invocations": 0, "saves": 0.0, "writes": 0.0,
                  "failures": 0.0, "max_stall_frac": 0.0,
                  "snapshot_ms": [], "write_ms": [], "finalize_ms": []}

        class PhaseCollector:
            def on_checkpoint(self, step, info=None):
                if info is None:
                    return
                if info.get("phase") == "finalize":
                    ledger["finalize_ms"].append(
                        (info["t1"] - info["t0"]) * 1e3
                    )
                    return
                if info.get("phase") != "write":
                    return
                ledger["write_ms"].append((info["t1"] - info["t0"]) * 1e3)
                if info.get("snapshot_t1") is not None:
                    # the full step-path cost of this save: snapshot
                    # plus the enqueue wait
                    ledger["snapshot_ms"].append(
                        (info["snapshot_t1"] - info["snapshot_t0"]) * 1e3
                        + info.get("enqueue_ms", 0.0)
                    )

        # spans joins the fan-out inside run_resilient itself
        fanout = ObserverFanout([acct, PhaseCollector(), *observers])
        with chaos.inject(*faults):
            while True:
                res = run_resilient(
                    step_fn, init, batch_fn, directory=directory,
                    num_steps=num_steps, save_interval_steps=save_every,
                    max_to_keep=3, rollback_after=5,
                    observer=fanout, spans=spans,
                )
                ledger["invocations"] += 1
                for key in ("saves", "writes", "failures"):
                    ledger[key] += board.get(f"goodput/ckpt/{key}", 0.0)
                ledger["max_stall_frac"] = max(
                    ledger["max_stall_frac"],
                    board.get("goodput/ckpt/stall_frac", 0.0),
                )
                if not res.preempted:
                    return res, acct, ledger

    # -- 0. warm the checkpoint path ---------------------------------------
    # the first save of a process pays one-time setup (the writer's
    # imports and thread pool); one throwaway save measures the engine
    # at steady state
    from apex_tpu_torch.goodput import AsyncCheckpointEngine

    with AsyncCheckpointEngine(os.path.join(workdir, "warmup")) as warm:
        warm.save(0, {"w": torch.zeros((4,), dtype=torch.float32,
                                       device=device)})
        warm.wait_until_finished()

    # -- 1. uninterrupted reference ----------------------------------------
    losses_ref: dict = {}
    ref_stream, _ = _make_stream(workdir, rows, device=device)
    ref_res, _, ref_ledger = run(
        os.path.join(workdir, "ref"), ref_stream, losses=losses_ref
    )
    ref_stream.close()

    # -- 2. the storm ------------------------------------------------------
    # preempt every N steps, plus ONE save I/O fault that must heal on
    # retry (the accountant's retry column proves it fired)
    preempts = ",".join(
        str(s) for s in range(preempt_every, steps, preempt_every)
    )
    spec = f"preemption@{preempts};checkpoint_save:raise:x1@{save_every}"
    faults, seed = chaos.parse_spec(spec)

    losses_storm: dict = {}
    storm_dir = os.path.join(workdir, "storm")
    storm_stream, storm_loader = _make_stream(workdir, rows, device=device)
    spans = SpanRecorder(8192, directory=os.path.join(workdir, "spans"))
    pages: list = []
    acct = obs.GoodputAccountant()
    watchdog = obs.Watchdog(
        # a 5% live budget on the short window keeps the zero-pages
        # assertion about the engine while still catching a writer that
        # falls behind (the full-run number is held under 1% below)
        obs.goodput_rules(floor=0.99, ckpt_stall={"max_fraction": 0.05}),
        registry=registry, goodput=acct,
        on_unhealthy=pages.append, check_every=4,
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the healed retry
        storm_res, acct, ledger = run(
            storm_dir, storm_stream,
            faults=faults, losses=losses_storm,
            observers=[watchdog], spans=spans, acct=acct,
        )

    # bit-exactness: every step of the storm equals the reference
    drift = max(
        (abs(losses_storm[s] - losses_ref[s]) for s in losses_ref),
        default=float("inf"),
    ) if set(losses_storm) == set(losses_ref) else float("inf")

    # the stream cursor inside the NEWEST checkpoint, verified against
    # the loader it indexes
    last_saved = ckpt.latest_step(storm_dir)
    restored = ckpt.restore_step_dir(storm_dir, last_saved)
    cursor = verify_stream_state(storm_loader, restored["stream"])
    storm_stream.close()

    span_names = [s["name"] for s in spans.snapshot()]

    # -- 3. the planted mid-write kill -------------------------------------
    latest_before = ckpt.latest_step(storm_dir)
    # shape A: the port's staging debris (died before the commit rename)
    debris = os.path.join(
        storm_dir,
        f"{latest_before + 1}{ckpt.STAGING_INFIX}{os.getpid()}-drill",
    )
    os.makedirs(debris, exist_ok=True)
    with open(os.path.join(debris, "tree.json"), "w") as f:
        f.write("torn write\n")
    # shape B: a digit-named dir with payload but NO commit marker (a
    # torn write on a non-atomic file system) — newer than everything
    half = os.path.join(storm_dir, str(latest_before + 2))
    os.makedirs(half, exist_ok=True)
    with open(os.path.join(half, "tree.json"), "w") as f:
        f.write("half-written payload\n")
    latest_after = ckpt.latest_step(storm_dir)
    # a relaunch must resume from the intact previous checkpoint
    resume_stream, _ = _make_stream(workdir, rows, device=device)
    resume_res, _, _ = run(storm_dir, resume_stream, num_steps=steps)
    resume_stream.close()

    return {
        "steps": steps,
        "preempt_every": preempt_every,
        "save_every": save_every,
        "chaos_spec": spec,
        "goodput": acct.goodput(),
        "accountant": acct.snapshot(),
        "invocations": ledger["invocations"],
        "ckpt": {
            "saves": ledger["saves"] + ref_ledger["saves"],
            "writes": ledger["writes"] + ref_ledger["writes"],
            "failures": ledger["failures"],
            # the <1% overhead claim, measured on the full-length
            # uninterrupted run (the storm's per-invocation windows are
            # too short to judge a fraction on); the storm max stays as
            # telemetry
            "stall_frac": ref_ledger["max_stall_frac"],
            "storm_max_stall_frac": ledger["max_stall_frac"],
            "snapshot_ms": sorted(
                ref_ledger["snapshot_ms"] + ledger["snapshot_ms"]
            ),
            "write_ms": sorted(
                ref_ledger["write_ms"] + ledger["write_ms"]
            ),
            "finalize_ms": sorted(
                ref_ledger["finalize_ms"] + ledger["finalize_ms"]
            ),
        },
        "input_stall_fraction": board.get(
            "data/input_stall_fraction", 0.0
        ),
        "loss_trajectory": {
            "ref_steps": len(losses_ref),
            "storm_steps": len(losses_storm),
            "max_abs_drift": drift,
            "bit_exact": drift == 0.0,
            "final_loss": losses_ref.get(steps - 1),
        },
        "stream_cursor": {
            "restored_next_batch": cursor,
            "expected": last_saved + 1,
        },
        "spans": {
            "ckpt_snapshot": span_names.count("ckpt/snapshot"),
            "ckpt_write": span_names.count("ckpt/write"),
            "ckpt_finalize": span_names.count("ckpt/finalize"),
            "train_step": span_names.count("train/step"),
        },
        "watchdog_pages": [
            {"rule": e.rule, "severity": e.severity, "message": e.message}
            for e in pages
        ],
        "planted_midwrite": {
            "latest_before": latest_before,
            "latest_after_plant": latest_after,
            "previous_intact": latest_after == latest_before,
            "resumed_from": resume_res.resumed_from,
            "resume_ok": resume_res.resumed_from == latest_before,
        },
        # the runtime lock-order sanitizer's census: under
        # APEX_TPU_LOCKSAN=1 every TrackedLock acquisition of the drill
        # (the async engine's writer thread racing the step path) lands
        # in the graph
        "locksan": obs.sanitizer_report(),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--preempt-every", type=int, default=12)
    ap.add_argument("--save-every", type=int, default=8)
    ap.add_argument("--step-floor-ms", type=float, default=75.0)
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write the evidence artifact")
    ap.add_argument("--floor", type=float, default=0.99,
                    help="goodput acceptance floor")
    ap.add_argument("--max-stall", type=float, default=0.01,
                    help="checkpoint stall-fraction acceptance bound")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    art = run_drill(
        steps=args.steps, preempt_every=args.preempt_every,
        save_every=args.save_every, step_floor_ms=args.step_floor_ms,
        workdir=args.dir, device=args.device,
    )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(art, f, indent=1)

    print(
        "goodput drill: goodput=%.4f (accepted=%d skipped=%d "
        "discarded=%d retries=%d resumes=%d over %d invocations)"
        % (art["goodput"], art["accountant"]["accepted"],
           art["accountant"]["skipped"], art["accountant"]["discarded"],
           art["accountant"]["retries"], art["accountant"]["resumes"],
           art["invocations"])
    )
    print(
        "  ckpt: saves=%d writes=%d stall_frac=%.5f  spans: "
        "snapshot=%d write=%d finalize=%d"
        % (art["ckpt"]["saves"], art["ckpt"]["writes"],
           art["ckpt"]["stall_frac"], art["spans"]["ckpt_snapshot"],
           art["spans"]["ckpt_write"], art["spans"]["ckpt_finalize"])
    )
    print(
        "  resume: bit_exact=%s cursor=%s planted_midwrite intact=%s "
        "resume_ok=%s watchdog_pages=%d"
        % (art["loss_trajectory"]["bit_exact"],
           art["stream_cursor"]["restored_next_batch"],
           art["planted_midwrite"]["previous_intact"],
           art["planted_midwrite"]["resume_ok"],
           len(art["watchdog_pages"]))
    )

    failures = []
    if art["goodput"] < args.floor:
        failures.append(
            f"goodput {art['goodput']:.4f} under floor {args.floor}"
        )
    if not art["loss_trajectory"]["bit_exact"]:
        failures.append(
            "resumed loss trajectory drifted: max_abs_drift="
            f"{art['loss_trajectory']['max_abs_drift']}"
        )
    if art["ckpt"]["stall_frac"] >= args.max_stall:
        failures.append(
            f"ckpt stall {art['ckpt']['stall_frac']:.5f} >= "
            f"{args.max_stall}"
        )
    if not art["planted_midwrite"]["previous_intact"]:
        failures.append("planted mid-write debris changed latest_step")
    if not art["planted_midwrite"]["resume_ok"]:
        failures.append("relaunch did not resume from the intact step")
    if art["stream_cursor"]["restored_next_batch"] != \
            art["stream_cursor"]["expected"]:
        failures.append("checkpointed stream cursor off")
    if art["spans"]["ckpt_write"] == 0 or art["spans"]["ckpt_snapshot"] == 0:
        failures.append("no ckpt spans on the timeline")
    if art["watchdog_pages"]:
        failures.append(f"watchdog paged: {art['watchdog_pages']}")
    if art["locksan"]["armed"] and art["locksan"]["cycles"]:
        failures.append(
            "lock-order cycles under LOCKSAN: "
            f"{art['locksan']['cycles']}"
        )
    for f_ in failures:
        print(f"GOODPUT DRILL FAIL: {f_}", file=sys.stderr)
    if not failures:
        print("goodput drill: PASS")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

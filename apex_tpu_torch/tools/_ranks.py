"""Worker processes for the tools and scripts that run across ranks.

:func:`run_ranks` starts ``world`` processes (the ``forkserver`` start
method: forked from a server process that never touches the card, so a
caller can preload its imports there once with
``multiprocessing.set_forkserver_preload``), each of which joins one
group (gloo by default) through a ``file://`` store in a temporary
directory (no TCP port), calls a module-level function (pickled by
reference) as ``fn(rank, world, **kwargs)`` and hands its result back
pickled.  On the card every gloo rank shares card 0 (NCCL refuses two
ranks on one device but a world of one; gloo stages CUDA tensors through
the host); an NCCL rank takes card ``rank``.  A rank that raises, exits
non-zero or outlives ``timeout_s`` fails the call: the others are killed
and the failing rank's traceback is raised.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback

#: seconds a rank may wait in a collective before the group gives up
GROUP_TIMEOUT_S = 120.0


def _rank_main(rank, world, store, target, kwargs, device, backend,
               group_timeout_s, out_dir):
    import torch

    from apex_tpu_torch.parallel import multihost

    if device == "cuda":
        torch.cuda.set_device(rank if backend == "nccl" else 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    try:
        multihost.initialize_distributed(
            init_method=f"file://{store}", num_processes=world,
            process_id=rank, backend=backend, device=device,
            timeout_s=group_timeout_s)
        out = target(rank, world, **kwargs)
        with open(os.path.join(out_dir, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(out_dir, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        multihost.finalize_distributed()


def run_ranks(world: int, target, kwargs=None, *, device="cuda",
              backend: str = "gloo", timeout_s: float = 900.0,
              group_timeout_s: float = GROUP_TIMEOUT_S) -> list:
    """Run ``target`` (a module-level function) on ``world`` ranks over
    ``backend``; returns each rank's result, in rank order."""
    import multiprocessing as mp

    name = f"{target.__module__}.{target.__qualname__}"
    tmp = tempfile.mkdtemp(prefix="apex_tpu_torch_ranks_")
    ctx = mp.get_context("forkserver")
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, os.path.join(tmp, "store"), target, dict(kwargs or {}),
        str(device), backend, group_timeout_s, tmp)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise RuntimeError(
                f"{name}: ranks {hung} still running after {timeout_s} s")
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                err = os.path.join(tmp, f"err{r}.txt")
                text = (open(err).read() if os.path.exists(err)
                        else "(no traceback)")
                raise RuntimeError(
                    f"{name}: rank {r} exited with {p.exitcode}:\n{text}")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)

"""Sweep the compile-time tile shapes of K3 and K4 on the card.

``csrc/flash_fwd.cu`` takes its keys per stage and ring depth from
``APEX_FLASH_FWD_BLOCK_K`` and ``APEX_FLASH_FWD_STAGES``, and
``csrc/flash_bwd.cu`` its ring depth from ``APEX_FLASH_BWD_STAGES``; the
defaults in the sources are what the port runs.  This script builds each
variant of :data:`VARIANTS` (one ``nvcc`` per variant, all started
together), checks it against the plain version at a ragged causal shape
and a biased one, and times it at the main-path shapes of
``chip_smoke.py`` (CUDA events around queued runs, L2 flushed before
each), in the order A B ... then ... B A, so that a drift of the card's
clocks shows as a difference between the two passes::

    python -m apex_tpu_torch.tools.flash_tiles [--kernel flash_fwd]

It needs a CUDA device and ``nvcc``; it prints one JSON line per
(variant, shape, pass) and a table of the medians.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import attention as attn

#: kernel -> [(label, defines)]; "default" is what the sources choose
#: (K3: 128 keys and 3 stages without a bias, 64 keys and 2 stages with
#: one; K4: 3 stages without a bias, 2 with one).  Every variant fits the
#: shared memory of every bias mode.
VARIANTS = {
    "flash_fwd": [
        ("default", ()),
        ("bk128 s2", ("APEX_FLASH_FWD_BLOCK_K=128", "APEX_FLASH_FWD_STAGES=2")),
        ("bk64 s2", ("APEX_FLASH_FWD_BLOCK_K=64", "APEX_FLASH_FWD_STAGES=2")),
        ("bk64 s3", ("APEX_FLASH_FWD_BLOCK_K=64", "APEX_FLASH_FWD_STAGES=3")),
    ],
    "flash_bwd": [
        ("default", ()),
        ("s2", ("APEX_FLASH_BWD_STAGES=2",)),
        ("s3", ("APEX_FLASH_BWD_STAGES=3",)),
    ],
}

#: (tag, BH, S, D, causal, bias (G, RS) or None) of the main paths
SHAPES = (
    ("gpt", 128, 2048, 64, True, None),
    ("prefill", 16, 2048, 64, True, None),
    ("bert", 2048, 128, 64, False, (128, 1)),
    ("triangle", 1024, 256, 32, False, (1024, 256)),
    ("msa_row", 512, 256, 64, False, (512, 256)),
    ("msa_col", 1024, 128, 64, False, None),
    ("long", 8, 16384, 128, True, None),
)


def _time_ms(fn, flush, iters=25):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _ptxas_summary(log):
    """Registers and spills of every kernel instance in an ``nvcc -Xptxas
    -v`` log ("already built" when this process did not build it)."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    if not regs:
        return "already built"
    spilled = [x for x in spills if x]
    return (f"{len(regs)} instances, registers {min(regs)}-{max(regs)}, "
            f"{len(spilled)} spill (up to {max(spilled, default=0)} bytes "
            f"of stores)")


def _use(name, path):
    """Route the wrapper of kernel ``name`` to the library at ``path``."""
    lib = ctypes.CDLL(str(path))
    lib.apex_error_string.argtypes = [ctypes.c_int]
    lib.apex_error_string.restype = ctypes.c_char_p
    _build._LIBS[name] = lib


def _inputs(bh, sq, sk, d, layout, gen):
    def r(s):
        return torch.randn(bh, s, d, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v = r(sq), r(sk), r(sk)
    bias = None if layout is None else torch.randn(
        *layout, sk, generator=gen, device="cuda")
    return q, k, v, bias, r(sq)


def _check(name, gen):
    """The variant now loaded for ``name`` against the plain version."""
    for bh, sq, sk, d, causal, layout in ((4, 200, 130, 64, True, None),
                                          (8, 130, 37, 32, True, (2, 130)),
                                          (8, 136, 200, 64, True, (8, 136)),
                                          (4, 200, 130, 128, True, None),
                                          (8, 136, 200, 128, False, (8, 136))):
        q, k, v, bias, do = _inputs(bh, sq, sk, d, layout, gen)
        kw = dict(scale=d ** -0.5, causal=causal)
        ref = attn.flash_fwd_reference(q, k, v, bias, **kw)
        if name == "flash_fwd":
            out = attn.flash_fwd(q, k, v, bias, **kw)
            ok = torch.allclose(out[0].float(), ref[0].float(), atol=2e-2,
                                rtol=2e-2)
        else:
            o, _, m, l = ref
            delta = (do.float() * o.float()).sum(-1)
            args = (q, k, v, do, m, l, delta, bias)
            out = attn.flash_bwd(*args, **kw)
            want = attn.flash_bwd_reference(*args, **kw)
            ok = all(float((a.float() - b.float()).norm() / b.float().norm())
                     < 1e-2 for a, b in zip(out, want))
        if not ok:
            raise AssertionError(f"{name} variant disagrees at {bh, sq, sk, d}")


def _time_shape(name, shape, flush, gen):
    _, bh, s, d, causal, layout = shape
    q, k, v, bias, do = _inputs(bh, s, s, d, layout, gen)
    kw = dict(scale=d ** -0.5, causal=causal)
    if name == "flash_fwd":
        return _time_ms(lambda: attn.flash_fwd(q, k, v, bias, **kw), flush)
    o, _, m, l = attn.flash_fwd(q, k, v, bias, **kw)
    delta = (do.float() * o.float()).sum(-1)
    return _time_ms(lambda: attn.flash_bwd(q, k, v, do, m, l, delta, bias,
                                           **kw), flush)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(VARIANTS), action="append",
                    help="sweep only this kernel (repeatable; default both)")
    kernels = ap.parse_args(argv).kernel or list(VARIANTS)
    if not torch.cuda.is_available():
        print("flash_tiles needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)
    sweep = {name: VARIANTS[name] for name in kernels}
    jobs = [(name, label, defines) for name, variants in sweep.items()
            for label, defines in variants]
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc each, together
        built = pool.map(lambda j: _build.build([j[0]], j[2])[j[0]], jobs)
        paths = {(name, label): path
                 for (name, label, _), path in zip(jobs, built)}
    for name, label, defines in jobs:
        print(f"{name} {label}: {_ptxas_summary(_build.build_log(name, defines))}",
              flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    times = {}
    for name, variants in sweep.items():
        labels = [label for label, _ in variants]
        for label in labels:
            _use(name, paths[name, label])
            _check(name, gen)
        for order, run in ((labels, 0), (labels[::-1], 1)):
            for label in order:
                _use(name, paths[name, label])
                for shape in SHAPES:
                    ms = _time_shape(name, shape, flush, gen)
                    times.setdefault((name, label, shape[0]), []).append(ms)
                    print(json.dumps({"kernel": name, "variant": label,
                                      "shape": shape[0], "pass": run,
                                      "ms": ms, "card": card}), flush=True)
                    torch.cuda.empty_cache()
    for name, variants in sweep.items():
        print(f"{name} ms (mean of the two passes) on {card}")
        print("  variant   " + " ".join(f"{s[0]:>9}" for s in SHAPES))
        for label, _ in variants:
            print(f"  {label:9} " + " ".join(
                f"{statistics.mean(times[name, label, s[0]]):9.4f}"
                for s in SHAPES))
    return 0


if __name__ == "__main__":
    sys.exit(main())

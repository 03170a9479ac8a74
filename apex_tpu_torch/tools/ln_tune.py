"""On-card LayerNorm rows-per-CTA tuner: fills the tuning cache's
``layer_norm`` section.

Counterpart of ``tools/ln_tune.py``.  The reference sweeps the row-block
size of its Pallas LayerNorm kernels; the port's K1 and K2
(``csrc/layer_norm_fwd.cu``, ``csrc/layer_norm_bwd.cu``) take a row per
warp (or per lane group) on a persistent grid, and the knob that a run can
set is how many rows a CTA takes per pass of that grid:
:func:`~apex_tpu_torch.ops.layer_norm.norm_launch_plan`'s ``block_rows``,
which sets the grid (``ceil(rows / block_rows)``, at most the CTAs that
stay resident) and with it K2's partial rows of dw and db.  It is a
run-time plan field, so the sweep builds nothing beyond the default
kernels.

For each hidden size of :data:`HIDDENS` (or ``--hidden``) the candidates
are the multiples of the default ``NORM_WARPS * rows_per_warp`` up to the
last one whose grid still puts a CTA on every SM (:func:`candidates`).
Each candidate runs K1 then K2 (forward and backward, as the reference
times them) on ``--rows`` rows and is held to the plain versions; a
mismatch exits 1.  The pair is timed with CUDA events, L2 flushed before
each run, in the order A ... B and then B ... A (``tools/flash_tiles.py``'s
timer); a cell's time is the mean of its two passes.  The same two passes
time, after the last candidate, the plain versions' pair and the
library's (``aten.native_layer_norm`` and ``native_layer_norm_backward``,
what ``F.layer_norm`` and its backward call, with the weights in x's
dtype).  The script prints a JSON line per (hidden, candidate or call,
pass), the reference's table and its ``_TUNED_BLOCK_ROWS = {...}``
literal, then a table in ms beside the default, the bound, the plain
pair and the library's.  ``--cache-out`` merges each hidden size's winner
into a tuning cache under this card's name
(:func:`apex_tpu_torch.ops.tune_cache.update_layer_norm`), which K1 and
K2's launch plan reads when ``APEX_TPU_TUNE_CACHE`` names the file::

    python -m apex_tpu_torch.tools.ln_tune [--rows 16384] \
        [--hidden 1024 --hidden 4096] [--dtype bf16|f32] [--cache-out FILE]

It needs a CUDA device: ``--device cpu`` is refused, as is a host
without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

#: the reference's hidden sizes
HIDDENS = [768, 1024, 1536, 2048, 3072, 4096, 5120, 6144, 8192]
#: element bytes of the dtypes the sweep takes
DTYPES = {"bf16": 2, "f32": 4}
#: the dtype names the table prints (the reference's ``dtype.__name__``)
DTYPE_NAMES = {"bf16": "bfloat16", "f32": "float32"}
#: the H100 SXM's HBM rate and f32 peak (the data sheet's), the bound
#: column's basis
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: the checks' tolerances: dx and y one or two bf16 steps (f32: the
#: summation order), the f32 statistics, and dw/db (f32 sums over the
#: rows taken in another order: per-CTA partials, then torch.sum)
OUT_TOL = {"bf16": dict(atol=2e-2, rtol=2e-2), "f32": dict(atol=1e-3,
                                                           rtol=1e-4)}
STAT_TOL = dict(atol=1e-3, rtol=1e-4)
SUM_TOL = dict(atol=1e-2, rtol=1e-3)


def default_block_rows(hidden: int, elem_bytes: int) -> int:
    """The rows a CTA takes per pass when no cache entry names any: one
    row group of each of its warps (``NORM_WARPS * rows_per_warp``)."""
    from apex_tpu_torch.ops import layer_norm as ln

    plan = ln.norm_launch_plan(1, hidden, elem_bytes, sms=1,
                               ctas_per_sm=lambda vec, per_lane: 1)
    return ln.NORM_WARPS * plan.rows_per_warp


def candidates(rows: int, hidden: int, elem_bytes: int,
               sms: int) -> List[int]:
    """The ``block_rows`` values swept for one hidden size: the multiples
    of the default up to the last whose grid (``ceil(rows / block_rows)``)
    still covers every one of ``sms`` SMs; the default alone when even it
    does not."""
    base = default_block_rows(hidden, elem_bytes)
    out = [base]
    while -(-rows // (out[-1] + base)) >= sms:
        out.append(out[-1] + base)
    return out


def bound_ms(rows: int, hidden: int, elem_bytes: int) -> float:
    """The least time of K1 + K2 on the card: the larger of the bytes
    they must move (K1 reads x and writes y, K2 reads x and g and writes
    dx; the f32 mean and rstd are written once and read once, w and b
    read twice, dw and db written once) over the HBM rate, and their 8 +
    12 f32 operations a value over the f32 peak."""
    n = rows * hidden
    nbytes = 5 * n * elem_bytes + 4 * 4 * rows + 6 * 4 * hidden
    return max(nbytes / HBM_BYTES_PER_S, 20 * n / F32_FLOPS) * 1e3


def render_table(rows: int, dtype_name: str, backend: str,
                 blocks: Sequence[int],
                 times: Dict[int, Dict[int, float]]) -> str:
    """The reference's printed table and dict literal, for ``times``
    (hidden -> {block_rows: seconds of K1 + K2}); a block a hidden size
    did not sweep prints as ``-``."""
    inf = float("inf")
    out = [f"rows={rows} dtype={dtype_name} backend={backend}",
           f"{'hidden':>7} " + " ".join(f"br={b:<4d}" for b in blocks)
           + "  best (fwd+bwd us)"]
    best = {}
    for hidden, by_block in times.items():
        row = [by_block.get(b, inf) for b in blocks]
        ibest = min(range(len(blocks)), key=lambda i: row[i])
        best[hidden] = blocks[ibest]
        cells = " ".join(f"{t * 1e6:7.0f}" if t != inf else "      -"
                         for t in row)
        out.append(f"{hidden:>7} {cells}  -> br={blocks[ibest]}"
                   f" ({row[ibest] * 1e6:.0f}us)")
    out.append("\n_TUNED_BLOCK_ROWS = {")
    for h, b in best.items():
        out.append(f"    {h}: {b},")
    out.append("}")
    return "\n".join(out)


def winners(times: Dict[int, Dict[int, float]]) -> Dict[int, int]:
    """hidden -> the block_rows of its least time (the first on a tie, as
    the reference's ``min``)."""
    return {h: min(by_block, key=lambda b: by_block[b])
            for h, by_block in times.items()}


def _compare(tag, out, ref, tol):
    import torch

    out, ref = out.float(), ref.float()
    if not (bool(torch.isfinite(out).all())
            and bool(torch.allclose(out, ref, **tol))):
        err = float((out - ref).abs().max())
        raise AssertionError(f"{tag}: max |err| {err:.3e} over {tol}")


def _inputs(rows, hidden, dtype, gen):
    import torch

    x = torch.randn(rows, hidden, generator=gen, device="cuda").to(dtype)
    w = 1.0 + 0.1 * torch.randn(hidden, generator=gen, device="cuda")
    b = 0.1 * torch.randn(hidden, generator=gen, device="cuda")
    g = torch.randn(rows, hidden, generator=gen, device="cuda").to(dtype)
    return x, w, b, g


def check(x, w, b, g, block_rows: Optional[int], dtype_name: str) -> None:
    """K1 then K2 at ``block_rows`` against the plain versions on the
    same inputs; raises AssertionError on a mismatch."""
    from apex_tpu_torch.ops import layer_norm as ln

    tag = f"hidden={x.shape[1]} block_rows={block_rows}"
    y, mu, rstd = ln.layer_norm_fwd(x, w, b, eps=1e-5, rms=False,
                                    block_rows=block_rows)
    ry, rmu, rrstd = ln.layer_norm_reference(x, w, b, 1e-5, False)
    _compare(f"K1 {tag} y", y, ry, OUT_TOL[dtype_name])
    _compare(f"K1 {tag} mean", mu, rmu, STAT_TOL)
    _compare(f"K1 {tag} rstd", rstd, rrstd, STAT_TOL)
    dx, dw, db = ln.layer_norm_bwd(x, w, b, rmu, rrstd, g, rms=False,
                                   x_is_output=False, block_rows=block_rows)
    rdx, rdw, rdb = ln.layer_norm_bwd_reference(x, w, b, rmu, rrstd, g,
                                                False, False)
    _compare(f"K2 {tag} dx", dx, rdx, OUT_TOL[dtype_name])
    _compare(f"K2 {tag} dw", dw, rdw, SUM_TOL)
    _compare(f"K2 {tag} db", db, rdb, SUM_TOL)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()


#: the calls timed beside the candidates, each a forward and its backward
OTHER_CALLS = ("plain", "library")


def sweep(rows: int, hiddens: Sequence[int], dtype_name: str = "bf16",
          *, seed: int = 0, card: str = "", emit=print):
    """Check and time every (hidden, candidate), and the plain and library
    pairs; returns ``(times, defaults, others)``: hidden -> {block_rows:
    seconds of K1 + K2, the mean of the two passes}, hidden -> the default
    block_rows, and hidden -> {"plain" | "library": seconds}."""
    import torch

    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.tools.flash_tiles import _time_ms

    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    elem = DTYPES[dtype_name]
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    times: Dict[int, Dict[int, float]] = {}
    defaults, others = {}, {}
    for hidden in hiddens:
        x, w, b, g = _inputs(rows, hidden, dtype, gen)
        blocks = candidates(rows, hidden, elem, sms)
        defaults[hidden] = blocks[0]
        for br in blocks:
            check(x, w, b, g, br, dtype_name)
        _, mu, rstd = ln.layer_norm_fwd(x, w, b, eps=1e-5, rms=False)

        wl, bl = w.to(dtype), b.to(dtype)
        _, lmu, lrstd = torch.ops.aten.native_layer_norm(x, [hidden], wl,
                                                         bl, 1e-5)

        def pair(br):
            ln.layer_norm_fwd(x, w, b, eps=1e-5, rms=False, block_rows=br)
            ln.layer_norm_bwd(x, w, b, mu, rstd, g, rms=False,
                              x_is_output=False, block_rows=br)

        def plain():
            ln.layer_norm_reference(x, w, b, 1e-5, False)
            ln.layer_norm_bwd_reference(x, w, b, mu, rstd, g, False, False)

        def library():
            torch.ops.aten.native_layer_norm(x, [hidden], wl, bl, 1e-5)
            torch.ops.aten.native_layer_norm_backward(
                g, x, [hidden], lmu, lrstd, wl, bl, [True, True, True])

        calls = {br: (lambda _br=br: pair(_br)) for br in blocks}
        calls.update(plain=plain, library=library)
        # a discarded first reading: on an H100 the first timing after
        # the checks read up to 1.6x the same candidate's second
        _time_ms(calls[blocks[0]], flush)
        got: Dict[object, List[float]] = {}
        order = list(calls)
        for npass, keys in enumerate((order, order[::-1])):
            for key in keys:
                ms = _time_ms(calls[key], flush)
                got.setdefault(key, []).append(ms)
                line = ({"block_rows": key} if key not in OTHER_CALLS
                        else {"block_rows": None, "call": key})
                emit(json.dumps({"hidden": hidden, **line, "pass": npass,
                                 "ms": ms, "rows": rows,
                                 "dtype": dtype_name, "card": card}))
        mean_s = {key: statistics.mean(v) / 1e3 for key, v in got.items()}
        times[hidden] = {br: mean_s[br] for br in blocks}
        others[hidden] = {key: mean_s[key] for key in OTHER_CALLS}
        del x, w, b, g, mu, rstd, wl, bl, lmu, lrstd
        torch.cuda.empty_cache()
    return times, defaults, others


def ms_table(rows: int, dtype_name: str, card: str, times, defaults,
             others) -> str:
    """hidden, default block_rows and ms, best block_rows and ms, the
    bound, and the plain and library pairs, in ms (K1 + K2)."""
    out = [f"K1 + K2 ms (mean of the two passes), rows={rows} "
           f"{dtype_name} on {card}",
           f"{'hidden':>7} {'default':>8} {'ms':>8} {'best':>5} {'ms':>8} "
           f"{'bound':>8} {'plain':>8} {'library':>8}"]
    for hidden, by_block in times.items():
        d = defaults[hidden]
        b = min(by_block, key=lambda k: by_block[k])
        out.append(f"{hidden:>7} {d:>8d} {by_block[d] * 1e3:8.4f} {b:>5d} "
                   f"{by_block[b] * 1e3:8.4f} "
                   f"{bound_ms(rows, hidden, DTYPES[dtype_name]):8.4f} "
                   f"{others[hidden]['plain'] * 1e3:8.4f} "
                   f"{others[hidden]['library'] * 1e3:8.4f}")
    return "\n".join(out)


def write_cache(path: str, best: Dict[int, int], backend: str) -> None:
    """Merge each hidden size's winner into the tuning cache at ``path``
    under ``backend`` (this card's name)."""
    from apex_tpu_torch.ops import tune_cache

    for hidden, br in best.items():
        tune_cache.update_layer_norm(path, hidden=hidden, block_rows=br,
                                     backend=backend)


def tune(rows: int, dtype: str = "bf16", hiddens: Sequence[int] = HIDDENS,
         *, seed: int = 0, card: str = "", emit=print) -> Dict[int, int]:
    """The reference's ``tune``: sweep, print the table and the
    ``_TUNED_BLOCK_ROWS`` literal (and the ms table), and return hidden
    -> the fastest block_rows."""
    import torch

    times, defaults, others = sweep(rows, hiddens, dtype, seed=seed,
                                    card=card, emit=emit)
    blocks = sorted({b for by_block in times.values() for b in by_block})
    backend = torch.cuda.get_device_name(torch.cuda.current_device())
    emit(render_table(rows, DTYPE_NAMES[dtype], backend, blocks, times))
    emit(ms_table(rows, dtype, card, times, defaults, others))
    return winners(times)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--hidden", type=int, action="append", default=None,
                    help="sweep this hidden size (repeatable; default "
                    "the reference's HIDDENS)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--device", default="cuda",
                    help="the card (the sweep has no CPU counterpart)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-out", metavar="FILE", default=None,
                    help="merge each hidden size's winner into this "
                    "tuning cache")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    if not str(args.device).startswith("cuda") or \
            not torch.cuda.is_available():
        print("ln_tune needs a CUDA device: it times K1 and K2 on the card",
              file=sys.stderr)
        return 2
    if torch.device(args.device).index is not None:
        torch.cuda.set_device(torch.device(args.device))
    card = _card()
    print(card, flush=True)
    try:
        best = tune(args.rows, args.dtype, args.hidden or HIDDENS,
                    seed=args.seed, card=card,
                    emit=lambda s: print(s, flush=True))
    except AssertionError as e:
        print(f"ln_tune: a candidate disagrees with the plain version: {e}",
              file=sys.stderr)
        return 1
    if args.cache_out:
        write_cache(args.cache_out, best,
                    torch.cuda.get_device_name(torch.cuda.current_device()))
        print(f"cache: {args.cache_out} <- {best}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

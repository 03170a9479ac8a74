"""Kernel dispatch: the device rule, path triage and launch counters.

Counterpart of ``apex_tpu/ops/_dispatch.py``.  Every op here has two
implementations with the same numerics:

- a **plain path** — plain PyTorch, the correctness reference, and what
  runs for tensors on the CPU (the parity tests);
- a **kernel path** — a hand-written CUDA C++ kernel (``csrc/``), which
  runs for tensors on a CUDA device.

The device of the operands decides, and nothing else: there is no
switch that routes CUDA tensors to the plain code, and a kernel that
cannot build or launch raises instead of falling back.

Each kernel wrapper launches through :func:`launch`, which adds one to
the kernel's launch counter right after the kernel launched, so a run
can show that its main path went through the kernels (``chip_smoke.py``
zeroes the counters, drives the path, and reads them).  A CUDA graph
runs its kernels without Python: the serving engine records the
launches of the step it captures (:func:`recorded_apart`) and adds them
on every replay (:func:`replay_record`), so the counts stay exact.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, Optional, Sequence

import torch

from apex_tpu_torch.ops import _build

__all__ = [
    "resolve_device",
    "on_card",
    "record_path",
    "last_paths",
    "clear_paths",
    "count_launch",
    "launch",
    "launch_signatures",
    "launch_variants",
    "launches",
    "query",
    "record_signatures",
    "signature",
    "launch_dtypes",
    "reset_launches",
    "recorded_apart",
    "replay_record",
]


def resolve_device(device) -> torch.device:
    """The device an entry point was asked to run on.  Entry points
    default to ``"cuda"`` and raise here when no GPU is present — the
    CPU only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: apex_tpu_torch runs on the "
                "card by default; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every operand lies on a CUDA device (take the kernel),
    False when every operand lies on the CPU (take the plain version).
    Mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(
        f"operands must all lie on one CUDA device or all on the CPU, "
        f"got devices {sorted(kinds)}"
    )


_PATH_LOG: Dict[str, str] = {}


def record_path(op: str, path: str) -> None:
    """Record which implementation ``op`` took ("cuda" | "torch") on
    its most recent call."""
    _PATH_LOG[op] = path


def last_paths() -> Dict[str, str]:
    """op name -> "cuda" | "torch" for every op called since import
    (or the last :func:`clear_paths`)."""
    return dict(_PATH_LOG)


def clear_paths() -> None:
    _PATH_LOG.clear()


#: kernel -> {defines: launches} of tuned variants (:func:`launch_variants`)
_VARIANTS: Dict[str, Dict[tuple, int]] = {}
#: the distinct launches since :func:`record_signatures` (None: off)
SIGNATURES: Optional[Dict[tuple, int]] = None
#: kernel -> its ctypes argument types, as its wrapper last passed them
_ARGTYPES: Dict[str, tuple] = {}

#: the step recorders of :func:`apex_tpu_torch.analysis.passes.capture`
#: that are running: each launch is reported to them as one opaque node
RECORDERS: list = []

#: kernel name -> launches since the last :func:`reset_launches`
_LAUNCHES: Dict[str, int] = {}
#: kernel name -> {operand dtype: launches}, for the launches whose
#: wrapper names the dtype of the operands it passed
_DTYPES: Dict[str, Dict[str, int]] = {}


def count_launch(kernel: str, dtype: Optional[torch.dtype] = None) -> None:
    """Called by a kernel wrapper right after its kernel launched;
    ``dtype`` (of the main operand, e.g. the rows of K1/K2) is tallied
    apart (:func:`launch_dtypes`)."""
    _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + 1
    if dtype is not None:
        by = _DTYPES.setdefault(kernel, {})
        name = str(dtype).replace("torch.", "")
        by[name] = by.get(name, 0) + 1


def _entry(kernel: str, argtypes: Sequence, defines: Sequence[str] = ()):
    fn = getattr(_build.load(_build.library(kernel), defines), kernel)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def launch(kernel: str, argtypes: Sequence, device: torch.device,
           *args, dtype: Optional[torch.dtype] = None,
           defines: Sequence[str] = ()) -> None:
    """Call the C entry point ``kernel`` of its source (``csrc/<kernel>.cu``
    or the one ``_build.ENTRY_POINTS`` names; built on first use, with
    ``defines`` for a tuned variant) with ``args`` and the current stream
    of ``device`` appended, raise if it reports a CUDA error, and count
    the launch under ``kernel`` (and under ``dtype``, the main operand's,
    when given; and under ``defines`` when a variant ran).  ``argtypes``
    are its ctypes argument types, the stream's last."""
    defines = tuple(defines)
    fn = _entry(kernel, argtypes, defines)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(kernel, rc, defines)
    count_launch(kernel, dtype)
    if defines:
        by = _VARIANTS.setdefault(kernel, {})
        by[defines] = by.get(defines, 0) + 1
    if SIGNATURES is not None:
        key = (kernel, defines, signature(argtypes, args))
        SIGNATURES[key] = SIGNATURES.get(key, 0) + 1
        _ARGTYPES[kernel] = tuple(argtypes)
    for rec in RECORDERS:
        rec.note_launch(kernel, argtypes, args, dtype)


def signature(argtypes: Sequence, args: Sequence) -> tuple:
    """A launch's arguments as its dispatch reads them: every pointer
    reduced to 0 (null), 16, 4 or 1 (its alignment), the rest as given
    (the stream dropped)."""
    return tuple(
        (0 if not v else 16 if v % 16 == 0 else 4 if v % 4 == 0 else 1)
        if ty is ctypes.c_void_p else v
        for ty, v in zip(argtypes, args))


def launch_variants() -> Dict[str, Dict[tuple, int]]:
    """kernel -> {defines: launches} of the tuned variants launched since
    the last :func:`reset_launches` (the default build is not listed)."""
    return {k: dict(v) for k, v in _VARIANTS.items()}


def record_signatures(on: bool = True) -> None:
    """Start (or stop and forget) the log of distinct launches that
    :func:`launch_signatures` returns (off by default: it costs a few
    microseconds a launch)."""
    global SIGNATURES
    SIGNATURES = {} if on else None


def launch_signatures() -> Dict[tuple, int]:
    """``{(kernel, defines, signature): launches}`` since
    :func:`record_signatures`."""
    return dict(SIGNATURES or {})


#: a placeholder address of each pointer class (16-, 4- and 1-byte
#: aligned) for :func:`query`
_PLACEHOLDER = {16: 1 << 20, 4: (1 << 20) + 4, 1: (1 << 20) + 1}


def query(kernel: str, sig: tuple, device, defines: Sequence[str] = (),
          argtypes: Optional[Sequence] = None) -> list:
    """The card's own figures for the launches that C entry point
    ``kernel`` makes for the arguments ``sig`` (:func:`signature`), asked
    without launching (``csrc/launch_query.cuh``): one dict per
    ``__global__`` launch with ``regs``, ``static_smem``,
    ``max_dyn_smem``, ``dyn_smem``, ``threads``, ``ctas_per_sm``,
    ``grid`` and ``local_bytes``."""
    argtypes = tuple(argtypes or _ARGTYPES[kernel])
    fn = _entry(kernel, argtypes, tuple(defines))
    lib = _build.load(_build.library(kernel), tuple(defines))
    lib.apex_query_begin.argtypes = [ctypes.POINTER(ctypes.c_int),
                                     ctypes.c_int]
    lib.apex_query_begin.restype = None
    lib.apex_query_end.restype = ctypes.c_int
    cap = 4
    out = (ctypes.c_int * (8 * cap))()
    args = [(_PLACEHOLDER[v] if v else None) if ty is ctypes.c_void_p else v
            for ty, v in zip(argtypes, sig)]
    with torch.cuda.device(device):
        lib.apex_query_begin(out, cap)
        try:
            rc = fn(*args, None)
        finally:
            n = lib.apex_query_end()
    _build.check(kernel, rc, tuple(defines))
    keys = ("regs", "static_smem", "max_dyn_smem", "dyn_smem", "threads",
            "ctas_per_sm", "grid", "local_bytes")
    return [dict(zip(keys, out[8 * i: 8 * i + 8])) for i in range(min(n, cap))]


def launches() -> Dict[str, int]:
    return dict(_LAUNCHES)


def launch_dtypes() -> Dict[str, Dict[str, int]]:
    """kernel -> {dtype name: launches} since the last
    :func:`reset_launches` (what shows, e.g., that K1/K2 ran on f32 rows
    under O1)."""
    return {k: dict(v) for k, v in _DTYPES.items()}


def reset_launches() -> None:
    _LAUNCHES.clear()
    _DTYPES.clear()
    _VARIANTS.clear()


@contextlib.contextmanager
def recorded_apart() -> Iterator[dict]:
    """Record the launches and paths of the block apart, and leave the
    counters and the path log as they were.  Yields ``{"launches":
    {kernel: n}, "paths": {op: path}}``, filled when the block ends.
    A captured CUDA graph's launches are counted in Python once, at
    capture (where no kernel runs); the engine records them so, and adds
    them on every replay (:func:`replay_record`)."""
    saved_launches, saved_paths = dict(_LAUNCHES), dict(_PATH_LOG)
    saved_dtypes = launch_dtypes()
    _LAUNCHES.clear()
    _PATH_LOG.clear()
    _DTYPES.clear()
    rec: dict = {}
    try:
        yield rec
    finally:
        rec["launches"], rec["paths"] = dict(_LAUNCHES), dict(_PATH_LOG)
        rec["dtypes"] = launch_dtypes()
        _LAUNCHES.clear()
        _LAUNCHES.update(saved_launches)
        _PATH_LOG.clear()
        _PATH_LOG.update(saved_paths)
        _DTYPES.clear()
        _DTYPES.update(saved_dtypes)


def replay_record(rec: dict) -> None:
    """Count the launches of one replay of a graph whose capture
    :func:`recorded_apart` recorded as ``rec``, under the same names, and
    record its paths."""
    for kernel, n in rec["launches"].items():
        _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + n
    for kernel, by in rec.get("dtypes", {}).items():
        mine = _DTYPES.setdefault(kernel, {})
        for name, n in by.items():
            mine[name] = mine.get(name, 0) + n
    _PATH_LOG.update(rec["paths"])

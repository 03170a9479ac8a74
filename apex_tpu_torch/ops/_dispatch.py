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
    "launches",
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


def launch(kernel: str, argtypes: Sequence, device: torch.device,
           *args, dtype: Optional[torch.dtype] = None) -> None:
    """Call the C entry point ``kernel`` of its source (``csrc/<kernel>.cu``
    or the one ``_build.ENTRY_POINTS`` names; built on first use) with
    ``args`` and the current stream of ``device`` appended, raise if it
    reports a CUDA error, and count the launch under ``kernel`` (and
    under ``dtype``, the main operand's, when given).  ``argtypes`` are
    its ctypes argument types, the stream's last."""
    fn = getattr(_build.load(_build.library(kernel)), kernel)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(kernel, rc)
    count_launch(kernel, dtype)


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

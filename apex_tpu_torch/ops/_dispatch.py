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

Each kernel wrapper adds one to its launch counter right after its
kernel launched, so a run can show that its main path went through the
kernels (``chip_smoke.py`` zeroes the counters, drives the path, and
reads them).
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = [
    "resolve_device",
    "on_card",
    "record_path",
    "last_paths",
    "clear_paths",
    "count_launch",
    "launches",
    "reset_launches",
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


def count_launch(kernel: str) -> None:
    """Called by a kernel wrapper right after its kernel launched."""
    _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + 1


def launches() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launches() -> None:
    _LAUNCHES.clear()

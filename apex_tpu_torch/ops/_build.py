"""Build and load the hand-written CUDA kernels of ``apex_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/apex_tpu_torch/<name>-<hash>.so`` at the repository root
(an installed copy of the package, outside a checkout, builds under the
per-user cache ``$XDG_CACHE_HOME/apex_tpu_torch``, by default
``~/.cache/apex_tpu_torch``), with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
-shared -Xcompiler -fPIC``.  The hash covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited kernel rebuilds and
an unchanged one is reused.  The
libraries load through :mod:`ctypes` (no PyTorch headers in the build,
which keeps each build to seconds).

:func:`build` starts one ``nvcc`` per missing library, all at once, and
waits for them; :func:`load` builds on first use.  Every C entry point
returns ``cudaGetLastError()`` after its launch and the wrappers raise
through :func:`check` when it is not zero.  A build that fails raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KERNELS", "build", "load", "check", "build_log", "source_path"]

#: every kernel source of the package (``csrc/<name>.cu``)
KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd", "flash_bwd",
           "paged_decode")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"


def _build_dir() -> Path:
    root = _PKG.parent
    if (root / "setup.py").is_file():  # a source checkout
        return root / "build" / "apex_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "apex_tpu_torch"


_BUILD = _build_dir()

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, str] = {}


def source_path(name: str) -> Path:
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; known: {KERNELS}")
    return _CSRC / f"{name}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if _DEFAULT_NVCC.exists():
        return str(_DEFAULT_NVCC)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): the "
        "CUDA kernels of apex_tpu_torch build on a machine with the CUDA "
        "toolkit"
    )


def _target(name: str) -> Path:
    # the shared headers (csrc/*.cuh) count in every kernel's hash
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        source_path(name).read_bytes() + headers
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return _BUILD / f"{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet — one
    ``nvcc`` process per source, started together — and return name ->
    library path.  Raises with the compiler's output on failure."""
    names = tuple(names)
    targets = {n: _target(n) for n in names}
    todo = [n for n in names if not targets[n].exists()]
    if not todo:
        return targets
    nvcc = _nvcc()
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = targets[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(n))]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        _LOGS[n] = out
        if proc.returncode:
            failed.append(f"--- {n} (exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of ``name``'s build in this process, or "" if it was
    already built."""
    return _LOGS.get(name, "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        lib.apex_error_string.argtypes = [ctypes.c_int]
        lib.apex_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code:
        msg = _LIBS[name].apex_error_string(code).decode()
        raise RuntimeError(f"kernel {name} failed to launch: {msg} ({code})")

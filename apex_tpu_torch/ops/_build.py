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
from typing import Dict, Iterable, Sequence

__all__ = ["ENTRY_POINTS", "KERNELS", "build", "load", "library", "check",
           "build_log", "source_path"]

#: every kernel source of the package (``csrc/<name>.cu``)
KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd", "flash_bwd",
           "flash_dbias", "paged_decode", "flash_f32")

#: C entry points that live in a source of another name (entry -> source);
#: every other entry point is the function of its own name in
#: ``csrc/<name>.cu``.  The f32 instances of K3, K4 and K5 share one source;
#: K4 with K5's dbias in its dQ pass lives in K4's.
ENTRY_POINTS = {"flash_fwd_f32": "flash_f32", "flash_bwd_f32": "flash_f32",
                "flash_dbias_f32": "flash_f32",
                "flash_bwd_dbias": "flash_bwd"}

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

_LIBS: Dict[tuple, ctypes.CDLL] = {}  # (source, defines) -> library
_LOGS: Dict[Path, str] = {}  # library path -> compiler output


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


def _target(name: str, flags: Sequence[str]) -> Path:
    # the shared headers (csrc/*.cuh) count in every kernel's hash
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        source_path(name).read_bytes() + headers + " ".join(flags).encode()
    ).hexdigest()[:16]
    return _BUILD / f"{name}-{digest}.so"


def _flags(defines: Sequence[str]):
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def build(names: Iterable[str] = KERNELS,
          defines: Sequence[str] = ()) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet — one
    ``nvcc`` process per source, started together — and return name ->
    library path.  ``defines`` (``NAME=VALUE``) become ``-D`` flags, for
    a sweep over a kernel's compile-time shape.  Raises with the
    compiler's output on failure."""
    names = tuple(names)
    flags = _flags(defines)
    targets = {n: _target(n, flags) for n in names}
    todo = [n for n in names if not targets[n].exists()]
    if not todo:
        return targets
    nvcc = _nvcc()
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = targets[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *flags, "-o", str(tmp), str(source_path(n))]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        _LOGS[targets[n]] = out
        if proc.returncode:
            failed.append(f"--- {n} (exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def build_log(name: str, defines: Sequence[str] = ()) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of ``name``'s build (with ``defines``) in this process, or
    "" if it was already built."""
    return _LOGS.get(_target(name, _flags(defines)), "")


def library(entry: str) -> str:
    """The source (library) name that holds C entry point ``entry``."""
    return ENTRY_POINTS.get(entry, entry)


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built with
    ``defines``: a tuned variant, :mod:`.tune_cache`), built on first
    use."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build([name], defines)[name]))
        lib.apex_error_string.argtypes = [ctypes.c_int]
        lib.apex_error_string.restype = ctypes.c_char_p
        _LIBS[key] = lib
    return lib


def check(name: str, code: int, defines: Sequence[str] = ()) -> None:
    """Raise if C entry point ``name`` reported a CUDA error."""
    if code:
        lib = _LIBS[(library(name), tuple(defines))]
        msg = lib.apex_error_string(code).decode()
        raise RuntimeError(f"kernel {name} failed to launch: {msg} ({code})")

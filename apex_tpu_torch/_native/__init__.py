"""Native host ops — counterpart of :mod:`apex_tpu._native`: the port's
own ``host_ops.cpp``, built with ``g++ -O3`` at first use into
``build/apex_tpu_torch/`` (the kernels' build directory, the library
named by its source's digest, so an edited source rebuilds) and bound
through ``ctypes``.

``flatten_f32`` / ``unflatten_f32`` (≙ ``apex_C.flatten``/``unflatten``
on the host), ``gather_rows`` (the data loader's batch assembly) and
``mlm_mask_batch`` (BERT's masked-LM corruption) run threaded in C++.
On a host without ``g++`` every function runs its numpy replay instead,
the reference's documented behaviour for a host op: the same results,
bit for bit (the MLM replay walks the same splitmix64 stream).
:func:`available` builds and tells which path a caller gets;
``NATIVE_AVAILABLE`` is its last answer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "NATIVE_AVAILABLE",
    "available",
    "flatten_f32",
    "unflatten_f32",
    "mlm_mask_batch",
    "gather_rows",
]

_SRC = Path(__file__).resolve().parent / "host_ops.cpp"
_GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_LIB: Optional[ctypes.CDLL] = None
_LOAD_FAILED = False  # a failed build is not retried on every batch
NATIVE_AVAILABLE = False


def library_path() -> Path:
    """Where the library is (or will be) built."""
    from apex_tpu_torch.ops._build import _BUILD

    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_GXX_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"host_ops-{digest}.so"


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LOAD_FAILED, NATIVE_AVAILABLE
    if _LIB is not None:
        return _LIB
    if _LOAD_FAILED:
        return None
    so = library_path()
    try:
        if not so.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise OSError("g++ not found")
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([gxx, *_GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError):
        _LOAD_FAILED = True
        return None
    i64 = ctypes.c_int64
    lib.apex_flatten_f32.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(i64), i64,
        ctypes.c_void_p, i64,
    ]
    lib.apex_unflatten_f32.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(i64), i64,
        ctypes.POINTER(ctypes.c_void_p), i64,
    ]
    lib.apex_mlm_mask.argtypes = [
        ctypes.c_void_p, i64, ctypes.c_uint64, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, i64,
    ]
    lib.apex_gather_rows.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(i64), i64, i64, ctypes.c_void_p, i64,
    ]
    _LIB = lib
    NATIVE_AVAILABLE = True
    return lib


def available() -> bool:
    """Whether the native library is (or can be) loaded: builds it on
    first call.  Prefer this to ``NATIVE_AVAILABLE``, which an import
    snapshots before the build."""
    return _load() is not None


def threads() -> int:
    """The most worker threads a native call uses."""
    return min(8, os.cpu_count() or 1)


#: the least work a native call gives each of its threads: starting a
#: thread costs tens of microseconds, more than copying a batch of BERT's
#: ids or corrupting them, so a small call runs on one thread (the
#: results are the same bits on any number of threads)
_BYTES_PER_THREAD = 4 << 20
_IDS_PER_THREAD = 1 << 18


def _threads_for(work: int, per_thread: int) -> int:
    return max(1, min(threads(), int(work) // per_thread))


def flatten_f32(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """Concatenate f32 host arrays into one flat buffer (threaded
    memcpy)."""
    arrays = [np.ascontiguousarray(a, dtype=np.float32) for a in arrays]
    out = np.empty((sum(a.size for a in arrays),), np.float32)
    lib = _load()
    if lib is None:
        np.concatenate([a.ravel() for a in arrays], out=out)
        return out
    n = len(arrays)
    srcs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
    sizes = (ctypes.c_int64 * n)(*[a.size for a in arrays])
    lib.apex_flatten_f32(srcs, sizes, n, out.ctypes.data,
                         _threads_for(out.nbytes, _BYTES_PER_THREAD))
    return out


def unflatten_f32(flat: np.ndarray,
                  like: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Split a flat f32 buffer back into arrays shaped like ``like``."""
    flat = np.ascontiguousarray(flat, dtype=np.float32)
    sizes = [int(a.size) for a in like]
    if flat.size != sum(sizes):
        raise ValueError(
            f"flat buffer has {flat.size} elements, need {sum(sizes)}")
    outs = [np.empty(a.shape, np.float32) for a in like]
    lib = _load()
    if lib is None:
        off = 0
        for o, s in zip(outs, sizes):
            o.ravel()[:] = flat[off: off + s]
            off += s
        return outs
    n = len(outs)
    dsts = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    csizes = (ctypes.c_int64 * n)(*sizes)
    lib.apex_unflatten_f32(flat.ctypes.data, csizes, n, dsts,
                           _threads_for(flat.nbytes, _BYTES_PER_THREAD))
    return outs


def gather_rows(base: np.ndarray, row_starts: np.ndarray,
                row_elems: int) -> np.ndarray:
    """``out[i] = base[row_starts[i] : row_starts[i] + row_elems]`` as
    one contiguous ``(len(row_starts), row_elems)`` array in
    ``base.dtype``: a batch's rows of a memory-mapped token file
    (``base`` 1-D, ``row_starts`` element offsets), gathered by a
    threaded memcpy."""
    base = np.ascontiguousarray(base).ravel()
    starts = np.ascontiguousarray(row_starts, dtype=np.int64)
    if starts.size and (
        starts.min() < 0 or starts.max() + row_elems > base.size
    ):
        raise IndexError(
            f"row [{starts.min()}, {starts.max()} + {row_elems}) out of "
            f"bounds for base of {base.size} elements")
    out = np.empty((starts.size, row_elems), base.dtype)
    lib = _load()
    if lib is None:
        for i, s in enumerate(starts):
            out[i] = base[s: s + row_elems]
        return out
    item = base.dtype.itemsize
    offsets = (starts * item).astype(np.int64)
    lib.apex_gather_rows(
        base.ctypes.data,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        starts.size, row_elems * item, out.ctypes.data,
        _threads_for(out.nbytes, _BYTES_PER_THREAD))
    return out


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _u01(bits: np.ndarray) -> np.ndarray:
    return (bits >> np.uint64(11)).astype(np.float64) / 9007199254740992.0


def mlm_mask_batch(ids: np.ndarray, seed: int, *, mask_prob: float = 0.15,
                   mask_id: int = 103, vocab_size: int = 30522,
                   special_floor: int = 1000):
    """BERT's 80/10/10 masked-LM corruption of int32 ``ids`` (any
    shape): ``(masked_ids, labels)`` with ``labels = -1`` where a
    position was not selected; ids below ``special_floor`` are never
    selected.  Deterministic in (seed, position) through a counter-based
    splitmix64 stream, so the native and numpy paths give the same
    bits."""
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    out_ids = np.empty_like(ids)
    labels = np.empty_like(ids)
    lib = _load()
    if lib is not None:
        lib.apex_mlm_mask(
            ids.ctypes.data, ids.size, ctypes.c_uint64(seed),
            float(mask_prob), np.int32(mask_id), np.int32(vocab_size),
            np.int32(special_floor), out_ids.ctypes.data,
            labels.ctypes.data, _threads_for(ids.size, _IDS_PER_THREAD))
        return out_ids, labels
    # the numpy replay of the same stream
    flat = ids.ravel()
    idx = np.arange(flat.size, dtype=np.uint64)
    r0 = _splitmix64(np.uint64(seed) ^ idx)
    selected = (flat >= special_floor) & (_u01(r0) < mask_prob)
    r1 = _splitmix64(r0)
    action = _u01(r1)
    r2 = _splitmix64(r1)
    rand_tok = special_floor + (
        _splitmix64(r2) % np.uint64(vocab_size - special_floor)
    ).astype(np.int32)
    out = flat.copy()
    out[selected & (action < 0.8)] = mask_id
    mid = selected & (action >= 0.8) & (action < 0.9)
    out[mid] = rand_tok[mid]
    out_ids[...] = out.reshape(ids.shape)
    labels[...] = np.where(selected, flat, -1).astype(np.int32).reshape(
        ids.shape)
    return out_ids, labels

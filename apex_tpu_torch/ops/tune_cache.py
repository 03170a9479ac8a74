"""On-disk kernel tuning cache: measured winners as an artifact.

Counterpart of ``apex_tpu/ops/pallas/tune_cache.py``, with its schema,
its first-match rule and its wildcards.  The reference's entries name the
Pallas tiles of a call; the port's kernels fix their tiles at build time,
so a ``flash_attention`` entry names the build ``defines`` of a K3/K4
variant (``APEX_FLASH_FWD_BLOCK_K``, ``APEX_FLASH_FWD_STAGES``,
``APEX_FLASH_BWD_STAGES``: the macros ``tools/flash_tiles.py`` sweeps),
and a ``layer_norm`` entry overrides the rows a CTA of K1/K2 takes per
pass (:func:`~apex_tpu_torch.ops.layer_norm.norm_launch_plan`'s
``block_rows``):

- ``APEX_TPU_TUNE_CACHE=/path/to/cache.json`` is read on the first
  lookup (and again when the variable changes);
- the wrappers of ``ops/attention.py`` and ``ops/layer_norm.py`` consult
  :func:`flash_defines` and :func:`layer_norm_block_rows` on every
  launch; with no file, or no matching entry, every launch is the
  default build;
- ``python -m apex_tpu_torch.tools.flash_tiles --cache-out FILE`` merges
  its winners in (:func:`update_flash`).

Schema (JSON, one object; each ``repo-lint: allow`` waives the source
lint on a line of the example, whose defines are no call site)::

    {"version": 1,
     "flash_attention": [
        {"sq": 2048, "d": 64, "causal": true,
         "dtype": "bfloat16" | null,          # null = any dtype
         "backend": "NVIDIA H100" | null,     # null = any; prefix-matched
         "defines": {"fwd": ["APEX_FLASH_FWD_BLOCK_K=64",  # repo-lint: allow
                             "APEX_FLASH_FWD_STAGES=2"],   # repo-lint: allow
                     "bwd": ["APEX_FLASH_BWD_STAGES=2"]},  # repo-lint: allow
         "tiles": {"fwd": [128, 64]}}],       # the reference's key, kept
     "layer_norm": [
        {"hidden": 1024, "backend": null, "block_rows": 64}]}

``backend`` is matched by prefix against ``torch.cuda.get_device_name``
(``""`` without a card).  The FIRST matching entry wins.  A malformed file
warns once and is ignored.  A variant that fails to build raises at its
first launch: the dispatch never falls back to another build or to the
plain twin.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Optional, Tuple

__all__ = [
    "ENV_VAR",
    "flash_defines",
    "flash_tiles",
    "layer_norm_block_rows",
    "load",
    "update_flash",
    "update_layer_norm",
    "reset",
]

ENV_VAR = "APEX_TPU_TUNE_CACHE"

#: (path, parsed dict) of the last load; cleared by :func:`reset`
_CACHE: Optional[tuple] = None


def reset() -> None:
    """Forget the loaded cache (the next lookup re-reads the file)."""
    global _CACHE
    _CACHE = None


def _backend_kind() -> str:
    import torch

    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(torch.cuda.current_device())


def load(path: Optional[str] = None) -> dict:
    """Parse ``path`` (default: ``$APEX_TPU_TUNE_CACHE``); ``{}`` when
    unset, missing or malformed (malformed warns)."""
    path = path or os.environ.get(ENV_VAR)
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise ValueError("cache root must be a JSON object")
        return data
    except (ValueError, OSError) as e:
        warnings.warn(f"ignoring malformed tuning cache {path!r}: {e}",
                      stacklevel=2)
        return {}


def _cached() -> dict:
    global _CACHE
    path = os.environ.get(ENV_VAR) or ""
    if _CACHE is None or _CACHE[0] != path:
        _CACHE = (path, load(path or None))
    return _CACHE[1]


def _match(entry: dict, *, dtype: Optional[str], backend: str) -> bool:
    want_dtype = entry.get("dtype")
    if want_dtype is not None and dtype is not None and want_dtype != dtype:
        return False
    want_backend = entry.get("backend")
    if want_backend is not None and not backend.startswith(want_backend):
        return False
    return True


def _dtype_name(dtype) -> Optional[str]:
    if dtype is None:
        return None
    name = getattr(dtype, "name", None)
    if isinstance(name, str):
        return name
    return str(dtype).replace("torch.", "")


def _flash_entries(sq: int, d: int, causal: bool, dtype):
    entries = _cached().get("flash_attention")
    if not entries:
        return
    dtype_name = _dtype_name(dtype)
    backend = _backend_kind()
    for entry in entries:
        if not isinstance(entry, dict):
            continue
        if entry.get("sq") != sq or entry.get("d") != d:
            continue
        if bool(entry.get("causal")) != bool(causal):
            continue
        if _match(entry, dtype=dtype_name, backend=backend):
            yield entry


def flash_tiles(mode: str, sq: int, d: int, causal: bool,
                dtype=None) -> Optional[Tuple[int, int]]:
    """The cached ``(block_q, block_k)`` of a flash-attention call, or
    None: the reference's lookup over the same file (``mode`` "fwd",
    "bwd" or "bwd_dq")."""
    for entry in _flash_entries(sq, d, causal, dtype):
        pair = (entry.get("tiles") or {}).get(mode)
        if (isinstance(pair, (list, tuple)) and len(pair) == 2
                and all(isinstance(x, int) and x > 0 for x in pair)):
            return (pair[0], pair[1])
    return None


def flash_defines(mode: str, sq: int, d: int, causal: bool,
                  dtype=None) -> Tuple[str, ...]:
    """The build defines of the K3 (``mode`` "fwd") or K4 ("bwd") variant
    the cache names for this call, ``()`` for the default build.  The
    first entry for the call's key that names ``mode`` wins."""
    for entry in _flash_entries(sq, d, causal, dtype):
        got = (entry.get("defines") or {}).get(mode)
        if isinstance(got, (list, tuple)) and all(
                isinstance(x, str) and x for x in got):
            return tuple(got)
    return ()


def layer_norm_block_rows(hidden: int) -> Optional[int]:
    """The cached rows a CTA of K1/K2 takes per pass, or None."""
    entries = _cached().get("layer_norm")
    if not entries:
        return None
    backend = _backend_kind()
    for entry in entries:
        if not isinstance(entry, dict) or entry.get("hidden") != hidden:
            continue
        if not _match(entry, dtype=None, backend=backend):
            continue
        br = entry.get("block_rows")
        if isinstance(br, int) and br > 0:
            return br
    return None


def _merge_write(path: str, section: str, key_fields: tuple, entry: dict,
                 merge=None):
    data = load(path) if os.path.exists(path) else {}
    data.setdefault("version", 1)
    entries = [e for e in data.get(section, []) if isinstance(e, dict)]
    kept = []
    for e in entries:
        if any(e.get(k) != entry.get(k) for k in key_fields):
            kept.append(e)
        elif merge is not None:
            # a fwd winner survives a later bwd write for the same key
            entry = merge(e, entry)
    data[section] = [entry] + kept
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    reset()


def update_flash(path: str, *, sq: int, d: int, causal: bool,
                 defines: Optional[dict] = None, tiles: Optional[dict] = None,
                 dtype: Optional[str] = None,
                 backend: Optional[str] = None) -> None:
    """Merge one flash-attention winner into the cache at ``path``
    (atomic replace).  An entry with the same (sq, d, causal, dtype,
    backend) keeps the modes the new write does not carry."""

    def merge(old: dict, new: dict) -> dict:
        out = dict(new)
        for key in ("defines", "tiles"):
            merged = dict(old.get(key) or {})
            merged.update(new.get(key) or {})
            if merged:
                out[key] = merged
        return out

    entry = {"sq": int(sq), "d": int(d), "causal": bool(causal),
             "dtype": dtype, "backend": backend}
    if defines:
        entry["defines"] = {m: [str(x) for x in v]
                            for m, v in defines.items()}
    if tiles:
        entry["tiles"] = {m: [int(p[0]), int(p[1])]
                          for m, p in tiles.items() if p}
    _merge_write(path, "flash_attention",
                 ("sq", "d", "causal", "dtype", "backend"), entry,
                 merge=merge)


def update_layer_norm(path: str, *, hidden: int, block_rows: int,
                      backend: Optional[str] = None) -> None:
    """Merge one layer-norm winner into the cache at ``path``."""
    _merge_write(path, "layer_norm", ("hidden", "backend"),
                 {"hidden": int(hidden), "backend": backend,
                  "block_rows": int(block_rows)})

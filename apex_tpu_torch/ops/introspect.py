"""The analyzable shape of one CUDA kernel launch.

Counterpart of ``apex_tpu/ops/pallas/introspect.py``.  The reference
describes a ``pallas_call`` by its grid and block specs; a launch here is
described by what its C launcher computes: the ``__global__`` instance it
picks (the template arguments), the grid, the threads per CTA, the
dynamic shared memory, and the tiles, rings and products the instance
runs.  Each op module exports ``kernel_specs(...)`` built from the same
rules as its ``.cu`` launcher (``ops/layer_norm.py``, ``ops/attention.py``,
``ops/paged_attention.py``); :mod:`apex_tpu_torch.analysis.kernels` lints
them and computes their rooflines, and ``chip_smoke.py`` holds them
against the card's own figures (``csrc/launch_query.cuh``).

:func:`specs_from_launch` rebuilds the specs of a recorded launch from
its C arguments (the pointers reduced to their null-ness and alignment,
:func:`pointer_class`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["KernelSpec", "pointer_class", "specs_from_launch",
           "SMEM_OPTIN_BYTES"]

#: the H100's opt-in shared memory per CTA (227 KB); a launcher that asks
#: for more fails to launch
SMEM_OPTIN_BYTES = 227 * 1024


@dataclasses.dataclass
class KernelSpec:
    """One ``__global__`` launch of a C entry point.

    - ``name``/``instance``: the kernel and its template arguments as the
      toolkit's demangler prints them (``flash_fwd_kernel``, ``<64, 0,
      false>``);
    - ``grid``, ``threads``, ``smem_bytes`` (dynamic shared memory the
      launch requests) and ``min_blocks`` (``__launch_bounds__``' second
      argument);
    - ``mma``: the tensor-core product the instance issues, ``{"op":
      "wgmma" | "mma.sync", "m", "n", "k", "dtype"}``; ``tma``: the TMA
      boxes it loads, ``((rows, inner bytes), ...)``;
    - ``items``: the work map, ``{"n_items", "per_cta": "persistent" |
      "one"}`` — a persistent grid walks items ``c, c + grid, ...``;
      ``writes``: the outputs its items own;
    - ``causal``: the causal walk's geometry (``bq``, ``bk``, ``nq``,
      ``nk``, ``offset``, ``include_fully_masked``, ``heads``) and
      ``flops_per_cell``, for the dead-tile accounting;
    - ``work``: the call's useful work, ``{"bytes", "ops", "peak"}`` —
      each input read once, each output written once, the operations on
      ``peak``'s units ("bf16_tensor", "tf32_tensor", "f32") — the
      roofline's bound.
    """

    name: str
    entry: str
    instance: str
    grid: int
    threads: int
    smem_bytes: int
    min_blocks: int = 1
    dtype: str = "bfloat16"
    tile: Dict[str, int] = dataclasses.field(default_factory=dict)
    stages: int = 1
    mma: Optional[Dict[str, object]] = None
    tma: Tuple[Tuple[int, int], ...] = ()
    items: Optional[Dict[str, object]] = None
    writes: Tuple[str, ...] = ()
    causal: Optional[Dict[str, int]] = None
    flops_per_cell: float = 0.0
    work: Dict[str, object] = dataclasses.field(default_factory=dict)
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def full_name(self) -> str:
        return f"{self.name}{self.instance}"


def pointer_class(ptr) -> int:
    """A launch's pointer argument as its dispatch reads it: 0 (null), 16
    (16-byte aligned), 4 (4-byte aligned) or 1."""
    if not ptr:
        return 0
    p = int(ptr)
    return 16 if p % 16 == 0 else 4 if p % 4 == 0 else 1


def specs_from_launch(entry: str, args: tuple,
                      defines: Tuple[str, ...] = ()) -> List[KernelSpec]:
    """The specs of one launch of C entry point ``entry`` whose arguments
    (in the C order, pointers as :func:`pointer_class`, the stream
    dropped) are ``args``; ``defines`` are the build's ``-D`` flags (a
    tuned variant's)."""
    from apex_tpu_torch.ops import attention, layer_norm, paged_attention

    for mod in (layer_norm, attention, paged_attention):
        if entry in mod.SPEC_ENTRIES:
            return mod.specs_from_args(entry, tuple(args), defines)
    raise KeyError(f"no launch plan for kernel entry {entry!r}")

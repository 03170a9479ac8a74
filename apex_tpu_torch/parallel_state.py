"""Process groups and the axis registry — the model-parallel state.

Counterpart of ``apex_tpu/parallel_state.py`` (≙ apex's
``parallel_state``): :func:`initialize_model_parallel` carves the
default ``torch.distributed`` process group into one group per rank set
of each axis, and the ``get_*`` helpers answer the world size, rank and
group of each axis.

Axis layout
-----------
The axes are ``(dp, pp, cp, tp)`` with ``tp`` fastest, the reference's
mesh order: global rank ``r`` sits at

    r = ((dp_rank * pp + pp_rank) * cp + cp_rank) * tp + tp_rank

which is where device ``r`` of the JAX mesh sits, so a rank of the port
and the device of the same index hold the same shard (the CPU parity
tests rely on it).  Sequence parallelism runs on the ``tp`` group, as in
the reference.  An axis of size 1 gets no group: every collective over
it is the identity and issues nothing.

Before :func:`initialize_model_parallel` (or after
:func:`destroy_model_parallel`) every axis has size 1 and rank 0, so a
model built without it is the dense single-process model.

The JAX mesh helpers and what they became here:

- ``get_mesh()`` returns a :class:`ProcessMesh`: the axis sizes, this
  rank's coordinates and the axis groups;
- ``named_sharding(*spec)`` -> :func:`get_group` (the process group of
  an axis) with :func:`axis_rank` / :func:`axis_size`;
- ``data_parallel_sharding(ndim)`` -> :func:`data_parallel_shard`, this
  rank's slice of a global batch along one dimension;
- ``replicated_sharding()`` has nothing to become: every process holds
  its own full copy of a replicated tensor.

Ranks are host integers here (each process has one), where the
reference returns traced indices valid only inside ``shard_map``.
"""

from __future__ import annotations

import dataclasses
import warnings
import weakref
from typing import Dict, Optional

import torch

__all__ = [
    "DATA_PARALLEL_AXIS",
    "PIPELINE_PARALLEL_AXIS",
    "CONTEXT_PARALLEL_AXIS",
    "TENSOR_PARALLEL_AXIS",
    "EXPERT_PARALLEL_AXIS",
    "ProcessMesh",
    "get_expert_model_parallel_world_size",
    "get_expert_model_parallel_rank",
    "initialize_model_parallel",
    "model_parallel_is_initialized",
    "get_mesh",
    "get_group",
    "axis_rank",
    "axis_size",
    "group_axis",
    "get_data_parallel_world_size",
    "get_context_parallel_world_size",
    "get_context_parallel_rank",
    "get_tensor_model_parallel_world_size",
    "get_pipeline_model_parallel_world_size",
    "get_data_parallel_rank",
    "get_tensor_model_parallel_rank",
    "get_pipeline_model_parallel_rank",
    "get_tensor_model_parallel_group",
    "get_data_parallel_group",
    "get_pipeline_model_parallel_group",
    "get_context_parallel_group",
    "get_tensor_model_parallel_src_rank",
    "get_pipeline_model_parallel_next_rank",
    "get_pipeline_model_parallel_prev_rank",
    "is_pipeline_first_stage",
    "is_pipeline_last_stage",
    "get_virtual_pipeline_model_parallel_rank",
    "set_virtual_pipeline_model_parallel_rank",
    "get_virtual_pipeline_model_parallel_world_size",
    "set_virtual_pipeline_model_parallel_world_size",
    "destroy_model_parallel",
    "register_sequence_parallel_param",
    "sequence_parallel_params",
    "sequence_parallel_param_paths",
    "clear_sequence_parallel_params",
    "divide",
    "bound_axis_size",
    "axis_is_bound",
    "data_parallel_shard",
]

DATA_PARALLEL_AXIS = "dp"
PIPELINE_PARALLEL_AXIS = "pp"
CONTEXT_PARALLEL_AXIS = "cp"
TENSOR_PARALLEL_AXIS = "tp"
# experts shard over the dp ranks (Megatron's convention; no extra axis)
EXPERT_PARALLEL_AXIS = DATA_PARALLEL_AXIS

_AXIS_ORDER = (
    DATA_PARALLEL_AXIS,
    PIPELINE_PARALLEL_AXIS,
    CONTEXT_PARALLEL_AXIS,
    TENSOR_PARALLEL_AXIS,
)


@dataclasses.dataclass
class ProcessMesh:
    """The ``(dp, pp, cp, tp)`` rank grid of this process group: the
    axis sizes, this rank's coordinate on each axis, the global ranks of
    each of this rank's axis groups, and the groups (None for an axis of
    size 1)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    ranks: Dict[str, tuple]
    groups: Dict[str, object]


@dataclasses.dataclass
class _ParallelState:
    mesh: ProcessMesh
    virtual_pipeline_model_parallel_size: Optional[int] = None
    virtual_pipeline_model_parallel_rank: Optional[int] = None
    # sequence-parallel parameters of this epoch, by id (see below)
    sequence_parallel_params: weakref.WeakValueDictionary = dataclasses.field(
        default_factory=weakref.WeakValueDictionary)


_STATE: Optional[_ParallelState] = None


def _coords(rank: int, sizes) -> Dict[str, int]:
    out = {}
    for axis in reversed(_AXIS_ORDER):
        out[axis] = rank % sizes[axis]
        rank //= sizes[axis]
    return out


def _rank_of(coords: Dict[str, int], sizes) -> int:
    r = 0
    for axis in _AXIS_ORDER:
        r = r * sizes[axis] + coords[axis]
    return r


def initialize_model_parallel(
    tensor_model_parallel_size: int = 1,
    pipeline_model_parallel_size: int = 1,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    context_parallel_size: int = 1,
    *,
    dcn_data_parallel: bool = False,
    timeout=None,
) -> ProcessMesh:
    """Create and register the ``(dp, pp, cp, tp)`` groups over the
    default process group (one process and no groups when
    ``torch.distributed`` is not initialized).  ``dp`` is the world size
    over ``tp * pp * cp``, which must divide it.  Every rank must call
    this, in the same order as its other group creations.

    ``dcn_data_parallel=True`` asks the reference for a multi-slice
    layout; one process group is one slice, so it warns and is ignored,
    as the reference does on a single slice.  Returns the mesh (also
    :func:`get_mesh`)."""
    global _STATE
    if _STATE is not None:
        raise RuntimeError(
            "model parallel state is already initialized — call "
            "destroy_model_parallel() first"
        )
    dist = torch.distributed
    on = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    tp = int(tensor_model_parallel_size)
    pp = int(pipeline_model_parallel_size)
    cp = int(context_parallel_size)
    if tp < 1 or pp < 1 or cp < 1:
        raise ValueError("parallel sizes must be >= 1")
    if n % (tp * pp * cp) != 0:
        raise RuntimeError(
            f"world size ({n}) is not divisible by tensor_model_parallel_size "
            f"({tp}) x pipeline_model_parallel_size ({pp}) x "
            f"context_parallel_size ({cp})"
        )
    if virtual_pipeline_model_parallel_size is not None and pp < 2:
        raise RuntimeError(
            "pipeline-model-parallel size should be greater than 1 with "
            "interleaved schedule"
        )
    if dcn_data_parallel:
        warnings.warn(
            "dcn_data_parallel: one process group is one slice; using the "
            "single-slice layout",
            RuntimeWarning,
            stacklevel=2,
        )
    sizes = {DATA_PARALLEL_AXIS: n // (tp * pp * cp),
             PIPELINE_PARALLEL_AXIS: pp, CONTEXT_PARALLEL_AXIS: cp,
             TENSOR_PARALLEL_AXIS: tp}
    mine = _coords(rank, sizes)
    ranks, groups = {}, {}
    for axis in _AXIS_ORDER:
        # every rank creates every group of the axis, in one order
        others = [a for a in _AXIS_ORDER if a != axis]
        starts = sorted({_rank_of({**_coords(r, sizes), axis: 0}, sizes)
                         for r in range(n)})
        for start in starts:
            base = _coords(start, sizes)
            members = tuple(_rank_of({**base, axis: i}, sizes)
                            for i in range(sizes[axis]))
            group = None
            if sizes[axis] > 1:
                kw = {} if timeout is None else {"timeout": timeout}
                group = dist.new_group(list(members), **kw)
            if all(base[a] == mine[a] for a in others):
                ranks[axis], groups[axis] = members, group
    mesh = ProcessMesh(shape=sizes, coords=mine, ranks=ranks, groups=groups)
    _STATE = _ParallelState(
        mesh=mesh,
        virtual_pipeline_model_parallel_size=virtual_pipeline_model_parallel_size,
        virtual_pipeline_model_parallel_rank=(
            0 if virtual_pipeline_model_parallel_size is not None else None
        ),
    )
    # a fresh epoch starts with a fresh sequence-parallel registry
    _SEQUENCE_PARALLEL_PARAMS.clear()
    return mesh


def model_parallel_is_initialized() -> bool:
    return _STATE is not None


def _state() -> _ParallelState:
    if _STATE is None:
        raise RuntimeError(
            "model parallel state is not initialized — call "
            "apex_tpu_torch.parallel_state.initialize_model_parallel() first"
        )
    return _STATE


def get_mesh() -> ProcessMesh:
    """The registered rank grid (axes ``dp``, ``pp``, ``cp``, ``tp``)."""
    return _state().mesh


def axis_size(axis: str) -> int:
    """Size of ``axis``; 1 before :func:`initialize_model_parallel`."""
    if axis not in _AXIS_ORDER:
        raise ValueError(f"unknown parallel axis {axis!r}")
    return 1 if _STATE is None else _STATE.mesh.shape[axis]


def axis_rank(axis: str) -> int:
    """This process's coordinate on ``axis``; 0 before initialization."""
    if axis not in _AXIS_ORDER:
        raise ValueError(f"unknown parallel axis {axis!r}")
    return 0 if _STATE is None else _STATE.mesh.coords[axis]


def get_group(axis: str):
    """The process group of this rank's ``axis`` ranks (None when the
    axis has size 1: nothing to communicate)."""
    if axis not in _AXIS_ORDER:
        raise ValueError(f"unknown parallel axis {axis!r}")
    return None if _STATE is None else _STATE.mesh.groups[axis]


def group_axis(group) -> Optional[str]:
    """The axis name of one of this rank's groups (the collective call
    log labels its records with it)."""
    if _STATE is not None and group is not None:
        for axis, g in _STATE.mesh.groups.items():
            if g is group:
                return axis
    return None


def axis_is_bound(axis: str) -> bool:
    """Whether ``axis`` exists here: the state is initialized (whatever
    the axis's size)."""
    return _STATE is not None and axis in _AXIS_ORDER


def bound_axis_size(axis: str) -> int:
    """Size of ``axis`` if the state is initialized, else 1."""
    return axis_size(axis)


# ---------------------------------------------------------------------------
# world sizes, ranks, groups
# ---------------------------------------------------------------------------


def get_data_parallel_world_size() -> int:
    return _state().mesh.shape[DATA_PARALLEL_AXIS]


def get_tensor_model_parallel_world_size() -> int:
    return _state().mesh.shape[TENSOR_PARALLEL_AXIS]


def get_context_parallel_world_size() -> int:
    return _state().mesh.shape[CONTEXT_PARALLEL_AXIS]


def get_pipeline_model_parallel_world_size() -> int:
    return _state().mesh.shape[PIPELINE_PARALLEL_AXIS]


def get_expert_model_parallel_world_size() -> int:
    """Experts shard over the dp ranks; their count is the dp size."""
    return get_data_parallel_world_size()


def get_expert_model_parallel_rank() -> int:
    return get_data_parallel_rank()


def get_data_parallel_rank() -> int:
    return _state().mesh.coords[DATA_PARALLEL_AXIS]


def get_tensor_model_parallel_rank() -> int:
    return _state().mesh.coords[TENSOR_PARALLEL_AXIS]


def get_pipeline_model_parallel_rank() -> int:
    return _state().mesh.coords[PIPELINE_PARALLEL_AXIS]


def get_context_parallel_rank() -> int:
    return _state().mesh.coords[CONTEXT_PARALLEL_AXIS]


def get_tensor_model_parallel_group():
    return _state().mesh.groups[TENSOR_PARALLEL_AXIS]


def get_data_parallel_group():
    return _state().mesh.groups[DATA_PARALLEL_AXIS]


def get_pipeline_model_parallel_group():
    return _state().mesh.groups[PIPELINE_PARALLEL_AXIS]


def get_context_parallel_group():
    return _state().mesh.groups[CONTEXT_PARALLEL_AXIS]


def get_tensor_model_parallel_src_rank() -> int:
    """The global rank of tp rank 0 in this rank's tp group (the source
    of :func:`~apex_tpu_torch.transformer.tensor_parallel.data
    .broadcast_data`)."""
    return _state().mesh.ranks[TENSOR_PARALLEL_AXIS][0]


def get_pipeline_model_parallel_next_rank() -> int:
    pp = get_pipeline_model_parallel_world_size()
    return (get_pipeline_model_parallel_rank() + 1) % pp


def get_pipeline_model_parallel_prev_rank() -> int:
    pp = get_pipeline_model_parallel_world_size()
    return (get_pipeline_model_parallel_rank() - 1) % pp


def is_pipeline_first_stage(ignore_virtual: bool = False) -> bool:
    if not ignore_virtual:
        vpp = get_virtual_pipeline_model_parallel_world_size()
        if vpp is not None and get_virtual_pipeline_model_parallel_rank() != 0:
            return False
    return get_pipeline_model_parallel_rank() == 0


def is_pipeline_last_stage(ignore_virtual: bool = False) -> bool:
    if not ignore_virtual:
        vpp = get_virtual_pipeline_model_parallel_world_size()
        if vpp is not None and (
            get_virtual_pipeline_model_parallel_rank() != vpp - 1
        ):
            return False
    pp = get_pipeline_model_parallel_world_size()
    return get_pipeline_model_parallel_rank() == pp - 1


def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    return _state().virtual_pipeline_model_parallel_rank


def set_virtual_pipeline_model_parallel_rank(rank: int) -> None:
    _state().virtual_pipeline_model_parallel_rank = rank


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _state().virtual_pipeline_model_parallel_size


def set_virtual_pipeline_model_parallel_world_size(size: Optional[int]) -> None:
    st = _state()
    st.virtual_pipeline_model_parallel_size = size
    if size is None:
        st.virtual_pipeline_model_parallel_rank = None
    elif st.virtual_pipeline_model_parallel_rank is None:
        st.virtual_pipeline_model_parallel_rank = 0


def destroy_model_parallel() -> None:
    """Forget the groups (they stay valid in ``torch.distributed`` until
    the process group is destroyed) and the sequence-parallel marks."""
    global _STATE
    _STATE = None
    clear_sequence_parallel_params()


# ---------------------------------------------------------------------------
# sequence-parallel parameters
#
# Under sequence parallelism the parameters used inside the sequence-
# sharded region (the LayerNorms, RowParallelLinear biases, position
# embeddings) are replicated over tp, but each rank's backward covers
# only its S/tp rows: the true gradient is the sum over tp.  Modules
# register those parameters when they are built (Megatron marks
# ``param.sequence_parallel = True``; the reference registers their tree
# paths), and ``allreduce_sequence_parallel_gradients`` sums exactly
# their gradients.  The registry lives on the state of one epoch, so a
# destroy/initialize cycle starts clean; before initialization a module
# registry backs the one-process case and is cleared by both.  It holds
# the parameters weakly: a model that is dropped leaves it.
# ---------------------------------------------------------------------------

_SEQUENCE_PARALLEL_PARAMS = weakref.WeakValueDictionary()


def _sp_registry() -> weakref.WeakValueDictionary:
    if _STATE is not None:
        return _STATE.sequence_parallel_params
    return _SEQUENCE_PARALLEL_PARAMS


def register_sequence_parallel_param(param: torch.Tensor) -> None:
    """Mark ``param`` as having tp-partial gradients under sequence
    parallelism (also sets Megatron's ``param.sequence_parallel``)."""
    param.sequence_parallel = True
    _sp_registry()[id(param)] = param


def sequence_parallel_params() -> list:
    """The registered parameters, in registration order."""
    return list(_sp_registry().values())


def sequence_parallel_param_paths(module: torch.nn.Module) -> frozenset:
    """The names in ``module.named_parameters()`` of the registered
    parameters (the reference's path set, for one module)."""
    marked = _sp_registry()
    return frozenset(name for name, p in module.named_parameters()
                     if id(p) in marked)


def clear_sequence_parallel_params() -> None:
    _sp_registry().clear()


def divide(numerator: int, denominator: int) -> int:
    """≙ apex/transformer/utils.py :: divide (ensure_divisibility)."""
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")
    return numerator // denominator


def data_parallel_shard(tensor: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of a global batch along ``dim``
    (the dp coordinate's ``size / dp`` rows; the whole tensor at dp 1)."""
    dp = axis_size(DATA_PARALLEL_AXIS)
    per = divide(tensor.shape[dim], dp)
    return tensor.narrow(dim, axis_rank(DATA_PARALLEL_AXIS) * per, per)

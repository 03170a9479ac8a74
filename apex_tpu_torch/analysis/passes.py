"""The captured step and the graph passes over it.

Counterpart of ``apex_tpu/analysis/passes.py``.  The reference reads a
jaxpr and the compiled HLO text; PyTorch has no compiler to ask, so the
port records ONE run of the step (:func:`capture`) and its passes read
that record:

- every aten op, in order, under a
  :class:`~torch.utils._python_dispatch.TorchDispatchMode`: its operands
  and results (shape, dtype, device, and the buffer — the storage — each
  lies in), the buffers it writes in place, and the innermost
  :func:`named_scope`;
- every kernel launch through :func:`apex_tpu_torch.ops._dispatch.launch`
  as one opaque node (as a Pallas kernel is one custom-call in HLO): its
  pointer arguments are mapped back to the buffers that hold them, so a
  kernel's reads extend its operands' live ranges, and its scalar
  arguments are kept for :mod:`.kernels`;
- every collective of :mod:`apex_tpu_torch.parallel.comm`, with its kind,
  axis, dtype and bytes.

The record is the run the caller makes anyway: the serving engine records
the warm-up of each prefill bucket and of the decode step before it
captures it (``serve/engine.py``), the trainer the step its ``verify``
runs.  Nothing runs twice.

A pass is a function ``(StepGraph) -> list[Finding]`` registered in
:data:`PASSES`; :class:`StepGraph` carries the record (``ops``) and the
reference's intent fields.  :mod:`.hlo` reads the record in place of HLO
text.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import ctypes
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu_torch.analysis import hlo as hlo_lib
from apex_tpu_torch.analysis.findings import Finding, make_finding

__all__ = [
    "TensorRef",
    "Buffer",
    "OpRecord",
    "StepRecord",
    "StepGraph",
    "PASSES",
    "capture",
    "named_scope",
    "current_scope",
    "iter_ops",
    "transfer_pass",
    "promotion_pass",
    "donation_pass",
    "collective_pass",
    "reshard_pass",
]


# ---------------------------------------------------------------------------
# scopes
# ---------------------------------------------------------------------------

_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "apex_tpu_torch_analysis_scope", default=())


@contextlib.contextmanager
def named_scope(name: str):
    """``jax.named_scope``'s counterpart: a
    :func:`torch.profiler.record_function` range that the recorder also
    reads, so every op inside carries the scope path (``a/b/c``).  A scope
    whose name holds ``f32``, ``fp32``, ``master`` or ``highp`` marks a
    widening inside it as intended (:func:`promotion_pass`)."""
    token = _SCOPE.set(_SCOPE.get() + (str(name),))
    try:
        with torch.profiler.record_function(str(name)):
            yield
    finally:
        _SCOPE.reset(token)


def current_scope() -> str:
    return "/".join(_SCOPE.get())


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------

#: what the caching allocator rounds every block to
ALLOC_ROUND = 512


@dataclasses.dataclass(frozen=True)
class TensorRef:
    """One operand or result of a recorded op."""

    buf: int
    shape: Tuple[int, ...]
    dtype: str      # torch dtype name without the prefix: "bfloat16"
    device: str     # "cuda" | "cpu"


@dataclasses.dataclass
class Buffer:
    """One storage the step reads or writes.  ``defined`` is the index of
    the op that allocated it, -1 for an argument (live from entry)."""

    id: int
    nbytes: int
    dtype: str
    device: str
    defined: int
    name: str = ""          # an argument's path ("kv_cache/k")
    producer: str = ""      # the allocating op's name


@dataclasses.dataclass
class OpRecord:
    """One node of the record.  ``kind`` is "aten", "kernel" or
    "collective"; a kernel's ``ins`` are every buffer its pointers reach
    (read or written: the launch does not say which)."""

    index: int
    name: str
    kind: str
    scope: str
    ins: Tuple[TensorRef, ...]
    outs: Tuple[TensorRef, ...]
    writes: Tuple[int, ...] = ()          # buffers written in place
    fresh: Tuple[int, ...] = ()           # buffers this op allocated
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StepRecord:
    """One recorded run of a step: ``ops`` in program order, every
    ``buffers`` by id, the argument leaves by path (``arguments``), and
    the buffers of the step's result (``outputs``)."""

    ops: List[OpRecord]
    buffers: Dict[int, Buffer]
    arguments: Dict[str, int]
    outputs: Tuple[int, ...]
    device: str
    #: the recorded run's host time (the recorder's cost included)
    run_ms: float = 0.0

    def argument_buffers(self) -> List[Buffer]:
        return [b for b in self.buffers.values() if b.defined < 0]


_DTYPE_NAMES: Dict[torch.dtype, str] = {}


def _dtype_name(dtype) -> str:
    name = _DTYPE_NAMES.get(dtype)
    if name is None:
        name = _DTYPE_NAMES[dtype] = str(dtype).replace("torch.", "")
    return name


def _leaves(tree) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _op_tensors(obj, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of an aten op's arguments or results (tensors, and
    lists, tuples and dicts of them): the recorder's hot path, cheaper
    than a pytree walk."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple, dict)):
                _op_tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _op_tensors(x, out)
    return out


def _paths(tree, prefix: str) -> List[Tuple[str, torch.Tensor]]:
    """``[(path, tensor)]`` of a tree of dicts, lists and tuples."""
    out: List[Tuple[str, torch.Tensor]] = []
    if isinstance(tree, torch.Tensor):
        out.append((prefix, tree))
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            out.extend(_paths(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.extend(_paths(v, f"{prefix}/{i}" if prefix else str(i)))
    elif hasattr(tree, "_asdict"):
        out.extend(_paths(tree._asdict(), prefix))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out.extend(_paths({f.name: getattr(tree, f.name)
                           for f in dataclasses.fields(tree)}, prefix))
    return out


_WRITTEN: Dict[Any, Tuple[Tuple[int, str], ...]] = {}


def _written_args(func) -> Tuple[Tuple[int, str], ...]:
    """``(position, name)`` of the arguments an aten op writes in place
    (its schema's mutable aliases), cached per op."""
    got = _WRITTEN.get(func)
    if got is None:
        schema = getattr(func, "_schema", None)
        got = tuple(
            (i, a.name) for i, a in enumerate(
                schema.arguments if schema is not None else ())
            if a.alias_info is not None and a.alias_info.is_write)
        _WRITTEN[func] = got
    return got


class _Recorder(TorchDispatchMode):
    """The dispatch mode behind :func:`capture`."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.buffers: Dict[int, Buffer] = {}
        self.arguments: Dict[str, int] = {}
        # storage base address -> buffer id of the live storage there
        self._by_base: Dict[int, int] = {}
        # sorted storage bases and their extents, for pointers that land
        # inside a storage (a kernel handed a view's data_ptr)
        self._bases: List[int] = []
        self._next = 0

    # -- buffers -------------------------------------------------------
    def _new(self, base: int, nbytes: int, t: torch.Tensor, defined: int,
             name: str = "", producer: str = "") -> int:
        bid = self._next
        self._next += 1
        self.buffers[bid] = Buffer(bid, nbytes, _dtype_name(t.dtype),
                                   t.device.type, defined, name, producer)
        if base not in self._by_base:
            bisect.insort(self._bases, base)
        self._by_base[base] = bid
        return bid

    def register(self, path: str, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        base = st.data_ptr()
        if not base or base in self._by_base:
            return
        self.arguments[path] = self._new(base, st.nbytes(), t, -1, path)

    def _buf(self, t: torch.Tensor) -> Optional[int]:
        """The buffer of an operand; an unseen storage is an argument the
        caller did not name (a constant table, say)."""
        st = t.untyped_storage()
        base = st.data_ptr()
        if not base:
            return None
        bid = self._by_base.get(base)
        if bid is None:
            bid = self._new(base, st.nbytes(), t, -1, "", "external")
        return bid

    def _ref(self, t: torch.Tensor, bid: int) -> TensorRef:
        return TensorRef(bid, tuple(t.shape), _dtype_name(t.dtype),
                         t.device.type)

    def buffer_at(self, ptr: int) -> Optional[int]:
        """The buffer whose storage holds address ``ptr``."""
        bid = self._by_base.get(ptr)
        if bid is not None:
            return bid
        i = bisect.bisect_right(self._bases, ptr) - 1
        while i >= 0:
            base = self._bases[i]
            b = self._by_base.get(base)
            if b is not None and ptr < base + max(self.buffers[b].nbytes, 1):
                return b
            if ptr - base > (1 << 40):
                break
            i -= 1
        return None

    # -- aten ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._note_aten(func, args, kwargs, out)
        return out

    def _note_aten(self, func, args, kwargs, out) -> None:
        index = len(self.ops)
        ins: List[TensorRef] = []
        in_bases: Dict[int, int] = {}
        for t in _op_tensors(kwargs, _op_tensors(args, [])):
            st = t.untyped_storage()
            base = st.data_ptr()
            if not base:
                continue
            bid = self._by_base.get(base)
            if bid is None:
                bid = self._new(base, st.nbytes(), t, -1, "", "external")
            ins.append(self._ref(t, bid))
            in_bases[base] = bid
        writes = []
        for pos, name in _written_args(func):
            v = args[pos] if pos < len(args) else kwargs.get(name)
            if isinstance(v, torch.Tensor):
                bid = self._buf(v)
                if bid is not None:
                    writes.append(bid)
        outs: List[TensorRef] = []
        fresh = []
        for t in _op_tensors(out, []):
            st = t.untyped_storage()
            base = st.data_ptr()
            if not base:
                continue
            if base in in_bases:       # a view, an in-place result
                bid = in_bases[base]
            else:
                bid = self._new(base, st.nbytes(), t, index,
                                producer=str(func))
                fresh.append(bid)
            outs.append(self._ref(t, bid))
        self.ops.append(OpRecord(index, str(func), "aten", current_scope(),
                                 tuple(ins), tuple(outs), tuple(writes),
                                 tuple(fresh)))

    # -- kernels and collectives ---------------------------------------
    def note_launch(self, kernel: str, argtypes, args, dtype) -> None:
        ins: List[TensorRef] = []
        scalars = []
        for ty, v in zip(argtypes, args):
            if ty is ctypes.c_void_p:
                if v is None:
                    continue
                bid = self.buffer_at(int(v))
                if bid is not None:
                    b = self.buffers[bid]
                    ins.append(TensorRef(bid, (b.nbytes //
                                               max(hlo_lib.DTYPE_BYTES.get(
                                                   b.dtype, 1), 1),),
                                         b.dtype, b.device))
            else:
                scalars.append(v.value if hasattr(v, "value") else v)
        self.ops.append(OpRecord(
            len(self.ops), kernel, "kernel", current_scope(), tuple(ins),
            (), meta={"scalars": tuple(scalars),
                      "dtype": _dtype_name(dtype) if dtype else None}))

    def note_collective(self, entry: dict) -> None:
        self.ops.append(OpRecord(len(self.ops), entry["kind"], "collective",
                                 current_scope(), (), (), meta=dict(entry)))


class _CollectiveTap:
    """Stands in :mod:`~apex_tpu_torch.parallel.comm`'s call logs: each
    collective the step issues becomes a node of the record."""

    def __init__(self, rec: _Recorder):
        self._rec = rec

    def append(self, entry: dict) -> None:
        self._rec.note_collective(entry)


def capture(fn: Callable, *args, named: Optional[dict] = None,
            **kwargs) -> Tuple[Any, StepRecord]:
    """Run ``fn(*args, **kwargs)`` once under the recorder; returns its
    result and the :class:`StepRecord`.  ``named`` maps a path prefix to a
    tree of tensors that the step reads from outside its arguments (the
    weights and the KV pool of a serving step): they are arguments, live
    from entry, under those paths.  ``args`` are named by position
    (``arg0/...``)."""
    rec = _Recorder()
    for prefix, tree in (named or {}).items():
        for path, t in _paths(tree, prefix):
            rec.register(path, t)
    for i, a in enumerate(args):
        for path, t in _paths(a, f"arg{i}"):
            rec.register(path, t)
    for k, a in kwargs.items():
        for path, t in _paths(a, k):
            rec.register(path, t)
    devices = {t.device.type for t in _leaves((args, kwargs, named))}
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.parallel import comm

    log = _CollectiveTap(rec)
    _dispatch.RECORDERS.append(rec)
    comm._LOGS.append(log)
    t0 = time.perf_counter()
    try:
        with rec:
            result = fn(*args, **kwargs)
    finally:
        _dispatch.RECORDERS.remove(rec)
        comm._LOGS.remove(log)
    run_ms = (time.perf_counter() - t0) * 1e3
    outputs = []
    for t in _leaves(result):
        base = t.untyped_storage().data_ptr()
        bid = rec._by_base.get(base)
        if bid is not None:
            outputs.append(bid)
    device = "cuda" if "cuda" in devices else "cpu"
    return result, StepRecord(rec.ops, rec.buffers, rec.arguments,
                              tuple(outputs), device, run_ms)


def iter_ops(record: StepRecord):
    """Every op of the record in program order (``iter_eqns``'
    counterpart: the record is flat, a kernel one node)."""
    return iter(record.ops)


# ---------------------------------------------------------------------------
# the step graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepGraph:
    """Everything a pass may inspect about one step.  ``ops`` (the
    :class:`StepRecord`) may be None (a source-only lint); passes skip
    when their substrate is absent.  The other fields carry the intent —
    what the step should look like — as in the reference."""

    ops: Optional[StepRecord] = None
    policy: Optional[Any] = None          # amp policy or a dtype
    donated: Optional[int] = None         # expected donated leaf count
    donated_argnums: tuple = ()
    #: the argument paths declared donated (in place): "kv_cache/...";
    #: the donation pass checks these when given, else ``donated_argnums``
    donated_paths: Tuple[str, ...] = ()
    expect_collectives: Optional[dict] = None
    #: the per-axis collective plan (``train.trainer.check_plan``'s)
    expect_plan: Optional[dict] = None
    hbm_budget: Optional[int] = None
    sources: Optional[list] = None


# ---------------------------------------------------------------------------
# transfer lint
# ---------------------------------------------------------------------------


def transfer_pass(graph: StepGraph) -> List[Finding]:
    """No host round trip inside the step: a device value read on the
    host (``.item()``, a data-dependent shape), a copy from the card to
    the host (:func:`.hlo.host_transfer_ops`)."""
    if graph.ops is None:
        return []
    out = []
    for where, why, rule in hlo_lib.host_transfer_ops(graph.ops):
        out.append(make_finding(rule, path=where, message=(
            f"host transfer inside the step: {why}")))
    return out


# ---------------------------------------------------------------------------
# promotion lint
# ---------------------------------------------------------------------------

_WIDE_FLOATS = {"float64", "complex128"}

#: a scope holding one of these marks a widening inside it as intended
_ALLOW_SCOPE_TOKENS = ("f32", "fp32", "master", "highp")

_FLOAT_ORDER = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}

#: a widened value read only by these is the accumulate-wide reduction
#: idiom (PyTorch's own reductions of bf16 accumulate in f32)
_REDUCTION_OPS = frozenset((
    "sum", "mean", "prod", "amax", "amin", "max", "min", "argmax", "argmin",
    "cumsum", "cumprod", "logsumexp", "norm", "linalg_vector_norm", "var",
    "std", "var_mean", "std_mean", "_softmax", "_log_softmax", "all", "any",
))


#: the ops that only convert: a cast read only by reductions is exempt
_CASTS = frozenset(("_to_copy", "to", "_to_dtype"))


def _compute_dtype(policy) -> Optional[str]:
    if policy is None:
        return None
    dt = getattr(policy, "compute_dtype", policy)
    if isinstance(dt, torch.dtype):
        return _dtype_name(dt)
    if isinstance(dt, str):
        return {"bf16": "bfloat16", "fp16": "float16", "f16": "float16",
                "f32": "float32"}.get(dt, dt)
    return None


def _op_base(name: str) -> str:
    """``aten.sum.dim_IntList`` -> ``sum``; ``aten.add_.Tensor`` -> ``add_``."""
    parts = name.split(".")
    return parts[1] if len(parts) > 1 else name


def _scope_allows(scope: str) -> bool:
    s = scope.lower()
    return any(tok in s for tok in _ALLOW_SCOPE_TOKENS)


def promotion_pass(graph: StepGraph) -> List[Finding]:
    """No silent dtype widening.

    - ``promotion-f64`` (always): any op producing f64 or c128.
    - ``promotion-widen`` (with a half-precision ``policy``): an op that
      reads a value of the compute dtype and produces a wider float,
      outside a scope that declares the widening intended.  An op that is
      itself a reduction, or a cast whose widened result only reductions
      read (and that the step does not return), is exempt: the
      accumulate-wide idiom the policy wants.

    Findings deduplicate per (rule, op, scope), with a count."""
    if graph.ops is None:
        return []
    rec = graph.ops
    compute = _compute_dtype(graph.policy)
    check_widen = compute is not None and _FLOAT_ORDER.get(compute, 4) < 4
    readers: Dict[int, set] = {}
    for op in rec.ops:
        for r in op.ins:
            readers.setdefault(r.buf, set()).add(_op_base(op.name))
    escaping = set(rec.outputs)
    sites: Dict[tuple, list] = {}
    for op in rec.ops:
        if op.kind != "aten":
            continue
        where = f"{op.scope or '<step>'}: {op.name} (op #{op.index})"
        key_where = f"{op.scope or '<step>'}: {op.name}"
        if any(o.dtype in _WIDE_FLOATS for o in op.outs):
            dt = next(o.dtype for o in op.outs if o.dtype in _WIDE_FLOATS)
            site = sites.setdefault(("promotion-f64", key_where),
                                    [f"'{op.name}' produces {dt}", 0, where])
            site[1] += 1
        if not check_widen or _scope_allows(op.scope):
            continue
        if not any(r.dtype == compute for r in op.ins):
            continue
        wide = [o for o in op.outs if _FLOAT_ORDER.get(o.dtype, 0) >
                _FLOAT_ORDER[compute] and o.dtype not in _WIDE_FLOATS]
        if not wide:
            continue
        base = _op_base(op.name)
        if base in _REDUCTION_OPS:
            continue
        if base in _CASTS:
            used_by = set()
            for o in wide:
                used_by |= readers.get(o.buf, set())
            if used_by and used_by <= _REDUCTION_OPS and \
                    not any(o.buf in escaping for o in wide):
                continue
        site = sites.setdefault(("promotion-widen", key_where), [
            f"{compute} -> {wide[0].dtype} past compute dtype {compute}",
            0, where])
        site[1] += 1
    out = []
    for (rule, _), (msg, count, where) in sites.items():
        if count > 1:
            msg += f" ({count} values at this site)"
        out.append(make_finding(rule, path=where, message=msg))
    return out


# ---------------------------------------------------------------------------
# donation lint
# ---------------------------------------------------------------------------


def _donated_paths(graph: StepGraph) -> List[str]:
    rec = graph.ops
    if graph.donated_paths:
        return [p for p in rec.arguments
                if any(p == d or p.startswith(d + "/")
                       for d in graph.donated_paths)]
    return [p for p in rec.arguments
            if any(p == f"arg{i}" or p.startswith(f"arg{i}/")
                   for i in graph.donated_argnums)]


def donation_pass(graph: StepGraph) -> List[Finding]:
    """Every donated (in-place) argument must come back in its own
    storage: written in place, or returned as a view of itself
    (:func:`.hlo.input_output_aliases`).  A donated buffer the step
    copies instead leaves two live copies (the 2x a dropped donation
    costs)."""
    if graph.ops is None or (graph.donated is None and
                             not graph.donated_paths):
        return []
    paths = _donated_paths(graph)
    want = graph.donated if graph.donated is not None else len(paths)
    aliased = {p for p, _ in hlo_lib.input_output_aliases(graph.ops)}
    dropped = [p for p in paths if p not in aliased]
    n_dropped = max(len(dropped), want - (len(paths) - len(dropped)))
    if n_dropped <= 0:
        return []
    detail = f" — not in place: {', '.join(dropped[:4])}" if dropped else ""
    argnums = (f" (donate_argnums={tuple(graph.donated_argnums)})"
               if graph.donated_argnums else "")
    return [make_finding(
        "donation-dropped", path="input_output_alias",
        message=(f"{n_dropped} of {want} donated buffers were NOT updated in "
                 f"place{argnums}; each holds a duplicate allocation"
                 f"{detail}"))]


# ---------------------------------------------------------------------------
# collective consistency
# ---------------------------------------------------------------------------


def _normalize_expectation(spec) -> dict:
    if isinstance(spec, int):
        return {"count": spec}
    return dict(spec)


def collective_pass(graph: StepGraph) -> List[Finding]:
    """The recorded collectives match the comm engine's promise: per-kind
    count, payload bytes (exact or ``[lo, hi]``) and the allowed payload
    dtypes (``"s8"``, ``"f32"``, ...), as the reference's schema."""
    if graph.ops is None or not graph.expect_collectives:
        return []
    summary = hlo_lib.collective_summary(graph.ops)
    dtypes = hlo_lib.collective_dtypes(graph.ops)
    out: List[Finding] = []
    for kind, raw in graph.expect_collectives.items():
        spec = _normalize_expectation(raw)
        actual = summary.get(kind, {"count": 0, "bytes": 0})
        if "count" in spec and actual["count"] != spec["count"]:
            out.append(make_finding("collective-count", path=kind, message=(
                f"expected {spec['count']} '{kind}' collective(s), the "
                f"step issued {actual['count']}")))
        if "bytes" in spec:
            want = spec["bytes"]
            lo, hi = (want, want) if isinstance(want, int) else want
            if not lo <= actual["bytes"] <= hi:
                out.append(make_finding("collective-bytes", path=kind,
                                        message=(
                    f"'{kind}' moves {actual['bytes']} bytes, expected "
                    f"within [{lo}, {hi}]")))
        if "dtypes" in spec:
            allowed = set(spec["dtypes"])
            extra = dtypes.get(kind, set()) - allowed
            if extra:
                out.append(make_finding("collective-dtype", path=kind,
                                        message=(
                    f"'{kind}' payload carries {sorted(extra)} beyond the "
                    f"wire's allowed {sorted(allowed)}")))
    return out


def reshard_pass(graph: StepGraph) -> List[Finding]:
    """The recorded collectives against the declared per-axis plan
    (``expect_plan``): the trainer's ``check_plan``, rule
    ``reshard-plan``."""
    if graph.ops is None or not graph.expect_plan:
        return []
    from apex_tpu_torch.train.trainer import check_plan

    return check_plan([op.meta for op in graph.ops.ops
                       if op.kind == "collective"], graph.expect_plan)


from apex_tpu_torch.analysis.concurrency import concurrency_pass  # noqa: E402
from apex_tpu_torch.analysis.memory import memory_pass  # noqa: E402
from apex_tpu_torch.analysis.purity import purity_pass  # noqa: E402

#: pass name -> implementation; ``rules=`` selects by these names.  The
#: reference's sharding pass reads GSPMD's compiled shardings, which have
#: no counterpart on one card: the trainer checks its shards itself
#: (``train/trainer.py`` ``check_shapes``).
PASSES: Dict[str, Callable[[StepGraph], List[Finding]]] = {
    "transfer": transfer_pass,
    "promotion": promotion_pass,
    "donation": donation_pass,
    "collective": collective_pass,
    "reshard": reshard_pass,
    "memory": memory_pass,
    "concurrency": concurrency_pass,
    "purity": purity_pass,
}

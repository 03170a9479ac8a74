"""The reader of a captured step — what the reference reads from HLO text.

Counterpart of ``apex_tpu/analysis/hlo.py``.  The reference parses the
text of a compiled XLA module; the port has no compiler to ask, so every
function here reads a :class:`~apex_tpu_torch.analysis.passes.StepRecord`
instead — one recorded run of the step, every aten op, kernel launch and
collective in order (:func:`apex_tpu_torch.analysis.passes.capture`).  The
names are the reference's where they still mean something:

- :func:`shape_bytes` — bytes of a ``(shape, dtype)`` pair;
- :func:`host_transfer_ops` — a device value read on the host
  (``aten._local_scalar_dense``, ``.item()``), an op whose result shape
  depends on the data (``nonzero``-style syncs), a copy from the card to
  the host;
- :func:`input_output_aliases` — the argument leaves the step updated in
  its own storage (written in place, or returned as a view of itself):
  the donation lint's ground truth;
- :func:`collective_summary` / :func:`collective_dtypes` — per-kind
  counts, bytes and wire dtypes of the collectives the step issued
  (:mod:`apex_tpu_torch.parallel.comm`'s call log);
- :func:`parse_computations` / :func:`instruction_flops` /
  :func:`instruction_bytes` — every op as the reference's instruction
  record, and its operation and byte estimate, for step-time attribution.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = [
    "DTYPE_BYTES",
    "shape_bytes",
    "shape_dims",
    "shape_elements",
    "host_transfer_ops",
    "input_output_aliases",
    "collective_summary",
    "collective_dtypes",
    "parse_computations",
    "instruction_flops",
    "instruction_bytes",
]

#: element bytes by torch dtype name
DTYPE_BYTES = {
    "float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
    "complex64": 8, "complex128": 16, "int64": 8, "int32": 4, "int16": 2,
    "int8": 1, "uint8": 1, "uint16": 2, "uint32": 4, "uint64": 8,
    "bool": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
}

def shape_dims(shape) -> List[int]:
    """Dims of a ``(shape, dtype)`` pair."""
    return [int(d) for d in shape[0]]


def shape_elements(shape) -> int:
    n = 1
    for d in shape_dims(shape):
        n *= d
    return n


def shape_bytes(shape) -> int:
    """Bytes of a ``(shape, dtype)`` pair (the reference's reads an HLO
    shape string)."""
    return shape_elements(shape) * DTYPE_BYTES.get(
        str(shape[1]).replace("torch.", ""), 4)


# ---------------------------------------------------------------------------
# host transfers
# ---------------------------------------------------------------------------

#: ops that read a device value on the host
_SCALAR_READS = ("_local_scalar_dense", "item")
#: ops whose result shape depends on the data: the host waits for it
_DATA_SHAPED = ("nonzero", "nonzero_static", "masked_select", "_unique",
                "_unique2", "unique_dim", "unique_consecutive",
                "repeat_interleave")


def _base(name: str) -> str:
    parts = name.split(".")
    return parts[1] if len(parts) > 1 else name


def host_transfer_ops(record) -> List[Tuple[str, str, str]]:
    """``[(where, why, rule), ...]`` for every op of the record that moves
    data between the host and the card inside the step.  ``rule`` is the
    reference's: ``transfer-hlo-host`` for a transfer in the program."""
    out = []
    for op in record.ops:
        if op.kind != "aten":
            continue
        base = _base(op.name)
        where = f"{op.scope or '<step>'}: {op.name} (op #{op.index})"
        if base in _SCALAR_READS:
            out.append((where, "a device value read on the host (.item())",
                        "transfer-hlo-host"))
        elif base in _DATA_SHAPED:
            out.append((where, f"'{base}' has a data-dependent shape (the "
                        "host waits for the device)", "transfer-hlo-host"))
        elif "cuda" in {r.device for r in op.ins} and \
                "cpu" in {r.device for r in op.outs}:
            # a readback: the host waits for the card (an upload of a
            # host value is queued like a launch, as the reference's
            # constants are baked into the program)
            out.append((where, "copy cuda -> cpu (a readback)",
                        "transfer-hlo-host"))
    return out


# ---------------------------------------------------------------------------
# aliasing (the donation lint's ground truth)
# ---------------------------------------------------------------------------


def input_output_aliases(record) -> List[Tuple[str, str]]:
    """``[(argument path, "in-place" | "returned"), ...]``: the argument
    leaves the step updated in their own storage.  A donated leaf absent
    here was not updated in place — the step copied it instead."""
    written = set()
    for op in record.ops:
        written.update(op.writes)
    returned = set(record.outputs)
    out = []
    for path, bid in record.arguments.items():
        if bid in written:
            out.append((path, "in-place"))
        elif bid in returned:
            out.append((path, "returned"))
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def collective_summary(record) -> dict:
    """Per-kind ``{count, bytes}`` of every collective the step issued."""
    out: Dict[str, dict] = {}
    for op in record.ops:
        if op.kind != "collective":
            continue
        s = out.setdefault(op.name, {"count": 0, "bytes": 0})
        s["count"] += 1
        s["bytes"] += int(op.meta.get("bytes", 0))
    return out


def collective_dtypes(record) -> Dict[str, set]:
    """Per-kind set of the wire dtypes (``"bf16"``, ``"s8"``, ...)."""
    out: Dict[str, set] = {}
    for op in record.ops:
        if op.kind == "collective":
            out.setdefault(op.name, set()).add(op.meta.get("dtype"))
    return out


# ---------------------------------------------------------------------------
# the per-op reader and its cost primitives
# ---------------------------------------------------------------------------

#: one operation per result element
_ELEMENTWISE = frozenset((
    "add", "sub", "mul", "div", "maximum", "minimum", "pow", "remainder",
    "neg", "abs", "sign", "eq", "ne", "lt", "le", "gt", "ge", "where",
    "clamp", "exp", "log", "tanh", "sigmoid", "sqrt", "rsqrt", "sin", "cos",
    "erf", "gelu", "silu", "relu", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "logical_and", "logical_or", "logical_not",
    "floor", "ceil", "round", "reciprocal", "isfinite", "isnan", "isinf",
    "lerp", "addcmul", "addcdiv", "_to_copy", "fill", "masked_fill",
))

#: data movement: no operations, bytes still count
_ZERO_OPS = frozenset((
    "empty", "empty_strided", "zeros", "ones", "full", "view", "_unsafe_view",
    "reshape", "expand", "permute", "transpose", "t", "slice", "select",
    "unsqueeze", "squeeze", "as_strided", "clone", "copy", "copy_", "cat",
    "stack", "index", "index_select", "gather", "scatter", "index_put",
    "index_put_", "arange", "detach", "alias", "split", "split_with_sizes",
    "narrow", "contiguous", "lift_fresh", "_local_scalar_dense", "embedding",
))

#: the reference's categories for a record's node kinds
_OPCODES = {"kernel": "custom-call"}


def parse_computations(record):
    """``(computations, entry_name)`` in the reference's shape: one
    computation, ``"entry"``, whose instruction dicts carry ``name``
    (``%<index>``), ``shape`` (result shapes as ``(shape, dtype)``
    pairs), ``opcode`` (the aten op's name, ``custom-call`` for a kernel,
    the collective's kind), ``operands`` (operand shapes),
    ``operand_names``, ``op_name`` (the scope path, then the op),
    ``called`` (empty: the record is flat), ``attrs`` (the op's metadata)
    and ``root`` (a result of the step)."""
    outputs = set(record.outputs)
    producer: Dict[int, int] = {}
    instrs = []
    for op in record.ops:
        opcode = op.name if op.kind != "kernel" else "custom-call"
        instrs.append({
            "name": f"%{op.index}",
            "shape": [(r.shape, r.dtype) for r in op.outs],
            "opcode": opcode,
            "target": op.name,
            "kind": op.kind,
            "operands": [(r.shape, r.dtype) for r in op.ins],
            "operand_names": [f"%{producer[r.buf]}" for r in op.ins
                              if r.buf in producer],
            "op_name": f"{op.scope}/{op.name}" if op.scope else op.name,
            "called": [],
            "attrs": dict(op.meta),
            "root": any(r.buf in outputs for r in op.outs),
        })
        for b in op.fresh:
            producer[b] = op.index
    return {"entry": instrs}, "entry"


def instruction_flops(instr: dict) -> float:
    """Operations of ONE record instruction from its shapes: ``mm``/
    ``bmm``/``addmm``/``linear``/``matmul`` count 2·M·N·K, elementwise ops
    one per result element, reductions one per input element; data
    movement, kernels (opaque: :mod:`.kernels` costs them) and
    collectives 0."""
    if instr.get("kind") in ("kernel", "collective"):
        return 0.0
    base = _base(instr["opcode"]).rstrip("_")
    outs = instr["shape"]
    if base in _ZERO_OPS or not outs:
        return 0.0
    res = shape_elements(outs[0])
    ops = instr["operands"]
    if base in ("mm", "bmm", "addmm", "baddbmm", "matmul", "linear",
                "addbmm") and ops:
        a = ops[1] if base in ("addmm", "baddbmm", "addbmm") else ops[0]
        dims = shape_dims(a)
        k = dims[-1] if dims else 1
        return 2.0 * res * k
    if base in ("sum", "mean", "amax", "amin", "max", "min", "argmax",
                "argmin", "prod", "norm", "linalg_vector_norm", "var",
                "std", "logsumexp", "_softmax", "_log_softmax", "cumsum"):
        return float(shape_elements(ops[0])) if ops else float(res)
    if base in _ELEMENTWISE:
        return float(res)
    return float(res)


def instruction_bytes(instr: dict) -> int:
    """Bytes one instruction moves: its results and operands as recorded
    (a view moves nothing)."""
    base = _base(instr["opcode"])
    if base in ("view", "_unsafe_view", "expand", "permute", "transpose",
                "t", "slice", "select", "unsqueeze", "squeeze", "as_strided",
                "detach", "alias", "split", "split_with_sizes", "narrow",
                "lift_fresh", "empty", "empty_strided"):
        return 0
    total = sum(shape_bytes(s) for s in instr["shape"])
    total += sum(shape_bytes(s) for s in instr["operands"])
    return total

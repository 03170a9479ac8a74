"""The gradient-sync engine: wire format x chunking x the call log.

Counterpart of ``apex_tpu/parallel/comm.py``, the one engine that both
:class:`~apex_tpu_torch.parallel.DistributedDataParallel` and the ZeRO
optimizers (:class:`~apex_tpu_torch.parallel.DistributedFusedAdam` /
``DistributedFusedLAMB``) sync through, on ``torch.distributed``
process groups (:mod:`apex_tpu_torch.parallel_state`).

**Wire format** (``wire="f32" | "bf16" | "int8"``).  ``f32`` is exact
(all-reduce / reduce-scatter / all-gather).  ``bf16`` halves the bytes;
``int8`` is the blockwise code (every ``block`` elements share one f32
``max/127`` scale, and the scales' raw bytes ride the codes' payload so
each phase stays one collective).  Whatever the wire, the sum on the
receiving shard is taken in f32 after decoding: only the wire loses
precision, never the reduction.

**Chunking** (``chunks=K``).  The flat buffer is synced in K
near-equal chunks, one collective each.  ``K`` defaults to the
reference's rule, ~4 MiB of wire per chunk (at most 16);
``APEX_TPU_COMM_CHUNKS`` overrides everything.

**The call log** replaces the reference's HLO inspection
(``compiled_collectives`` read the collectives out of compiled HLO).
Every collective the port issues goes through one wrapper here
(:func:`all_reduce`, :func:`all_gather_into`,
:func:`reduce_scatter_into`, :func:`all_to_all_single`, :func:`shift`,
:func:`broadcast`), which records the op, the axis of its group, the
wire dtype and the bytes of its result — the reference's notation: the
full buffer for all-gather and all-to-all, the local shard for
reduce-scatter, the bytes sent for the shift (``collective-permute``).  :func:`compiled_collectives` runs a callable and
returns its calls in the reference's ``{kind: {"count", "bytes"}}``
shape, which :func:`sync_plan` / :func:`zero_plan` can be held to, and
:func:`publish_collective_summary` gauges it on the board.
:func:`psum`, :func:`pmean` and :func:`all_to_all` are the
differentiable collectives over an axis that the models share, on
those wrappers.

**The codec** (``quantize_blocks`` / ``dequantize_blocks``) is the
reference's rules: the last dim cut into blocks of ``block`` elements,
the tail zero-padded into its own block; a block's scale is
``max|block| / 127``, floored at f32 ``tiny``, and 1.0 for an all-zero
block; codes are ``round(x / scale)`` (half to even) clipped to ±127.
The serving stack's int8 KV and weight wires use it too.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch import parallel_state as ps

__all__ = [
    "WIRE_FORMATS",
    "DEFAULT_BLOCK",
    "TARGET_CHUNK_BYTES",
    "ENV_CHUNKS",
    "check_wire",
    "sync_gradients",
    "reduce_scatter_flat",
    "all_gather_flat",
    "all_gather_rows",
    "resolve_chunks",
    "chunks_requested",
    "wire_bytes_per_element",
    "quantize_blocks",
    "dequantize_blocks",
    "pack_int8",
    "unpack_int8",
    "wire_payload_bytes",
    "sync_plan",
    "zero_plan",
    "all_reduce",
    "all_gather_into",
    "reduce_scatter_into",
    "all_to_all_single",
    "shift",
    "broadcast",
    "mean_over",
    "psum",
    "pmean",
    "all_to_all",
    "collective_log",
    "collective_summary",
    "compiled_collectives",
    "ring_wire_bytes",
    "publish_collective_summary",
]

WIRE_FORMATS = ("f32", "bf16", "int8")

_QMAX = 127.0
DEFAULT_BLOCK = 256
_TINY = torch.finfo(torch.float32).tiny

#: ~4 MiB of wire per chunk (the reference's bandwidth/latency rule)
TARGET_CHUNK_BYTES = 4 << 20
_MAX_HEURISTIC_CHUNKS = 16
_MAX_CHUNKS = 64
ENV_CHUNKS = "APEX_TPU_COMM_CHUNKS"


def check_wire(wire: str) -> str:
    if wire not in WIRE_FORMATS:
        raise ValueError(
            f"wire must be one of {WIRE_FORMATS}, got {wire!r}"
        )
    return wire


def wire_bytes_per_element(wire: str, block: int = DEFAULT_BLOCK) -> float:
    """Wire bytes one f32 element costs under ``wire`` (int8 includes
    the 4-byte scale of its block)."""
    check_wire(wire)
    if wire == "f32":
        return 4.0
    if wire == "bf16":
        return 2.0
    return 1.0 + 4.0 / block


def chunks_requested(chunks: Optional[int]) -> bool:
    """True when chunking was asked for (argument or environment)."""
    return chunks is not None or bool(os.environ.get(ENV_CHUNKS))


def resolve_chunks(wire_nbytes: int, chunks: Optional[int] = None) -> int:
    """Chunk count K: ``APEX_TPU_COMM_CHUNKS`` > ``chunks`` >
    ceil(bytes / 4 MiB) capped at 16.  Always >= 1."""
    env = os.environ.get(ENV_CHUNKS)
    if env:
        k = int(env)
    elif chunks is not None:
        k = int(chunks)
    else:
        k = min(-(-max(int(wire_nbytes), 1) // TARGET_CHUNK_BYTES),
                _MAX_HEURISTIC_CHUNKS)
    return max(1, min(k, _MAX_CHUNKS))


def _chunk_bounds(n: int, k: int, align: int = 1):
    """Up to K near-equal (lo, hi) spans covering [0, n); interior edges
    round up to ``align`` and empty spans drop."""
    bounds, prev = [], 0
    for i in range(1, k + 1):
        edge = n if i == k else min(n, -(-((i * n) // k) // align) * align)
        if edge > prev:
            bounds.append((prev, edge))
        prev = max(prev, edge)
    return bounds


def _publish_stats(prefix: str, **stats) -> None:
    """Gauge a sync's plan on the observability board."""
    from apex_tpu_torch.observability.metrics import board

    for key, value in stats.items():
        board.set(f"{prefix}/{key}", value)


# ---------------------------------------------------------------------------
# the blockwise int8 codec
# ---------------------------------------------------------------------------


def _padded_len(n: int, block: int) -> int:
    return n + (-n) % block


def quantize_blocks(x: torch.Tensor, block: int = DEFAULT_BLOCK):
    """``x (..., n)`` f32 -> int8 codes ``(..., n_pad)`` and f32 scales
    ``(..., n_pad / block)``, ``n_pad`` the next multiple of ``block``."""
    x = x.float()
    n = x.shape[-1]
    pad = (-n) % block
    if pad:
        x = F.pad(x, (0, pad))
    xb = x.reshape(*x.shape[:-1], -1, block)
    m = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(m / _QMAX, _TINY)
    scale = torch.where(m > 0, scale, 1.0)
    # a division, not a multiply by the reciprocal: that moves codes at ties
    q = torch.clamp(torch.round(xb / scale), -_QMAX, _QMAX).to(torch.int8)
    return q.reshape(*x.shape[:-1], n + pad), scale[..., 0]


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                      block: int = DEFAULT_BLOCK, n: Optional[int] = None):
    """Inverse of :func:`quantize_blocks` in f32; ``n`` slices the
    zero-pad back off.  The values sit on the int8 grid, so a second
    round trip is exact."""
    shape = q.shape
    xb = q.reshape(*shape[:-1], -1, block).float()
    out = (xb * scale[..., None]).reshape(shape)
    if n is not None and n != shape[-1]:
        out = out[..., :n]
    return out


def pack_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The codes with the f32 scales' raw bytes appended: one payload."""
    sbytes = scale.float().contiguous().view(torch.int8)
    return torch.cat([q, sbytes.reshape(*q.shape[:-1], -1)], dim=-1)


def unpack_int8(payload: torch.Tensor, n: int, block: int = DEFAULT_BLOCK):
    """(codes, scales) of a packed payload of ``n`` real elements."""
    n_pad = _padded_len(n, block)
    q, sbytes = payload[..., :n_pad], payload[..., n_pad:]
    return q, sbytes.contiguous().view(torch.float32)


def _encode(x: torch.Tensor, wire: str, block: int) -> torch.Tensor:
    if wire == "f32":
        return x
    if wire == "bf16":
        return x.to(torch.bfloat16)
    return pack_int8(*quantize_blocks(x, block))


def _decode(payload: torch.Tensor, wire: str, block: int, n: int):
    if wire == "f32":
        return payload
    if wire == "bf16":
        return payload.float()
    q, scale = unpack_int8(payload, n, block)
    return dequantize_blocks(q, scale, block, n)


# ---------------------------------------------------------------------------
# the collective wrapper and its call log
# ---------------------------------------------------------------------------

_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16", torch.int8: "s8", torch.int32: "s32",
                torch.int64: "s64", torch.uint8: "u8", torch.bool: "pred"}

_LOGS: List[list] = []


def _record(kind: str, group, result: torch.Tensor) -> None:
    if _LOGS:
        rec = {"kind": kind, "axis": ps.group_axis(group),
               "dtype": _DTYPE_NAMES.get(result.dtype, str(result.dtype)),
               "bytes": result.numel() * result.element_size()}
        for log in _LOGS:
            log.append(rec)


@contextlib.contextmanager
def collective_log():
    """Record every collective issued inside the block into the list it
    yields (one dict per call: ``kind``, ``axis``, ``dtype``, ``bytes``)."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def _dist():
    return torch.distributed


def all_reduce(tensor: torch.Tensor, group=None, op: str = "sum"):
    """In-place all-reduce (``op`` "sum" or "max") over ``group``; the
    identity for a group of None (an axis of size 1)."""
    if group is None:
        return tensor
    d = _dist()
    d.all_reduce(tensor, op={"sum": d.ReduceOp.SUM,
                             "max": d.ReduceOp.MAX}[op], group=group)
    _record("all-reduce", group, tensor)
    return tensor


def all_gather_into(out: torch.Tensor, tensor: torch.Tensor, group=None):
    """``out`` (world * n, ...) = the members' ``tensor`` (n, ...) in
    rank order."""
    if group is None:
        return out.copy_(tensor)
    d = _dist()
    # torch 2.13 renames the op (the old name warns); torch 2.11 has only
    # the old one
    fn = getattr(d, "all_gather_single", None) or d.all_gather_into_tensor
    fn(out, tensor.contiguous(), group=group)
    _record("all-gather", group, out)
    return out


def reduce_scatter_into(out: torch.Tensor, tensor: torch.Tensor, group=None):
    """``out`` (n / world, ...) = this rank's rows of the sum over the
    members of ``tensor`` (n, ...)."""
    if group is None:
        return out.copy_(tensor)
    d = _dist()
    # renamed in torch 2.13, as all_gather_single
    fn = getattr(d, "reduce_scatter_single", None) or d.reduce_scatter_tensor
    fn(out, tensor.contiguous(), group=group)
    _record("reduce-scatter", group, out)
    return out


def all_to_all_single(out: torch.Tensor, tensor: torch.Tensor, group=None):
    """Row block j of ``tensor`` (world * n, ...) goes to member j; row
    block j of ``out`` comes from member j."""
    if group is None:
        return out.copy_(tensor)
    _dist().all_to_all_single(out, tensor.contiguous(), group=group)
    _record("all-to-all", group, out)
    return out


def shift(tensor: torch.Tensor, delta: int, group=None,
          cyclic: bool = False) -> torch.Tensor:
    """``jax.lax.ppermute`` by ``delta`` places over ``group``: member i
    sends ``tensor`` to member ``i + delta`` and this rank returns what
    member ``i - delta`` sent; without ``cyclic`` a member with no such
    sender receives zeros (and one with no receiver sends nothing).
    Every member calls it.  The wire is one ``all_to_all_single`` with
    uneven splits whose only non-empty blocks are the neighbours': gloo
    refuses send/recv of CUDA tensors, and this carries the same bytes.
    Logged as ``collective-permute`` with the bytes sent."""
    if group is None:
        keep = cyclic or delta == 0
        return tensor.clone() if keep else torch.zeros_like(tensor)
    d = _dist()
    n, r = d.get_world_size(group), d.get_rank(group)
    dst, src = r + delta, r - delta
    if cyclic:
        dst, src = dst % n, src % n
    numel = tensor.numel()
    sends, receives = 0 <= dst < n, 0 <= src < n
    in_splits, out_splits = [0] * n, [0] * n
    if sends:
        in_splits[dst] = numel
    if receives:
        out_splits[src] = numel
    send = tensor.reshape(-1).contiguous() if sends else tensor.new_empty(0)
    out = tensor.new_empty(numel if receives else 0)
    d.all_to_all_single(out, send, out_splits, in_splits, group=group)
    _record("collective-permute", group, send)
    return out.reshape(tensor.shape) if receives else torch.zeros_like(tensor)


def broadcast(tensor: torch.Tensor, src: int, group=None):
    """In-place broadcast from global rank ``src``."""
    if group is None:
        return tensor
    _dist().broadcast(tensor, src, group=group)
    _record("broadcast", group, tensor)
    return tensor


def mean_over(value: torch.Tensor,
              axis_name: str = ps.DATA_PARALLEL_AXIS) -> torch.Tensor:
    """The mean of a scalar (a loss) over the ``axis_name`` group, as a
    detached f32 copy (the reference's ``pmean``)."""
    out = value.detach().float().clone()
    all_reduce(out, ps.get_group(axis_name))
    return out / ps.axis_size(axis_name)


# ---------------------------------------------------------------------------
# differentiable collectives over a parallel_state axis: each backward is
# the transpose JAX takes under shard_map without replication checks
# ---------------------------------------------------------------------------


def _psum(x: torch.Tensor, axis_name: str, mean: bool) -> torch.Tensor:
    # on a copy: reducing a tensor that autograd saved would corrupt it
    out = all_reduce(x.clone(memory_format=torch.contiguous_format),
                     ps.get_group(axis_name))
    return out / ps.axis_size(axis_name) if mean else out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, mean):
        ctx.axis_name, ctx.mean = axis_name, mean
        return _psum(x, axis_name, mean)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.axis_name, ctx.mean), None, None


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``jax.lax.psum`` over ``axis_name``'s group; the backward sums the
    cotangents too, so a rank's gradient of a replicated value is the
    group's size times its local share."""
    return _Psum.apply(x, axis_name, False)


def pmean(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``jax.lax.pmean`` over ``axis_name``'s group; the backward is the
    mean of the cotangents."""
    return _Psum.apply(x, axis_name, True)


def _tiled_all_to_all(x: torch.Tensor, axis_name: str, split: int,
                      concat: int) -> torch.Tensor:
    world = ps.axis_size(axis_name)
    if x.shape[split] % world:
        raise ValueError(
            f"all-to-all: dim {split} (size {x.shape[split]}) is not "
            f"divisible by the axis size {world}")
    send = torch.stack(x.chunk(world, dim=split)).contiguous()
    out = all_to_all_single(torch.empty_like(send), send,
                            ps.get_group(axis_name))
    return torch.cat(out.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, split, concat):
        ctx.axis_name, ctx.split, ctx.concat = axis_name, split, concat
        return _tiled_all_to_all(x, axis_name, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_tiled_all_to_all(g, ctx.axis_name, ctx.concat, ctx.split),
                None, None, None)


def all_to_all(x: torch.Tensor, axis_name: str, split: int,
               concat: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)`` over ``axis_name``: ``x``
    cut into ``world`` blocks along ``split``, block j sent to member j,
    the received blocks concatenated along ``concat`` in member order.
    The backward is the same exchange with the two dims swapped."""
    return _AllToAll.apply(x, axis_name, split % x.ndim, concat % x.ndim)


def collective_summary(records) -> dict:
    """Per-kind ``{"count", "bytes"}`` of a call log (the reference's
    ``collective_summary`` of compiled HLO, read from the calls)."""
    out: dict = {}
    for rec in records:
        r = out.setdefault(rec["kind"], {"count": 0, "bytes": 0})
        r["count"] += 1
        r["bytes"] += rec["bytes"]
    return out


def compiled_collectives(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` and return the
    :func:`collective_summary` of the collectives it issued."""
    with collective_log() as log:
        fn(*args, **kwargs)
    return collective_summary(log)


def ring_wire_bytes(summary: dict, world: int) -> float:
    """Per-rank wire traffic implied by a summary under ring algorithms:
    reduce-scatter carries its shard ``world - 1`` times, all-gather and
    all-to-all ``(world - 1) / world`` of the full buffer, all-reduce
    twice that."""
    t = 0.0
    for kind, rec in summary.items():
        b = rec["bytes"]
        if kind == "all-reduce":
            t += 2.0 * b * (world - 1) / world
        elif kind == "reduce-scatter":
            t += b * (world - 1)
        elif kind in ("all-gather", "all-to-all"):
            t += b * (world - 1) / world
        elif kind == "collective-permute":
            t += b
    return t


def publish_collective_summary(summary: dict, world: Optional[int] = None,
                               prefix: str = "comm/hlo") -> None:
    """Gauge a summary on the board: ``{prefix}/<kind>_count`` and
    ``_bytes``, and with ``world`` the ring model's wire bytes."""
    stats = {}
    for kind, rec in summary.items():
        key = kind.replace("-", "_")
        stats[f"{key}_count"] = rec["count"]
        stats[f"{key}_bytes"] = rec["bytes"]
    if world is not None:
        stats["ring_wire_bytes"] = ring_wire_bytes(summary, world)
    _publish_stats(prefix, **stats)


# ---------------------------------------------------------------------------
# flat-buffer collectives (the ZeRO building blocks)
# ---------------------------------------------------------------------------


def reduce_scatter_flat(flat: torch.Tensor,
                        axis_name: str = ps.DATA_PARALLEL_AXIS, *,
                        wire: str = "f32", chunks: Optional[int] = None,
                        block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Sum a flat f32 buffer over ``axis_name`` and return this rank's
    contiguous shard (``flat.numel() / world`` elements, f32).

    ``wire="f32"`` is one reduce-scatter per chunk; the quantized wires
    send one all-to-all of encoded payloads per chunk and sum the
    decoded rows in f32 on the receiving shard."""
    check_wire(wire)
    group = ps.get_group(axis_name)
    world = ps.axis_size(axis_name)
    n = flat.shape[0]
    if n == 0 or world == 1:
        return flat.float()
    if n % world:
        raise ValueError(f"flat size {n} not divisible by world {world}")
    shard = n // world
    k = min(resolve_chunks(int(n * wire_bytes_per_element(wire, block)),
                           chunks), shard)
    rows = flat.reshape(world, shard).float()
    bounds = _chunk_bounds(shard, k, 1 if wire == "f32" else block)
    _publish_stats(
        "comm/rs", wire=wire, world=world, elements=n,
        chunks=len(bounds), collectives=len(bounds),
        wire_bytes=int(n * wire_bytes_per_element(wire, block)),
    )
    outs = []
    for lo, hi in bounds:
        seg = rows[:, lo:hi]  # row j = member j's slice of this chunk
        if wire == "f32":
            out = torch.empty(hi - lo, dtype=torch.float32, device=flat.device)
            outs.append(reduce_scatter_into(out, seg.reshape(-1), group))
        else:
            send = _encode(seg, wire, block)
            recv = all_to_all_single(torch.empty_like(send), send, group)
            outs.append(_decode(recv, wire, block, hi - lo).sum(dim=0))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def all_gather_flat(shard: torch.Tensor,
                    axis_name: str = ps.DATA_PARALLEL_AXIS, *,
                    wire: str = "f32", chunks: Optional[int] = None,
                    block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """All-gather the members' contiguous shards into the full flat f32
    buffer (rank-major).  Quantized wires decode every payload, this
    rank's own included, so the buffer is the same bits on every rank."""
    check_wire(wire)
    group = ps.get_group(axis_name)
    world = ps.axis_size(axis_name)
    s = shard.shape[0]
    if s == 0 or world == 1:
        return shard.float()
    k = min(resolve_chunks(
        int(world * s * wire_bytes_per_element(wire, block)), chunks), s)
    shard = shard.float()
    bounds = _chunk_bounds(s, k, 1 if wire == "f32" else block)
    _publish_stats(
        "comm/ag", wire=wire, world=world, elements=world * s,
        chunks=len(bounds), collectives=len(bounds),
        wire_bytes=int(world * s * wire_bytes_per_element(wire, block)),
    )
    parts = []
    for lo, hi in bounds:
        send = _encode(shard[lo:hi], wire, block)
        got = torch.empty((world, send.shape[0]), dtype=send.dtype,
                          device=send.device)
        all_gather_into(got.reshape(-1), send, group)
        parts.append(_decode(got, wire, block, hi - lo))  # (world, cs)
    full = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return full.reshape(-1)


def all_gather_rows(row: torch.Tensor,
                    axis_name: str = ps.DATA_PARALLEL_AXIS, *,
                    wire: str = "f32", async_op: bool = False):
    """Every member's metrics row as a ``(world, n)`` f32 matrix (row j
    = member j), in one collective.  ``async_op=True`` (f32 wire only)
    dispatches the gather and returns ``(matrix, work)``: the matrix is
    valid once ``work.wait()`` returned (``work`` is None where there is
    no group to wait on)."""
    check_wire(wire)
    world = ps.axis_size(axis_name)
    flat = row.reshape(-1).float()
    n = flat.shape[0]
    _publish_stats(
        "comm/fleet", wire=wire, world=world, elements=world * n,
        collectives=1,
        wire_bytes=int(world * n * wire_bytes_per_element(wire)),
    )
    if not async_op:
        full = all_gather_flat(flat, axis_name, wire=wire, chunks=1)
        return full.reshape(world, n)
    if wire != "f32":
        raise ValueError("an asynchronous row gather rides the f32 wire")
    group = ps.get_group(axis_name)
    out = torch.empty((world, n), dtype=torch.float32, device=flat.device)
    if group is None or world == 1:
        return out.copy_(flat.reshape(1, n)), None
    d = _dist()
    fn = getattr(d, "all_gather_single", None) or d.all_gather_into_tensor
    work = fn(out.reshape(-1), flat.contiguous(), group=group, async_op=True)
    _record("all-gather", group, out)
    return out, work


# ---------------------------------------------------------------------------
# gradient sync (the DDP entry point)
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    """The tensors (or sizes) of a dict, list, tuple or single tensor,
    in iteration order."""
    if isinstance(tree, dict):
        return list(tree.values())
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return [tree]


def _size(leaf) -> int:
    return int(leaf.numel()) if isinstance(leaf, torch.Tensor) else int(leaf)


@torch.no_grad()
def sync_gradients(grads: Any, axis_name: str = ps.DATA_PARALLEL_AXIS, *,
                   wire: str = "f32", chunks: Optional[int] = None,
                   block: int = DEFAULT_BLOCK, min_size: int = 1024,
                   gradient_average: bool = True,
                   gradient_predivide_factor: Optional[float] = None):
    """Sync gradient tensors over ``axis_name`` **in place** and return
    ``grads`` (a tensor, or a dict or list of them).

    ``wire="f32"`` with no chunking request all-reduces each tensor
    exactly.  Otherwise every tensor of >= ``min_size`` elements joins
    one flat f32 bucket (in iteration order), synced as a chunked
    reduce-scatter and all-gather: 2K collectives whatever the count of
    tensors; smaller tensors always take the exact all-reduce.  With
    ``gradient_average`` the sum is divided by the world (by world /
    ``gradient_predivide_factor`` after a division by the factor before
    the sum)."""
    check_wire(wire)
    group = ps.get_group(axis_name)
    world = ps.axis_size(axis_name)
    post = 1.0
    if gradient_average:
        post = (world / gradient_predivide_factor
                if gradient_predivide_factor is not None else world)
    leaves = _leaves(grads)
    big = [i for i, g in enumerate(leaves)
           if g.numel() >= min_size and g.numel() > 0 and world > 1]
    resolved = None
    if big:
        nbytes = int(sum(leaves[i].numel() for i in big)
                     * wire_bytes_per_element(wire, block))
        resolved = resolve_chunks(nbytes, chunks)
    bucketed = bool(big) and (
        wire != "f32" or (chunks_requested(chunks) and resolved > 1))
    big_set = set(big) if bucketed else set()
    bucket_elems = sum(leaves[i].numel() for i in big_set)
    psum_bytes = sum(g.numel() * 4 for i, g in enumerate(leaves)
                     if i not in big_set)
    _publish_stats(
        "comm/sync", wire=wire, world=world,
        bucket_elements=int(bucket_elems), chunks=int(resolved or 1),
        psum_leaves=len(leaves) - len(big_set),
        wire_bytes=int(bucket_elems * wire_bytes_per_element(wire, block)
                       + psum_bytes),
    )
    if bucketed:
        flat = torch.cat([leaves[i].reshape(-1).float() for i in big])
        if gradient_predivide_factor is not None:
            flat.div_(gradient_predivide_factor)
        n = flat.shape[0]
        padded = n + (-n) % world
        if padded != n:
            flat = F.pad(flat, (0, padded - n))
        shard = reduce_scatter_flat(flat, axis_name, wire=wire,
                                    chunks=resolved, block=block)
        synced = all_gather_flat(shard, axis_name, wire=wire,
                                 chunks=resolved, block=block)[:n] / post
        offs = 0
        for i in big:
            sz = leaves[i].numel()
            leaves[i].copy_(synced[offs:offs + sz].reshape(leaves[i].shape))
            offs += sz
    for i, g in enumerate(leaves):
        if i in big_set:
            continue
        if gradient_predivide_factor is not None:
            g.div_(gradient_predivide_factor)
        all_reduce(g, group)
        if post != 1.0:
            g.div_(post)
    return grads


# ---------------------------------------------------------------------------
# declared collective plans
#
# Each sync path above promises a collective structure; these helpers
# write it down in the reference's plan schema, mirroring the routing
# decisions (bucketing, chunk bounds, wire payloads) of the code above.
# ---------------------------------------------------------------------------


def wire_payload_bytes(n: int, wire: str, block: int = DEFAULT_BLOCK) -> int:
    """Exact encoded bytes of ``n`` f32 elements under ``wire``, the
    int8 block pad and packed scales included."""
    check_wire(wire)
    if wire == "f32":
        return n * 4
    if wire == "bf16":
        return n * 2
    n_pad = _padded_len(n, block)
    return n_pad + 4 * (n_pad // block)


def _wire_dtypes(wire: str):
    return {"f32": ["f32"], "bf16": ["bf16"], "int8": ["s8"]}[wire]


def _bound(estimate: int, slack: int = 1024):
    """[0, hi] byte bounds around an exact estimate."""
    return [0, int(estimate + max(slack, estimate // 4))]


def sync_plan(grads: Any, world: int,
              axis_name: str = ps.DATA_PARALLEL_AXIS, *, wire: str = "f32",
              chunks: Optional[int] = None, block: int = DEFAULT_BLOCK,
              min_size: int = 1024, extra_allreduce_bytes: int = 64) -> list:
    """The collective plan :func:`sync_gradients` promises for these
    gradients (tensors or element counts): a list of ``{"kind", "axis",
    "count", "bytes", "dtypes"}`` entries, ``count`` None where the
    small all-reduces may be any number."""
    check_wire(wire)
    sizes = [_size(g) for g in _leaves(grads)]
    if world <= 1:
        return []
    big = [s for s in sizes if s >= min_size and s > 0]
    resolved = None
    if big:
        nbytes = int(sum(big) * wire_bytes_per_element(wire, block))
        resolved = resolve_chunks(nbytes, chunks)
    bucketed = bool(big) and (
        wire != "f32" or (chunks_requested(chunks) and resolved > 1))
    entries = []
    psum_elems = sum(s for s in sizes
                     if not (bucketed and s >= min_size and s > 0))
    if bucketed:
        n = sum(big)
        padded = n + (-n) % world
        shard = padded // world
        align = 1 if wire == "f32" else block
        bounds = _chunk_bounds(shard, min(resolved, shard), align)
        count = len(bounds)
        if wire == "f32":
            entries.append({
                "kind": "reduce-scatter", "axis": axis_name,
                "count": count, "bytes": _bound(shard * 4),
                "dtypes": _wire_dtypes(wire),
            })
        else:
            a2a = sum(world * wire_payload_bytes(hi - lo, wire, block)
                      for lo, hi in bounds)
            entries.append({
                "kind": "all-to-all", "axis": axis_name,
                "count": count, "bytes": _bound(a2a),
                "dtypes": _wire_dtypes(wire),
            })
        ag = sum(world * wire_payload_bytes(hi - lo, wire, block)
                 for lo, hi in bounds)
        entries.append({
            "kind": "all-gather", "axis": axis_name,
            "count": count, "bytes": _bound(ag),
            "dtypes": _wire_dtypes(wire),
        })
    if psum_elems or extra_allreduce_bytes:
        entries.append({
            "kind": "all-reduce", "axis": axis_name, "count": None,
            "bytes": _bound(psum_elems * 4 + extra_allreduce_bytes),
            "dtypes": ["f32"],
        })
    return entries


def zero_plan(n_elements: int, world: int,
              axis_name: str = ps.DATA_PARALLEL_AXIS, *, wire: str = "f32",
              param_wire: Optional[str] = None, chunks: Optional[int] = None,
              block: int = DEFAULT_BLOCK,
              extra_allreduce_bytes: int = 256) -> list:
    """The plan a ZeRO step promises for ``n_elements`` flat f32 params:
    the grads' chunked reduce-scatter at ``wire``, the updated shards'
    chunked all-gather at ``param_wire or wire``, and the small
    all-reduces (loss, norms)."""
    check_wire(wire)
    if world <= 1:
        return []
    padded = n_elements + (-n_elements) % world
    shard = padded // world

    def _one(w, gather: bool):
        align = 1 if w == "f32" else block
        n_for_chunks = world * shard if gather else padded
        k = min(resolve_chunks(
            int(n_for_chunks * wire_bytes_per_element(w, block)), chunks,
        ), shard)
        bounds = _chunk_bounds(shard, k, align)
        count = len(bounds)
        if gather or w != "f32":
            payload = sum(world * wire_payload_bytes(hi - lo, w, block)
                          for lo, hi in bounds)
            return {
                "kind": "all-gather" if gather else "all-to-all",
                "axis": axis_name, "count": count,
                "bytes": _bound(payload), "dtypes": _wire_dtypes(w),
            }
        return {
            "kind": "reduce-scatter", "axis": axis_name, "count": count,
            "bytes": _bound(shard * 4), "dtypes": _wire_dtypes(w),
        }

    return [
        _one(wire, gather=False),
        _one(param_wire or wire, gather=True),
        {"kind": "all-reduce", "axis": axis_name, "count": None,
         "bytes": _bound(extra_allreduce_bytes), "dtypes": ["f32"]},
    ]

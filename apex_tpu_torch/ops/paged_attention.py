"""Paged single-query decode attention — public API and dispatch.

Counterpart of ``apex_tpu/ops/paged_attention.py``: one query row per
sequence against a KV history in the block-pooled paged cache
(:mod:`apex_tpu_torch.serve.cache`).

- **plain path** (CPU tensors): :func:`paged_decode_attention_reference`,
  the JAX package's gather-then-attend composition;
- **kernel path** (CUDA tensors): kernel K6 (``csrc/paged_decode.cu``,
  replacing the Pallas ``paged_decode_fwd``) — reads the live pages in
  place through the page table, with the query RoPE and the int8 KV
  dequant fused, at any head dim without padding (padding would copy
  the page pool, which is the KV cache).  It splits each sequence's
  page table into runs of pages, one CTA per (sequence, head, run), by
  the plan of :func:`decode_split_plan`, which reads shapes only (decode
  is bound by the host: the lengths are never read back), and merges
  the runs' partial softmax states in a fixed order inside the same
  launch.

Both share the semantics: positions ``>= lengths[b]`` are masked, an
idle slot (``lengths[b] == 0``) returns exactly zeros, and RoPE is
applied to the query inside the op (cached keys were rotated at append
time).  Inference only: the op runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from apex_tpu_torch.ops import _dispatch
from apex_tpu_torch.ops.attention import MASK_VALUE
from apex_tpu_torch.ops.rope import rotate_half

__all__ = [
    "decode_split_plan",
    "paged_decode_attention",
    "paged_decode_attention_reference",
    "paged_decode_fwd",
]

KERNEL = "paged_decode"
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def paged_decode_attention_reference(
    q, k_pages, v_pages, page_table, lengths, *,
    scale: Optional[float] = None,
    k_scale=None, v_scale=None, rope_cos=None, rope_sin=None,
):
    """Gather-then-attend composition — the plain version, with the
    signature and semantics of :func:`paged_decode_attention`."""
    b, h, d = q.shape
    page = k_pages.shape[2]
    np_ = page_table.shape[1]
    if scale is None:
        scale = d ** -0.5
    qf = q.float()
    if rope_cos is not None:
        cos = rope_cos.float()[:, None, :]  # (B, 1, D)
        sin = rope_sin.float()[:, None, :]
        qf = qf * cos + rotate_half(qf) * sin
    table = page_table.long()
    # gather: (B, NP, H, page, D) -> (B, H, NP*page, D)
    k = k_pages[table].float()
    v = v_pages[table].float()
    if k_scale is not None:
        k = k * k_scale[table].float()[..., None]
        v = v * v_scale[table].float()[..., None]
    k = k.movedim(1, 2).reshape(b, h, np_ * page, d)
    v = v.movedim(1, 2).reshape(b, h, np_ * page, d)
    s = torch.einsum("bhd,bhtd->bht", qf, k) * scale
    pos = torch.arange(np_ * page, device=q.device)
    valid = pos[None, :] < lengths.long()[:, None]  # (B, T)
    s = s.masked_fill(~valid[:, None, :], MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bht,bhtd->bhd", p / l.clamp_min(1e-30), v)
    # idle slots: softmax over an all-masked row would average garbage
    # pages — the contract is zeros
    o = torch.where(lengths[:, None, None] > 0, o, 0.0)
    return o.to(q.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k/v pages, k/v scales, table, lengths, cos, sin, out; batch, heads,
# d, page, NP; scale, q dtype, kv dtype; workspace, counters; split pages,
# splits; stream
_ARGS = ([_P] * 10 + [_I] * 5 + [ctypes.c_float, _I, _I] + [_P, _P]
         + [_I, _I, _P])

#: the fewest tokens a split walks (two of the kernel's 32-token tiles)
SPLIT_MIN_TOKENS = 64
#: the most CTAs a launch asks for, per SM: a CTA whose split lies past
#: its sequence exits at once, but still takes a slot in the grid
SPLIT_MAX_CTAS_PER_SM = 64
#: the most splits a row (the kernel merges them in one CTA)
SPLIT_MAX = 128


def decode_split_plan(batch: int, heads: int, np_: int, page: int,
                      sms: int) -> Tuple[int, int]:
    """K6's grid from shapes alone: ``(split_pages, n_split)``, the pages
    of a split and the splits of a page-table row, so the kernel runs
    ``batch * heads * n_split`` CTAs.  A split walks at least
    ``SPLIT_MIN_TOKENS`` tokens (a few pages), so that a long sequence
    spreads over many CTAs while a CTA still has a tile or two to
    overlap; the grid is held to ``SPLIT_MAX_CTAS_PER_SM`` CTAs an SM, and
    a row to ``SPLIT_MAX`` splits, by lengthening the splits.  Every split
    starts inside the row (``n_split * split_pages`` covers ``np_`` and
    ``(n_split - 1) * split_pages < np_``).  The lengths are not an
    argument: the kernel reads them, and a CTA past its sequence's length
    exits."""
    for name, v in (("batch", batch), ("heads", heads), ("np_", np_),
                    ("page", page), ("sms", sms)):
        if int(v) < 1:
            raise ValueError(f"{name} must be positive, got {v}")
    split = -(-SPLIT_MIN_TOKENS // page)
    max_splits = min(SPLIT_MAX, max(
        1, SPLIT_MAX_CTAS_PER_SM * sms // (batch * heads)))
    split = min(max(split, -(-np_ // max_splits)), np_)
    return split, -(-np_ // split)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: device -> K6's arrival counters: int32, zero between launches (the
#: kernel's last CTA of each (sequence, head) resets its own), so no call
#: pays a fill; grown, never shrunk.  The launches of one device share
#: them, so K6 runs on one stream at a time (the decode step's).
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def paged_decode_fwd(
    q, k_pages, v_pages, page_table, lengths, *, scale: float,
    k_scale=None, v_scale=None, rope_cos=None, rope_sin=None,
):
    """Kernel K6 on CUDA tensors.

    - ``q`` (B, H, D) f32/bf16, pre-RoPE when ``rope_cos``/``rope_sin``
      (B, D) are given;
    - ``k_pages``/``v_pages`` (P, H, page, D) f32/bf16, or int8 codes with
      ``k_scale``/``v_scale`` (P, H, page) f32;
    - ``page_table`` (B, NP) and ``lengths`` (B,) int32.  Page ids must
      lie in ``[0, P)``: the kernel reads them as given.

    Returns (B, H, D) in ``q.dtype``.  One launch: the grid comes from
    :func:`decode_split_plan`; with more than one split a row, the
    partial states go to a workspace allocated here and the arrival
    counters of :data:`_COUNTERS`."""
    operands = [q, k_pages, v_pages, page_table, lengths]
    has_scales = k_scale is not None
    has_rope = rope_cos is not None
    if has_scales != (v_scale is not None):
        raise ValueError("k_scale and v_scale must be given together")
    if has_rope != (rope_sin is not None):
        raise ValueError("rope_cos and rope_sin must be given together")
    if has_scales:
        operands += [k_scale, v_scale]
    if has_rope:
        operands += [rope_cos, rope_sin]
    if not _dispatch.on_card(*operands):
        raise ValueError(
            "paged_decode_fwd launches the CUDA kernel: pass CUDA tensors"
        )
    b, h, d = q.shape
    p_, h2, page, d2 = k_pages.shape
    np_ = page_table.shape[1]
    if (h2, d2) != (h, d) or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if page_table.shape != (b, np_) or lengths.shape != (b,):
        raise ValueError("expected page_table (B, NP) and lengths (B,)")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    if k_pages.dtype not in _KV_CODES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pages must be f32, bf16 or int8, got {k_pages.dtype}")
    if (k_pages.dtype == torch.int8) != has_scales:
        raise ValueError("int8 pages need k_scale/v_scale, and only they do")
    if has_scales:
        for s in (k_scale, v_scale):
            if s.shape != (p_, h, page) or s.dtype != torch.float32:
                raise ValueError("scales must be f32 (P, H, page)")
    if has_rope:
        rope_cos = rope_cos.float().contiguous()
        rope_sin = rope_sin.float().contiguous()
        if rope_cos.shape != (b, d) or rope_sin.shape != (b, d):
            raise ValueError("rope_cos/rope_sin must be (B, D)")
    if d < 1:
        raise ValueError(f"head dim must be positive, got {d}")
    if has_rope and d % 2:
        raise ValueError(f"the rotate-half RoPE needs an even head dim, got {d}")
    tensors = [q, k_pages, v_pages, page_table, lengths] + (
        [k_scale, v_scale] if has_scales else []
    )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_fwd takes contiguous tensors")
    out = torch.empty_like(q)
    if b == 0:
        return out
    dev = q.device
    split, n_split = decode_split_plan(b, h, np_, page, _sms(dev.index))
    work = counters = None
    if n_split > 1:
        work = torch.empty(b * h * n_split * (d + 2), dtype=torch.float32,
                           device=dev)
        counters = _counters(dev, b * h)
    _dispatch.launch(
        KERNEL, _ARGS, dev, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        page_table.data_ptr(), lengths.data_ptr(), _ptr(rope_cos),
        _ptr(rope_sin), out.data_ptr(), b, h, d, page, np_, float(scale),
        _Q_CODES[q.dtype], _KV_CODES[k_pages.dtype], _ptr(work),
        _ptr(counters), split, n_split,
    )
    return out


@torch.no_grad()
def paged_decode_attention(
    q, k_pages, v_pages, page_table, lengths, *,
    scale: Optional[float] = None,
    k_scale=None, v_scale=None, rope_cos=None, rope_sin=None,
):
    """Single-query attention over the paged KV cache (arguments as in
    :func:`paged_decode_fwd`); returns (B, H, D) in ``q.dtype``.  The
    kernel for CUDA tensors, the gather-based composition for CPU
    tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kw = dict(
        scale=scale, k_scale=k_scale, v_scale=v_scale,
        rope_cos=rope_cos, rope_sin=rope_sin,
    )
    args = (q, k_pages, v_pages, page_table, lengths)
    if _dispatch.on_card(q, k_pages, v_pages, page_table, lengths):
        _dispatch.record_path("paged_decode_attention", "cuda")
        return paged_decode_fwd(*args, **kw)
    _dispatch.record_path("paged_decode_attention", "torch")
    return paged_decode_attention_reference(*args, **kw)

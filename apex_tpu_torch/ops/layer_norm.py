"""Fused LayerNorm / RMSNorm — forward and backward.

Counterpart of ``apex_tpu/ops/layer_norm.py``: ``fused_layer_norm_affine``,
``fused_layer_norm``, ``fused_rms_norm_affine`` and ``fused_rms_norm``,
each differentiable and with the ``memory_efficient`` flag.

Semantics (both paths): statistics and normalization in **f32**
whatever the input dtype; the output has the input's dtype; mean and
rstd are kept in f32; the weight and bias gradients come back in the
parameters' dtype.  ``memory_efficient=True`` saves the forward output
and rstd instead of the input and mean, and the backward recovers
``xhat = (y - b) / w`` (0 where ``w == 0``).

One ``autograd.Function`` (:class:`_Norm2d`) carries both directions.
For a CUDA tensor the forward is kernel K1 (``csrc/layer_norm_fwd.cu``,
replacing the Pallas ``layer_norm_fwd``) and the backward kernel K2
(``csrc/layer_norm_bwd.cu``, replacing ``layer_norm_bwd``); for a CPU
tensor they are the plain twins :func:`layer_norm_reference` and
:func:`layer_norm_bwd_reference`, the arithmetic of the JAX package's
``_jnp_fwd`` and ``_jnp_bwd``.  The kernels take any hidden size: the
TPU's lane rule (``hidden % 128``) does not apply.  Both kernels run a
row from registers on one warp or a narrower lane group (hidden up to
1024), or on 4 or 8 warps of a CTA (the wide-row instance, up to
:data:`WIDE_MAX_HIDDEN`), with a persistent grid; wider rows stream.
:func:`norm_launch_plan` picks the load width, the values per lane, the
lanes and warps per row and the grid for a call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops import _build, _dispatch

__all__ = [
    "fused_layer_norm",
    "fused_layer_norm_affine",
    "fused_rms_norm",
    "fused_rms_norm_affine",
    "layer_norm_bwd",
    "layer_norm_bwd_reference",
    "layer_norm_fwd",
    "layer_norm_reference",
    "kernel_specs",
    "norm_launch_plan",
]

Shape = Union[int, Sequence[int]]

KERNEL = "layer_norm_fwd"
KERNEL_BWD = "layer_norm_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: warps in a CTA of K1 and K2
NORM_WARPS = 8
#: the values a lane can hold in registers (K1's and K2's instances of
#: one warp or a narrower lane group a row)
_PER_LANE = (4, 8, 16, 32)
#: the wide-row instances for rows wider than 32 lanes x 32 values:
#: (warps a row, values a lane), fewest warps first.  The plan takes the
#: first that covers the row and whose K2 fits the register file without
#: spilling (:func:`_wide_regs`), else the first that covers it: at 4096
#: values 4 x 32 in bf16 (K1 5%, K2 1% faster than 8 x 16 on an H100)
#: and 8 x 16 in f32 (K2 12% faster than 4 x 32, which spills)
_WIDE = ((4, 16), (4, 32), (8, 16), (8, 32))
#: the widest row the wide-row instance holds; wider rows stream (one
#: warp a row, three passes over it in K1, two in K2)
WIDE_MAX_HIDDEN = NORM_WARPS * 32 * 32


@dataclasses.dataclass(frozen=True)
class NormPlan:
    """How K1 or K2 runs one call.

    - ``vec``: values per load — 16 bytes' worth (8 bf16, 4 f32) when the
      row's byte width and every row tensor's and w's and b's bases are
      multiples of 16, else 1 (the same path, one element per load);
    - ``per_lane``: values a lane holds in registers (0: the row streams
      through L1/L2, one warp per row);
    - ``lanes``: lanes of a warp per row, a power of two, and
      ``rows_per_warp`` = 32 / lanes rows side by side in a warp;
    - ``warps_per_row``: 1, or the wide-row instance's 4 or 8 warps of a
      CTA that share a row (``lanes`` 32): the kernel's ``lanes``
      argument is the row's threads, ``lanes * warps_per_row``;
    - ``ctas_per_sm``: the CTAs of :data:`NORM_WARPS` warps of the
      instance that stay resident on an SM;
    - ``grid``: the persistent grid, at most ``ctas_per_sm`` per SM;
    - ``parts``: K2's partial rows of dw and db (one per CTA, or one per
      warp when the row streams);
    - ``per_cta``: the rows a CTA takes per pass of the grid (the
      ``block_rows`` asked for, or one row group of its warps).
    """

    vec: int
    per_lane: int
    lanes: int
    warps_per_row: int
    rows_per_warp: int
    ctas_per_sm: int
    grid: int
    parts: int
    per_cta: int


def norm_launch_plan(rows: int, hidden: int, elem_bytes: int, *, sms: int,
                     ctas_per_sm: Callable[[int, int, int], int],
                     aligned: bool = True, bwd: bool = False,
                     block_rows: Optional[int] = None) -> NormPlan:
    """The launch plan of K1 (or K2 with ``bwd``) for ``rows`` rows of
    ``hidden`` values of ``elem_bytes`` bytes (2 bf16, 4 f32) on a card
    with ``sms`` SMs; ``aligned`` says whether every row tensor's base,
    and w's and b's, is 16-byte aligned.  ``ctas_per_sm(vec, per_lane,
    warps_per_row)`` gives the CTAs of the chosen instance that stay
    resident on an SM: on the card, the built kernel's own count
    (:func:`_resident_ctas`).  ``block_rows`` (a tuning-cache entry,
    :mod:`.tune_cache`) sets the rows a CTA takes per pass of the
    persistent grid instead of one row group of its warps.  A row of
    1025 to :data:`WIDE_MAX_HIDDEN` values takes the wide-row instance
    (:data:`_WIDE`)."""
    if rows < 1 or hidden < 1 or elem_bytes not in (2, 4) or sms < 1:
        raise ValueError(
            f"bad norm launch: rows={rows} hidden={hidden} "
            f"elem_bytes={elem_bytes} sms={sms}")
    vec = 16 // elem_bytes
    if not aligned or hidden % vec:
        vec = 1
    per_lane = next((n for n in _PER_LANE if n >= vec and hidden <= 32 * n),
                    0)
    lanes, warps = 32, 1
    if per_lane:
        lanes = 1 << max(0, math.ceil(math.log2(-(-hidden // per_lane))))
    elif hidden <= WIDE_MAX_HIDDEN:
        covers = [(w, n) for w, n in _WIDE if hidden <= 32 * w * n]
        warps, per_lane = next(
            (lay for lay in covers
             if _wide_regs(elem_bytes, vec, lay[1], bwd=True) <= 255),
            covers[0])
    ctas = ctas_per_sm(vec, per_lane, warps)
    if ctas < 1:
        raise ValueError(f"no CTA of the norm kernel fits an SM: {ctas}")
    rows_per_warp = 32 // lanes
    if block_rows is not None and block_rows < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    per_cta = block_rows or NORM_WARPS * rows_per_warp // warps
    grid = min(-(-rows // per_cta), sms * ctas)
    parts = grid if per_lane else grid * NORM_WARPS
    return NormPlan(vec, per_lane, lanes, warps, rows_per_warp, ctas, grid,
                    parts, per_cta)


@functools.lru_cache(maxsize=None)
def _resident_ctas(kernel: str, dtype_code: int, device_index: int, vec: int,
                   per_lane: int, warps: int) -> int:
    """The CTAs of K1's or K2's instance that stay resident on an SM of
    the device, from the CUDA occupancy calculator on the built kernel
    (``<kernel>_ctas_per_sm``)."""
    fn = getattr(_build.load(_build.library(kernel)), f"{kernel}_ctas_per_sm")
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _build.check(kernel, fn(dtype_code, vec, per_lane, warps,
                                ctypes.byref(ctas)))
    return ctas.value


def _plan(kernel, x2d, *row_tensors, bwd, block_rows=None):
    """The launch plan of a call; ``block_rows`` None reads the tuning
    cache's entry for the hidden size (none: the default)."""
    rows, hidden = x2d.shape
    dev = x2d.device.index
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2d, *row_tensors))
    ctas = functools.partial(_resident_ctas, kernel,
                             _DTYPE_CODES[x2d.dtype], dev)
    from apex_tpu_torch.ops import tune_cache

    if block_rows is None:
        block_rows = tune_cache.layer_norm_block_rows(hidden)
    return norm_launch_plan(rows, hidden, x2d.element_size(), sms=sms,
                            ctas_per_sm=ctas, aligned=aligned, bwd=bwd,
                            block_rows=block_rows)


def _bwd_plan(x2d, w, b, g, dx, *, x_is_output, block_rows=None):
    """K2's launch plan: the alignment check takes x, g, dx and w, and b
    in ``x_is_output`` mode, where the wide-row instance loads b 16 bytes
    at a time (K1's takes b always)."""
    return _plan(KERNEL_BWD, x2d, g, dx, w, *((b,) if x_is_output else ()),
                 bwd=True, block_rows=block_rows)


def layer_norm_reference(
    x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float,
    rms: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K1: ``(y, mu, rstd)`` with ``mu``/``rstd``
    f32 ``(rows,)`` — ``_jnp_fwd``'s arithmetic."""
    xf = x2d.float()
    wf = w.float()
    bf = b.float()
    if rms:
        mu = torch.zeros(xf.shape[0], dtype=torch.float32, device=xf.device)
        var = (xf * xf).mean(dim=-1)
    else:
        mu = xf.mean(dim=-1)
        xc = xf - mu[:, None]
        var = (xc * xc).mean(dim=-1)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mu[:, None]) * rstd[:, None] * wf + bf
    return y.to(x2d.dtype), mu, rstd


def layer_norm_bwd_reference(
    x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mu: torch.Tensor,
    rstd: torch.Tensor, g: torch.Tensor, rms: bool, x_is_output: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K2: ``(dx, dw, db)`` with ``dx`` in ``x2d``'s
    dtype and f32 ``dw``/``db`` — ``_jnp_bwd``'s arithmetic.  With
    ``x_is_output``, ``x2d`` holds the forward output and ``mu`` is not
    read."""
    xf = x2d.float()
    wf = w.float()
    gf = g.float()
    bf = b.float()
    if x_is_output:
        wsafe = torch.where(wf == 0.0, torch.ones_like(wf), wf)
        xhat = torch.where(wf == 0.0, torch.zeros_like(xf), (xf - bf) / wsafe)
    else:
        xhat = (xf - mu[:, None]) * rstd[:, None]
    dyw = gf * wf
    c2 = (dyw * xhat).mean(dim=-1, keepdim=True)
    if rms:
        dx = rstd[:, None] * (dyw - xhat * c2)
    else:
        c1 = dyw.mean(dim=-1, keepdim=True)
        dx = rstd[:, None] * (dyw - c1 - xhat * c2)
    dw = (gf * xhat).sum(dim=0)
    db = gf.sum(dim=0)
    return dx.to(x2d.dtype), dw, db


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# x, w, b, y, mu, rstd; rows, hidden, eps, rms, dtype; vec, per_lane,
# threads a row (NormPlan lanes * warps_per_row), grid; stream
_FWD_ARGS = [_P] * 6 + [_I, _I, _F, _I, _I] + [_I] * 4 + [_P]
# x, w, b, mu, rstd, g, dx, partial rows; rows, hidden, rms, x_is_output,
# dtype; vec, per_lane, threads a row, grid; stream
_BWD_ARGS = [_P] * 8 + [_I] * 5 + [_I] * 4 + [_P]


def _check_operands(name, x2d, w, b, *rows_f32):
    if not _dispatch.on_card(x2d, w, b, *rows_f32):
        raise ValueError(f"{name} launches the CUDA kernel: pass CUDA tensors")
    if x2d.dim() != 2 or w.shape != (x2d.shape[1],) or b.shape != w.shape:
        raise ValueError(
            f"expected x (rows, hidden) and w, b (hidden,), got "
            f"{tuple(x2d.shape)}, {tuple(w.shape)}, {tuple(b.shape)}"
        )
    if x2d.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes f32 or bf16 x, got {x2d.dtype}")
    if any(t.dtype != torch.float32 for t in (w, b, *rows_f32)):
        raise TypeError(f"{name} takes f32 weight, bias and statistics")
    if any(t.shape != (x2d.shape[0],) for t in rows_f32):
        raise ValueError(f"{name} takes (rows,) statistics")
    if not all(t.is_contiguous() for t in (x2d, w, b, *rows_f32)):
        raise ValueError(f"{name} takes contiguous tensors")


def layer_norm_fwd(
    x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, eps: float,
    rms: bool, block_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K1 on CUDA tensors: ``(y, mu, rstd)`` for ``x2d`` (rows,
    hidden) in f32 or bf16 and f32 ``w``/``b`` (hidden,).  ``block_rows``
    sets the rows a CTA takes per pass (None: the tuning cache's, else the
    default; :func:`norm_launch_plan`)."""
    _check_operands("layer_norm_fwd", x2d, w, b)
    rows, hidden = x2d.shape
    y = torch.empty_like(x2d)
    mu = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    if rows == 0:
        return y, mu, rstd
    plan = _plan(KERNEL, x2d, y, w, b, bwd=False, block_rows=block_rows)
    _dispatch.launch(
        KERNEL, _FWD_ARGS, x2d.device, x2d.data_ptr(), w.data_ptr(),
        b.data_ptr(), y.data_ptr(), mu.data_ptr(), rstd.data_ptr(), rows,
        hidden, float(eps), int(rms), _DTYPE_CODES[x2d.dtype], plan.vec,
        plan.per_lane, plan.lanes * plan.warps_per_row, plan.grid,
        dtype=x2d.dtype,
    )
    return y, mu, rstd


def layer_norm_bwd(
    x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mu: torch.Tensor,
    rstd: torch.Tensor, g: torch.Tensor, *, rms: bool, x_is_output: bool,
    block_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K2 on CUDA tensors: ``(dx, dw, db)`` for the saved ``x2d``
    (or the output ``y`` with ``x_is_output``), f32 ``w``/``b`` (hidden,),
    f32 ``mu``/``rstd`` (rows,) and the output gradient ``g`` (rows,
    hidden) in ``x2d``'s dtype.  The kernel's f32 partial rows of dw and
    db (:class:`NormPlan` ``parts``) are summed here with one
    ``torch.sum``, in a fixed order.  ``block_rows`` as
    :func:`layer_norm_fwd`'s."""
    dx, part = _bwd_parts(x2d, w, b, mu, rstd, g, rms=rms,
                          x_is_output=x_is_output, block_rows=block_rows)
    dw, db = part.sum(dim=0)
    return dx, dw, db


def _bwd_parts(x2d, w, b, mu, rstd, g, *, rms, x_is_output, block_rows=None):
    """K2's launch: ``(dx, part)``, ``part`` the f32 (parts, 2, hidden)
    partial rows of dw and db that :func:`layer_norm_bwd` sums."""
    _check_operands("layer_norm_bwd", x2d, w, b, mu, rstd)
    if (g.device != x2d.device or g.shape != x2d.shape
            or g.dtype != x2d.dtype or not g.is_contiguous()):
        raise ValueError(
            f"g must be a contiguous {x2d.dtype} tensor of shape "
            f"{tuple(x2d.shape)} on {x2d.device}, got {g.dtype} "
            f"{tuple(g.shape)} on {g.device}"
        )
    rows, hidden = x2d.shape
    dx = torch.empty_like(x2d)
    if rows == 0:
        return dx, torch.zeros(1, 2, hidden, dtype=torch.float32,
                               device=x2d.device)
    plan = _bwd_plan(x2d, w, b, g, dx, x_is_output=x_is_output,
                     block_rows=block_rows)
    part = torch.empty(plan.parts, 2, hidden, dtype=torch.float32,
                       device=x2d.device)
    _dispatch.launch(
        KERNEL_BWD, _BWD_ARGS, x2d.device, x2d.data_ptr(), w.data_ptr(),
        b.data_ptr(), mu.data_ptr(), rstd.data_ptr(), g.data_ptr(),
        dx.data_ptr(), part.data_ptr(), rows, hidden, int(rms),
        int(x_is_output), _DTYPE_CODES[x2d.dtype], plan.vec, plan.per_lane,
        plan.lanes * plan.warps_per_row, plan.grid, dtype=x2d.dtype,
    )
    return dx, part


class _Norm2d(torch.autograd.Function):
    """LayerNorm / RMSNorm over ``(rows, hidden)``: K1 and K2 on the card,
    the plain twins on the CPU.  Saves ``(x, mu, rstd)``, or ``(y, rstd)``
    with ``memory_efficient`` (``_norm2d_fwd`` of the JAX package)."""

    @staticmethod
    def forward(ctx, x2d, w, b, eps, rms, memory_efficient):
        wf, bf = w.float().contiguous(), b.float().contiguous()
        if _dispatch.on_card(x2d, w, b):
            y, mu, rstd = layer_norm_fwd(x2d.contiguous(), wf, bf,
                                         eps=eps, rms=rms)
        else:
            y, mu, rstd = layer_norm_reference(x2d, wf, bf, eps, rms)
        if memory_efficient:
            ctx.save_for_backward(y, wf, bf, rstd)
        else:
            ctx.save_for_backward(x2d, wf, bf, mu, rstd)
        ctx.rms, ctx.memory_efficient = rms, memory_efficient
        ctx.param_dtypes = (w.dtype, b.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.memory_efficient:
            x_or_y, wf, bf, rstd = ctx.saved_tensors
            mu = torch.zeros_like(rstd)
        else:
            x_or_y, wf, bf, mu, rstd = ctx.saved_tensors
        g = g.to(x_or_y.dtype)
        if _dispatch.on_card(x_or_y, g):
            dx, dw, db = layer_norm_bwd(
                x_or_y.contiguous(), wf, bf, mu, rstd, g.contiguous(),
                rms=ctx.rms, x_is_output=ctx.memory_efficient,
            )
        else:
            dx, dw, db = layer_norm_bwd_reference(
                x_or_y, wf, bf, mu, rstd, g, ctx.rms, ctx.memory_efficient
            )
        w_dtype, b_dtype = ctx.param_dtypes
        return dx, dw.to(w_dtype), db.to(b_dtype), None, None, None


def _run(x, normalized_shape, w: Optional[torch.Tensor],
         b: Optional[torch.Tensor], eps, rms, memory_efficient):
    from apex_tpu_torch.amp.lists import amp_cast

    # under O1 the rows, weight and bias are cast to f32 before the route
    # is chosen: K1/K2 take their f32 instance, and the gradients come
    # back in the caller's dtypes through the casts' backward
    x, w, b = amp_cast("rms_norm" if rms else "layer_norm", x, w, b)
    shape_t = (
        (normalized_shape,)
        if isinstance(normalized_shape, int)
        else tuple(normalized_shape)
    )
    hidden = math.prod(shape_t)
    if tuple(x.shape[-len(shape_t):]) != shape_t:
        raise ValueError(
            f"normalized_shape {normalized_shape} does not match the trailing "
            f"dimensions of input shape {tuple(x.shape)}"
        )
    x2d = x.reshape(-1, hidden)
    w = (torch.ones(hidden, dtype=torch.float32, device=x.device)
         if w is None else w.reshape(hidden))
    b = (torch.zeros(hidden, dtype=torch.float32, device=x.device)
         if b is None else b.reshape(hidden))
    op = "rms_norm" if rms else "layer_norm"
    _dispatch.record_path(op, "cuda" if _dispatch.on_card(x2d, w, b)
                          else "torch")
    y = _Norm2d.apply(x2d, w, b, float(eps), bool(rms),
                      bool(memory_efficient))
    return y.reshape(x.shape)


def fused_layer_norm_affine(x, weight, bias, normalized_shape: Shape,
                            eps: float = 1e-6, memory_efficient: bool = False):
    """≙ apex_tpu.ops.layer_norm.fused_layer_norm_affine."""
    return _run(x, normalized_shape, weight, bias, eps, False,
                memory_efficient)


def fused_layer_norm(x, normalized_shape: Shape, eps: float = 1e-6,
                     memory_efficient: bool = False):
    """Non-affine LayerNorm (≙ fused_layer_norm)."""
    return _run(x, normalized_shape, None, None, eps, False, memory_efficient)


def fused_rms_norm_affine(x, weight, normalized_shape: Shape,
                          eps: float = 1e-6, memory_efficient: bool = False):
    """≙ apex_tpu.ops.layer_norm.fused_rms_norm_affine."""
    return _run(x, normalized_shape, weight, None, eps, True,
                memory_efficient)


def fused_rms_norm(x, normalized_shape: Shape, eps: float = 1e-6,
                   memory_efficient: bool = False):
    """Non-affine RMSNorm (≙ fused_rms_norm)."""
    return _run(x, normalized_shape, None, None, eps, True, memory_efficient)


# ---------------------------------------------------------------------------
# launch plans for the static analysis (apex_tpu_torch.analysis.kernels)
# ---------------------------------------------------------------------------

#: the C entry points whose launches :func:`specs_from_args` describes
SPEC_ENTRIES = (KERNEL, KERNEL_BWD)

_CXX_TYPES = {0: "float", 1: "__nv_bfloat16"}


def _wide_regs(elem: int, vec: int, per_lane: int, bwd: bool) -> int:
    """The registers a thread of the wide-row instance takes, as
    ``csrc/norm_wide.cuh``'s ``WideCfg::kRegs`` estimates them: a lane's
    loaded values (a 16-byte load's four registers, or one per element)
    now and next, and as many f32 registers of w and b (K2: x and g, w,
    b, dw and db), and 24 of addresses and sums."""
    raw = per_lane // vec * -(-(vec * elem) // 4)
    return (4 if bwd else 2) * (raw + per_lane) + 24


def _min_blocks(elem: int, vec: int, per_lane: int, warps: int,
                bwd: bool) -> int:
    """``__launch_bounds__``' CTAs per SM of an instance (the sources'
    ``Cfg<T, kPer>::kCtas``, and ``norm_wide.cuh``'s ``WideCfg::kCtas`` for
    the wide-row instance of ``warps`` warps a row: two CTAs of 8 warps
    where 128 registers a thread hold it)."""
    if warps > 1:
        return 2 if _wide_regs(elem, vec, per_lane, bwd) <= 128 else 1
    nbytes = per_lane * elem
    if bwd:
        return 2 if per_lane == 0 else 4 if nbytes <= 16 else \
            2 if nbytes <= 32 else 1
    return 4 if per_lane == 0 or nbytes <= 32 else 2 if nbytes <= 64 else 1


def _ln_work(rows: int, hidden: int, elem: int, bwd: bool) -> dict:
    """Each input read once, each output written once (x in and y out, or
    x and g in and dx out, with the f32 w, b, mu, rstd, and K2's f32 dw
    and db), and 8 (K1) or 12 (K2) f32 operations a value."""
    n = rows * hidden
    if bwd:
        nbytes = 3 * n * elem + 4 * hidden * 4 + 2 * rows * 4
    else:
        nbytes = 2 * n * elem + 2 * hidden * 4 + 2 * rows * 4
    return {"bytes": nbytes, "ops": (12 if bwd else 8) * n, "peak": "f32"}


def _ln_spec(entry, rows, hidden, dtype_code, vec, per_lane, lanes, grid):
    """The spec of one launch; ``lanes`` is the C argument, the row's
    threads (above 32: the wide-row instance's warps)."""
    from apex_tpu_torch.ops.introspect import KernelSpec

    bwd = entry == KERNEL_BWD
    elem = 4 if dtype_code == 0 else 2
    warps = max(1, lanes // 32)
    lanes = min(lanes, 32)
    name = "ln_bwd" if bwd else "ln_fwd"
    per_cta = NORM_WARPS * (32 // lanes) // warps
    return KernelSpec(
        name=f"{name}_wide_kernel" if warps > 1 else f"{name}_kernel",
        entry=entry,
        instance=(f"<{_CXX_TYPES[dtype_code]}, {vec}, {per_lane}"
                  + (f", {warps}>" if warps > 1 else ">")),
        grid=int(grid), threads=32 * NORM_WARPS, smem_bytes=0,
        min_blocks=_min_blocks(elem, vec, per_lane, warps, bwd),
        dtype="float32" if dtype_code == 0 else "bfloat16",
        tile={"rows_per_warp": 32 // lanes, "lanes": lanes,
              "warps_per_row": warps, "per_lane": per_lane, "vec": vec,
              "hidden": hidden},
        items={"n_items": -(-rows // per_cta), "per_cta": "persistent"},
        writes=("dx", "dw_part", "db_part") if bwd else ("y", "mu", "rstd"),
        work=_ln_work(rows, hidden, elem, bwd))


def specs_from_args(entry: str, args: tuple, defines=()) -> list:
    """The specs of one recorded launch of K1 or K2 (C argument order,
    pointers as :func:`~apex_tpu_torch.ops.introspect.pointer_class`)."""
    if entry == KERNEL:
        rows, hidden, _eps, _rms, dtype, vec, per_lane, lanes, grid = args[6:15]
    else:
        rows, hidden, _rms, _xo, dtype, vec, per_lane, lanes, grid = args[8:17]
    return [_ln_spec(entry, rows, hidden, dtype, vec, per_lane, lanes, grid)]


def kernel_specs(rows: int, hidden: int, dtype=torch.bfloat16, *,
                 bwd: bool = False, sms: int = 132, ctas_per_sm: int = 8,
                 aligned: bool = True, block_rows: Optional[int] = None) -> list:
    """The :class:`~apex_tpu_torch.ops.introspect.KernelSpec` of K1 (or K2
    with ``bwd``) on ``rows`` x ``hidden`` rows of ``dtype``, planned by
    :func:`norm_launch_plan` on a card of ``sms`` SMs where the instance
    keeps ``ctas_per_sm`` CTAs resident (the occupancy calculator's count
    on the card)."""
    elem = torch.empty((), dtype=dtype).element_size()
    plan = norm_launch_plan(rows, hidden, elem, sms=sms,
                            ctas_per_sm=lambda *instance: ctas_per_sm,
                            aligned=aligned, bwd=bwd, block_rows=block_rows)
    return [_ln_spec(KERNEL_BWD if bwd else KERNEL, rows, hidden,
                     _DTYPE_CODES[dtype], plan.vec, plan.per_lane,
                     plan.lanes * plan.warps_per_row, plan.grid)]

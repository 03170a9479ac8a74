"""Cross-tensor reductions over lists of tensors — the ``multi_tensor_apply``
analog.

Counterpart of ``apex_tpu/optimizers/multi_tensor.py``: the global and
per-tensor L2 norms (``multi_tensor_l2norm``), scaling with a fused
inf/nan flag (``multi_tensor_scale`` and its ``noop_flag``) and
``a*x + b*y`` (``multi_tensor_axpby``), accumulated in f32.  Each takes
a list (or tuple) of tensors or a dict of them and returns the same
kind; the reductions use ``torch._foreach_*`` so that one call covers
every tensor, and every result stays on the device (no host sync).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "axpby",
    "global_norm",
    "per_tensor_norm",
    "scale_with_overflow_check",
]

Tensors = Union[Sequence[torch.Tensor], Mapping[str, torch.Tensor]]


def _split(tree: Tensors) -> Tuple[Optional[List[str]], List[torch.Tensor]]:
    if isinstance(tree, Mapping):
        return list(tree), list(tree.values())
    return None, list(tree)


def _join(keys: Optional[List[str]], values: List[torch.Tensor]
          ) -> Union[List[torch.Tensor], Dict[str, torch.Tensor]]:
    return values if keys is None else dict(zip(keys, values))


def _norms(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    return torch._foreach_norm([t.float() for t in tensors], 2)


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt(sum of ||t||^2) over every tensor, in f32 (a 0-dim tensor on
    the tensors' device; 0 for no tensors)."""
    _, tensors = _split(tree)
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(_norms(tensors)))


def per_tensor_norm(tree: Tensors):
    """||t||_2 of each tensor as f32 0-dim tensors, in the input's
    container (the LAMB trust-ratio input)."""
    keys, tensors = _split(tree)
    return _join(keys, list(_norms(tensors)) if tensors else [])


def scale_with_overflow_check(tree: Tensors, scale,
                              out_dtype: Optional[torch.dtype] = None):
    """``(t * scale for each t, found_inf)``: each output in ``out_dtype``
    (default: its input's dtype) and ``found_inf`` an f32 0-dim tensor,
    1.0 when any input holds an inf or nan."""
    keys, tensors = _split(tree)
    if not tensors:
        return _join(keys, []), torch.zeros((), dtype=torch.float32)
    xf = [t.float() for t in tensors]
    finite = torch.stack([torch.isfinite(x).all() for x in xf])
    found_inf = (~finite).any().float()
    scaled = torch._foreach_mul(xf, scale)
    out = [y.to(out_dtype or t.dtype) for y, t in zip(scaled, tensors)]
    return _join(keys, out), found_inf


def axpby(a, x_tree: Tensors, b, y_tree: Tensors,
          out_dtype: Optional[torch.dtype] = None):
    """``a*x + b*y`` tensor by tensor in f32, each cast to ``out_dtype``
    (default: x's dtype)."""
    keys, xs = _split(x_tree)
    _, ys = _split(y_tree)
    out = torch._foreach_add(torch._foreach_mul([x.float() for x in xs], a),
                             torch._foreach_mul([y.float() for y in ys], b))
    return _join(keys, [o.to(out_dtype or x.dtype) for o, x in zip(out, xs)])

"""Weight-norm reparameterization — counterpart of
:mod:`apex_tpu.reparameterization` (≙ ``apex/reparameterization/`` ::
``WeightNorm``, ``Reparameterization.apply``).

``w = g · v / ‖v‖``, the norm taken in f32 over every axis but ``dim``
(the axis kept per unit).  The port's weights are PyTorch's ``(out, in)``,
so ``dim=0`` is the default here where the reference's ``(in, out)``
kernels use ``dim=-1``; both keep one norm per output unit.

- :func:`compute_weight` — the formula;
- :func:`apply_weight_norm` / :func:`remove_weight_norm` — split every
  parameter called ``name`` into ``name_g`` (the norm) and ``name_v``
  (the direction), and merge them back.  On a state dict (flat with
  dotted keys, or nested dicts) they are the reference's checkpoint
  transforms; on an ``nn.Module`` they replace the parameters in place
  and recompute ``name`` before every forward, as torch's
  ``weight_norm`` hook does.  ``remove(apply(p))`` gives back ``p``
  within one ulp;
- :class:`WeightNorm` — a wrapper module that normalizes a child's
  ``name`` parameters at call time, ``v · rsqrt(Σv² + ε) · scale``
  (flax's ``WeightNorm``, which the reference wraps), with its scales
  under the reference's keys (``WeightNorm_0.layer/<path>/scale``);
- :func:`to_wrapper_params` — a plain layer's state dict in the
  wrapper's layout, with ``scale = ‖w‖`` so the wrapped module first
  computes exactly ``w``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional

import torch
from torch import nn

__all__ = [
    "WeightNorm",
    "apply_weight_norm",
    "remove_weight_norm",
    "to_wrapper_params",
    "compute_weight",
]


def _norm_keepdims(v: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """‖v‖₂ in f32 over every axis except ``dim`` (torch's ``_norm``)."""
    v32 = v.float()
    if dim is None:
        return v32.square().sum().sqrt()
    axes = tuple(a for a in range(v32.ndim) if a != dim % v32.ndim)
    return v32.square().sum(dim=axes, keepdim=True).sqrt()


def compute_weight(g: torch.Tensor, v: torch.Tensor,
                   dim: Optional[int] = 0) -> torch.Tensor:
    """``w = g · v / ‖v‖`` in f32, returned in ``v``'s dtype (≙
    ``Reparameterization.compute_weight``).  A feature-shaped ``g`` (one
    value per unit) broadcasts along ``dim``."""
    g32 = g.float()
    if dim is not None and g32.ndim != v.ndim:
        shape = [1] * v.ndim
        shape[dim % v.ndim] = v.shape[dim % v.ndim]
        g32 = g32.reshape(shape)
    return (g32 * v.float() / _norm_keepdims(v, dim)).to(v.dtype)


class _Recompute:
    """The forward pre-hook of a module under weight norm."""

    def __init__(self, name: str, dim: Optional[int]):
        self.name, self.dim = name, dim

    def __call__(self, module, _inputs):
        setattr(module, self.name, compute_weight(
            getattr(module, f"{self.name}_g"),
            getattr(module, f"{self.name}_v"), self.dim))


def _apply_module(module: nn.Module, name: str, dim: Optional[int]):
    for sub in module.modules():
        w = sub._parameters.get(name)
        if w is None:
            continue
        del sub._parameters[name]
        sub.register_parameter(f"{name}_g", nn.Parameter(
            _norm_keepdims(w.detach(), dim).to(w.dtype)))
        sub.register_parameter(f"{name}_v", nn.Parameter(w.detach()))
        hook = _Recompute(name, dim)
        hook(sub, ())
        handles = sub.__dict__.setdefault("_weight_norm_hooks", {})
        handles[name] = sub.register_forward_pre_hook(hook)
    return module


def _remove_module(module: nn.Module, name: str):
    for sub in module.modules():
        handles = sub.__dict__.get("_weight_norm_hooks", {})
        if name not in handles:
            continue
        hook = handles.pop(name)
        dim = next(h.dim for h in sub._forward_pre_hooks.values()
                   if isinstance(h, _Recompute) and h.name == name)
        hook.remove()
        w = compute_weight(getattr(sub, f"{name}_g"),
                           getattr(sub, f"{name}_v"), dim).detach()
        del sub._parameters[f"{name}_g"], sub._parameters[f"{name}_v"]
        if name in sub.__dict__:
            del sub.__dict__[name]
        sub.register_parameter(name, nn.Parameter(w))
    return module


def _leaf_name(key: str) -> str:
    return key.rsplit(".", 1)[-1]


def apply_weight_norm(params: Any, name: str = "weight",
                      dim: Optional[int] = 0) -> Any:
    """Split every ``name`` parameter into ``name_g`` and ``name_v`` (≙
    torch's ``apply_weight_norm(module, name, dim)``).  ``params`` is a
    module (changed in place and returned) or a state dict (a new dict
    is returned; its tensors are the input's, ``name_v`` is ``w``
    itself)."""
    if isinstance(params, nn.Module):
        return _apply_module(params, name, dim)
    if not isinstance(params, Mapping):
        return params
    out = {}
    for key, sub in params.items():
        if _leaf_name(key) == name and isinstance(sub, torch.Tensor):
            stem = key[: len(key) - len(name)]
            out[f"{stem}{name}_g"] = _norm_keepdims(sub, dim).to(sub.dtype)
            out[f"{stem}{name}_v"] = sub
        else:
            out[key] = apply_weight_norm(sub, name, dim)
    return out


def remove_weight_norm(params: Any, name: str = "weight",
                       dim: Optional[int] = 0) -> Any:
    """The inverse of :func:`apply_weight_norm` (≙ torch's
    ``remove_weight_norm``).  On a module the hook remembers its own
    ``dim``."""
    if isinstance(params, nn.Module):
        return _remove_module(params, name)
    if not isinstance(params, Mapping):
        return params
    out = {}
    for key, sub in params.items():
        leaf = _leaf_name(key)
        stem = key[: len(key) - len(leaf)]
        if leaf == f"{name}_v" and f"{stem}{name}_g" in params:
            out[f"{stem}{name}"] = compute_weight(
                params[f"{stem}{name}_g"], sub, dim)
        elif leaf == f"{name}_g" and f"{stem}{name}_v" in params:
            continue
        else:
            out[key] = remove_weight_norm(sub, name, dim)
    return out


def _scale_key(path: str) -> str:
    return "layer/" + path.replace(".", "/") + "/scale"


def to_wrapper_params(plain_params: Mapping, name: str = "weight",
                      dim: Optional[int] = 0) -> Dict[str, torch.Tensor]:
    """A plain layer's state dict -> the :class:`WeightNorm` wrapper's:
    every key moves under ``layer.``, and each ``name`` parameter ``w``
    gets the scale ``‖w‖`` (one value per unit of ``dim``, flattened)
    under ``WeightNorm_0.layer/<path>/scale``.  The wrapper keeps ``w``
    as its direction, so it first computes exactly ``w`` (up to the
    epsilon under the norm)."""
    out = {f"layer.{k}": v for k, v in plain_params.items()}
    for key, w in plain_params.items():
        if _leaf_name(key) == name and isinstance(w, torch.Tensor):
            out[f"WeightNorm_0.{_scale_key(key)}"] = torch.ravel(
                _norm_keepdims(w, dim)).to(w.dtype)
    return out


class WeightNorm(nn.Module):
    """``w = scale · v · rsqrt(Σv² + epsilon)`` for the ``name``
    parameters of ``layer`` (the sum over every axis but ``dim``; all of
    them with ``dim=None`` and a scalar scale), computed at each call —
    the reference's wrapper over flax's ``WeightNorm``.  ``layer``'s own
    parameter is the direction ``v``; the scales start at 1 (flax's
    ``scale_init``), or load through :func:`to_wrapper_params`."""

    def __init__(self, layer: nn.Module, dim: Optional[int] = 0,
                 epsilon: float = 1e-12, name: str = "weight"):
        super().__init__()
        self.layer, self.dim, self.epsilon, self.name = \
            layer, dim, epsilon, name
        self.WeightNorm_0 = nn.ParameterDict()
        for path, p in layer.named_parameters():
            if name in path:
                shape = () if dim is None else (p.shape[dim],)
                self.WeightNorm_0[_scale_key(path)] = nn.Parameter(
                    torch.ones(shape, dtype=torch.float32, device=p.device))

    def _normalized(self, path: str, v: torch.Tensor) -> torch.Tensor:
        scale = self.WeightNorm_0[_scale_key(path)]
        if self.dim is None:
            axes = tuple(range(v.ndim))
            shape = [1] * v.ndim
        else:
            d = self.dim % v.ndim
            axes = tuple(a for a in range(v.ndim) if a != d)
            shape = [1] * v.ndim
            shape[d] = v.shape[d]
        v32 = v.float()
        bar = v32 * torch.rsqrt((v32 * v32).sum(dim=axes, keepdim=True)
                                + self.epsilon)
        out = bar * scale.reshape(shape)
        return out.to(torch.promote_types(v.dtype, scale.dtype))

    def forward(self, *args, **kwargs):
        weights = {path: self._normalized(path, p)
                   for path, p in self.layer.named_parameters()
                   if self.name in path}
        return torch.func.functional_call(self.layer, weights, args, kwargs)

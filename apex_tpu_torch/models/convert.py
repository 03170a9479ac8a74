"""Carry weights across between a JAX ``GptModel.init`` tree and the port.

The JAX parameter tree (as numpy arrays, e.g. ``jax.tree.map(np.asarray,
params)``) has the scanned stack's leaves under
``params["params"]["layers"]["block"]`` with a leading ``num_layers``
axis; they are split per layer here, and stacked again on the way back.
Flax ``Dense`` kernels are ``(in, out)`` and ``nn.Linear`` weights ``(out,
in)``: this module is the one place the layout changes.  The fused QKV
output keeps its ``(heads, 3, head_dim)`` column order, so nothing is
permuted beyond the transpose.  Both trees hold f32, so the weights
cross exactly in both directions.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GptConfig, GptModel

__all__ = ["from_jax_params", "to_jax_params"]

_LINEARS = ("qkv", "out", "fc1", "fc2")
_NORMS = ("ln_attn", "ln_mlp")


def _state_dict_from_jax(params_np: Mapping, cfg: GptConfig) -> dict:
    """The port's ``state_dict`` (f32 CPU tensors) for a JAX param tree."""
    tree = params_np["params"]
    block = tree["layers"]["block"]

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {"word_embeddings.weight": t(tree["word_embeddings"]["weight"])}
    if not cfg.rotary:
        sd["position_embeddings"] = t(tree["position_embeddings"])
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        for name in _LINEARS:
            sd[pre + name + ".weight"] = t(block[name]["weight"][i]).T.contiguous()
            sd[pre + name + ".bias"] = t(block[name]["bias"][i])
        for name in _NORMS:
            sd[pre + name + ".scale"] = t(block[name]["scale"][i])
            sd[pre + name + ".bias"] = t(block[name]["bias"][i])
    sd["ln_f.scale"] = t(tree["ln_f"]["scale"])
    sd["ln_f.bias"] = t(tree["ln_f"]["bias"])
    return sd


def from_jax_params(params_np: Mapping, cfg: GptConfig, *,
                    device="cuda") -> GptModel:
    """A :class:`GptModel` on ``device`` holding the JAX tree's f32
    weights exactly."""
    model = GptModel(cfg, device=device)
    model.load_state_dict(_state_dict_from_jax(params_np, cfg), strict=True)
    return model


def to_jax_params(model: GptModel,
                  tensors: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """The inverse of :func:`from_jax_params`: a JAX-shaped tree of f32
    numpy arrays (``{"params": {...}}``, the stack's leaves stacked on a
    leading layer axis, kernels ``(in, out)``).  ``tensors`` maps the
    model's parameter names to the tensors to lay out (for example each
    parameter's ``.grad``); by default the parameters themselves."""
    cfg = model.cfg
    if tensors is None:
        tensors = dict(model.named_parameters())

    def a(name):
        return tensors[name].detach().float().cpu().numpy()

    def stacked(leaf, transpose=False):
        rows = [a(f"layers.{i}.{leaf}") for i in range(cfg.num_layers)]
        return np.stack([r.T if transpose else r for r in rows])

    block = {
        name: {"weight": stacked(f"{name}.weight", transpose=True),
               "bias": stacked(f"{name}.bias")}
        for name in _LINEARS
    }
    for name in _NORMS:
        block[name] = {"scale": stacked(f"{name}.scale"),
                       "bias": stacked(f"{name}.bias")}
    tree = {
        "word_embeddings": {"weight": a("word_embeddings.weight")},
        "layers": {"block": block},
        "ln_f": {"scale": a("ln_f.scale"), "bias": a("ln_f.bias")},
    }
    if not cfg.rotary:
        tree["position_embeddings"] = a("position_embeddings")
    return {"params": tree}

"""Carry weights across between JAX parameter trees and the port.

GPT: the JAX ``GptModel.init`` tree (as numpy arrays, e.g.
``jax.tree.map(np.asarray, params)``) has the scanned stack's leaves
under ``params["params"]["layers"]["block"]`` with a leading
``num_layers`` axis; they are split per layer here, and stacked again on
the way back.

BERT: the JAX ``BertForPreTraining.init`` tree comes in two layouts,
both read and written here — scanned (``scan_layers=True``, the
default: ``bert/encoder/layers/layer/...`` with a leading layer axis)
and unrolled (``bert/encoder/layer_<i>/layer/...``, what
``bench.py::bench_bert_lamb`` builds).

The tensor-parallel layers' ``weight`` and flax ``Dense``'s ``kernel``
are both ``(in, out)``, ``nn.Linear`` weights ``(out, in)``: this module
is the one place the layout changes.  The fused QKV output keeps its
``(heads, 3, head_dim)`` column order, so nothing is permuted beyond the
transpose.  Both sides hold f32, so the weights cross exactly in both
directions.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from apex_tpu_torch.models.bert import BertConfig, BertForPreTraining
from apex_tpu_torch.models.gpt import GptConfig, GptModel

__all__ = [
    "bert_from_jax_params",
    "bert_to_jax_params",
    "from_jax_params",
    "to_jax_params",
]

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


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

#: per-layer leaves: (port name below ``bert.encoder.layers.<i>.``, JAX
#: path below the layer, is an (in, out) matrix)
_BERT_LAYER_LEAVES = tuple(
    (f"{mod}.{leaf}", (*mod.split("."), jleaf), leaf == "weight")
    for mod in ("attention.qkv", "attention.out", "mlp.fc1", "mlp.fc2")
    for leaf, jleaf in (("weight", "weight"), ("bias", "bias"))
) + tuple(
    (f"{ln}.{leaf}", (ln, leaf), False)
    for ln in ("ln_attn", "ln_mlp") for leaf in ("scale", "bias")
)


def _bert_leaves(cfg: BertConfig):
    """(port name, JAX path below ``params``, is an (in, out) matrix) of
    every non-layer parameter."""
    emb = ("bert", "embeddings")
    leaves = [
        ("bert.embeddings.word_embeddings.weight",
         emb + ("word_embeddings", "weight"), False),
        ("bert.embeddings.position_embeddings",
         emb + ("position_embeddings",), False),
        ("bert.embeddings.ln.scale", emb + ("ln", "scale"), False),
        ("bert.embeddings.ln.bias", emb + ("ln", "bias"), False),
        ("mlm_ln.scale", ("mlm_ln", "scale"), False),
        ("mlm_ln.bias", ("mlm_ln", "bias"), False),
        ("mlm_bias", ("mlm_bias",), False),
    ]
    if cfg.type_vocab_size:
        leaves.append(("bert.embeddings.token_type_embeddings",
                       emb + ("token_type_embeddings",), False))
    for dense in ("pooler", "nsp_head", "mlm_dense"):
        leaves.append((f"{dense}.weight", (dense, "kernel"), True))
        leaves.append((f"{dense}.bias", (dense, "bias"), False))
    return leaves


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def bert_from_jax_params(params_np: Mapping, cfg: BertConfig, *,
                         device="cuda") -> BertForPreTraining:
    """A :class:`BertForPreTraining` on ``device`` holding the JAX tree's
    f32 weights exactly; the tree may be scanned or unrolled."""
    model = BertForPreTraining(cfg, device=device)
    tree = params_np["params"]
    encoder = tree["bert"]["encoder"]

    def t(a, transpose):
        out = torch.from_numpy(np.array(a, dtype=np.float32))
        return out.T.contiguous() if transpose else out

    sd = {name: t(_get(tree, path), tr) for name, path, tr in _bert_leaves(cfg)}
    for i in range(cfg.num_layers):
        for name, path, tr in _BERT_LAYER_LEAVES:
            if "layers" in encoder:
                leaf = _get(encoder["layers"]["layer"], path)[i]
            else:
                leaf = _get(encoder[f"layer_{i}"]["layer"], path)
            sd[f"bert.encoder.layers.{i}.{name}"] = t(leaf, tr)
    model.load_state_dict(sd, strict=True)
    return model


def bert_to_jax_params(model: BertForPreTraining,
                       tensors: Optional[Mapping[str, torch.Tensor]] = None,
                       *, scan_layers: Optional[bool] = None) -> dict:
    """The inverse of :func:`bert_from_jax_params`: a JAX-shaped tree of
    f32 numpy arrays, scanned (the layer leaves stacked on a leading
    axis) or unrolled, as ``scan_layers`` says (default:
    ``model.cfg.scan_layers``).  ``tensors`` maps the model's parameter
    names to the tensors to lay out (for example each parameter's
    ``.grad``); by default the parameters themselves."""
    cfg = model.cfg
    if scan_layers is None:
        scan_layers = cfg.scan_layers
    if tensors is None:
        tensors = dict(model.named_parameters())

    def a(name, transpose):
        out = tensors[name].detach().float().cpu().numpy()
        return out.T if transpose else out

    tree: dict = {}
    for name, path, tr in _bert_leaves(cfg):
        _put(tree, path, a(name, tr))
    encoder = tree["bert"].setdefault("encoder", {})
    for name, path, tr in _BERT_LAYER_LEAVES:
        rows = [a(f"bert.encoder.layers.{i}.{name}", tr)
                for i in range(cfg.num_layers)]
        if scan_layers:
            _put(encoder, ("layers", "layer") + path, np.stack(rows))
        else:
            for i, row in enumerate(rows):
                _put(encoder, (f"layer_{i}", "layer") + path, row)
    return {"params": tree}

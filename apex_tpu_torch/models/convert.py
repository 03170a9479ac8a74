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

Optimizer state: the JAX ``fused_lamb`` / ``fused_adam`` states
(``count`` and the moments ``m``, ``v``, trees of the params' layout)
convert through the same leaf mapping into the port's
:class:`FusedLAMBState` / :class:`FusedAdamState`, and
:func:`load_optimizer_state` puts either into a stateful
:class:`FusedLAMB` / :class:`FusedAdam`, so a JAX training state
restored to numpy continues in the port.

OpenFold (``apex_tpu_torch.contrib.openfold``): the JAX module tree of
any ported evoformer module (``Module.init`` of ``EvoformerBlock``,
``TriangleAttention``, ``DAPAxialBlock``, ...) maps name for name onto
the port's module: a Flax ``Dense`` ``kernel`` (in, out) and ``bias`` are
an ``nn.Linear``'s ``weight`` (out, in) and ``bias``, and the
module-level LayerNorm leaves ``<name>_scale``/``<name>_bias`` are
parameters of the same names.

Experts: a GPT with ``num_experts`` holds, per layer, ``moe/router`` (H,
E) and the stacked ``moe/expert_w1`` (E, H, F) / ``moe/expert_w2`` (E,
F, H) in place of ``fc1``/``fc2``; they cross as they are (no
transpose), the experts sliced to this dp rank's ``E / ep`` on the way
in; on the way out a rank's tree holds its own expert shard.  A GPT
under context parallelism holds the unsharded tree.

Pipeline stages (:mod:`apex_tpu_torch.examples.train_gpt_pp`): a JAX
stage tree ``{"core": BertEncoderCore.init(...), "embed": (V, H),
"is_chunk0": ()}`` (each leaf stacked on a leading chunk axis under
interleaving) turns into the port's ``{"core": {"layers/<i>/...":
...}, "embed", "is_chunk0"}`` (:func:`pipeline_stage_from_jax`, the
core's names those of ``module_params(BertEncoderCore)``) and back
(:func:`pipeline_stage_to_jax`).

Tensor parallelism: :func:`tp_shard_jax_params` cuts a full JAX tree
into rank ``r``'s shard in the reference's layout (what each device of
a ``tp``-axis ``shard_map`` holds: the column-parallel kernels and
biases split along their output dim, the row-parallel kernels along
their input dim, the word embedding and ``mlm_bias`` along the vocab);
:func:`from_jax_params` and :func:`bert_from_jax_params` load this
process's shard when the tp group has more than one rank.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.models.bert import BertConfig, BertForPreTraining
from apex_tpu_torch.models.gpt import GptConfig, GptModel
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import FusedAdamState, FusedLAMBState

__all__ = [
    "adam_state_from_jax",
    "bert_from_jax_params",
    "bert_lamb_state_from_jax",
    "bert_to_jax_params",
    "evoformer_from_jax_params",
    "evoformer_to_jax_params",
    "from_jax_params",
    "gpt_param_tree",
    "load_optimizer_state",
    "optimizer_state",
    "params_from_numpy",
    "pipeline_stage_from_jax",
    "pipeline_stage_to_jax",
    "params_to_numpy",
    "to_jax_params",
    "tp_shard_jax_params",
]

_LINEARS = ("qkv", "out", "fc1", "fc2")
_NORMS = ("ln_attn", "ln_mlp")
_MOE = ("router", "expert_w1", "expert_w2")


def _host_f32(t: torch.Tensor) -> np.ndarray:
    """``t`` as an f32 numpy array: the converters' one read off the
    card (an export, not a step)."""
    return t.detach().float().cpu().numpy()  # lint: allow(host-sync): export


def _linears(cfg: GptConfig):
    return _LINEARS[:2] if cfg.num_experts else _LINEARS


def _expert_rows(a, cfg: GptConfig):
    """This dp (= ep) rank's experts of a stacked (E, ...) leaf."""
    ep = ps.axis_size(ps.EXPERT_PARALLEL_AXIS)
    n = cfg.num_experts // ep
    r = ps.axis_rank(ps.EXPERT_PARALLEL_AXIS)
    return a[r * n:(r + 1) * n]


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
        for name in _linears(cfg):
            sd[pre + name + ".weight"] = t(block[name]["weight"][i]).T.contiguous()
            sd[pre + name + ".bias"] = t(block[name]["bias"][i])
        if cfg.num_experts:
            moe = block["moe"]
            sd[pre + "moe.router"] = t(moe["router"][i])
            for name in _MOE[1:]:
                sd[pre + "moe." + name] = t(_expert_rows(moe[name][i], cfg))
        for name in _NORMS:
            sd[pre + name + ".scale"] = t(block[name]["scale"][i])
            sd[pre + name + ".bias"] = t(block[name]["bias"][i])
    sd["ln_f.scale"] = t(tree["ln_f"]["scale"])
    sd["ln_f.bias"] = t(tree["ln_f"]["bias"])
    return sd


#: the sharded dim of each tensor-parallel leaf, by (module, leaf) name:
#: column-parallel outputs, row-parallel inputs, vocab rows
_TP_AXES = {("qkv", "weight"): -1, ("qkv", "bias"): -1,
            ("fc1", "weight"): -1, ("fc1", "bias"): -1,
            ("out", "weight"): -2, ("fc2", "weight"): -2,
            ("word_embeddings", "weight"): -2}


def tp_shard_jax_params(params_np: Mapping, rank: int, tp: int) -> dict:
    """Rank ``rank``'s shard, at tensor parallelism ``tp``, of a full
    JAX GPT or BERT tree of numpy arrays (scanned or unrolled), in the
    reference's layout.  Replicated leaves come back whole."""

    def walk(tree, path):
        if isinstance(tree, Mapping):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        axis = _TP_AXES.get(path[-2:])
        if path[-1:] == ("mlm_bias",):
            axis = -1
        if axis is None or tp == 1:
            return tree
        a = np.asarray(tree)
        n = a.shape[axis] // tp
        if n * tp != a.shape[axis]:
            raise ValueError(f"{'/'.join(path)}: dim {a.shape[axis]} is not "
                             f"divisible by tp={tp}")
        return np.take(a, np.arange(rank * n, (rank + 1) * n), axis=axis)

    return walk(params_np, ())


def _this_rank(params_np: Mapping) -> Mapping:
    tp = ps.axis_size(ps.TENSOR_PARALLEL_AXIS)
    if tp == 1:
        return params_np
    return tp_shard_jax_params(params_np,
                               ps.axis_rank(ps.TENSOR_PARALLEL_AXIS), tp)


def from_jax_params(params_np: Mapping, cfg: GptConfig, *,
                    device="cuda") -> GptModel:
    """A :class:`GptModel` on ``device`` holding the JAX tree's f32
    weights exactly (this rank's shard of them at tp > 1)."""
    model = GptModel(cfg, device=device)
    model.load_state_dict(_state_dict_from_jax(_this_rank(params_np), cfg),
                          strict=True)
    return model


def gpt_param_tree(model: GptModel,
                   tensors: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> dict:
    """The JAX ``GptModel.init`` layout of the model's tensors, as torch
    tensors where they lie (``{"params": {...}}``, the stack's leaves
    stacked on a leading layer axis, kernels ``(in, out)``).  ``tensors``
    maps the model's parameter names to the tensors to lay out (for
    example each parameter's ``.grad``); by default the parameters
    themselves, detached."""
    cfg = model.cfg
    if tensors is None:
        tensors = dict(model.named_parameters())

    def a(name):
        return tensors[name].detach()

    def stacked(leaf, transpose=False):
        rows = [a(f"layers.{i}.{leaf}") for i in range(cfg.num_layers)]
        return torch.stack([r.t() if transpose else r for r in rows])

    block = {
        name: {"weight": stacked(f"{name}.weight", transpose=True),
               "bias": stacked(f"{name}.bias")}
        for name in _linears(cfg)
    }
    if cfg.num_experts:
        block["moe"] = {name: stacked(f"moe.{name}") for name in _MOE}
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


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree_np: Mapping, *, device="cuda") -> dict:
    """A JAX param tree held as numpy (nested dicts of arrays: the
    trainer demo's, an evoformer's, under DAP or not) as the port's
    nested dict of f32 tensors on ``device`` (the card by default), the
    same keys at every level; the trainer's ``params``."""
    dev = resolve_device(device)
    return _tree_map(lambda a: torch.as_tensor(
        np.asarray(a, np.float32)).to(dev), tree_np)


def params_to_numpy(tree: Mapping) -> dict:
    """The inverse of :func:`params_from_numpy`: f32 numpy arrays."""
    return _tree_map(_host_f32, tree)


def to_jax_params(model: GptModel,
                  tensors: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """The inverse of :func:`from_jax_params`: a JAX-shaped tree of f32
    numpy arrays (:func:`gpt_param_tree` on the host)."""
    return _tree_map(_host_f32, gpt_param_tree(model, tensors))


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


def _bert_state_dict_from_jax(params_np: Mapping, cfg: BertConfig) -> dict:
    """The port's ``state_dict`` (f32 CPU tensors) for a JAX BERT tree,
    scanned or unrolled: the parameters, or any tree of their layout (the
    LAMB moments)."""
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
    return sd


def bert_from_jax_params(params_np: Mapping, cfg: BertConfig, *,
                         device="cuda") -> BertForPreTraining:
    """A :class:`BertForPreTraining` on ``device`` holding the JAX tree's
    f32 weights exactly (this rank's shard of them at tp > 1); the tree
    may be scanned or unrolled."""
    model = BertForPreTraining(cfg, device=device)
    model.load_state_dict(
        _bert_state_dict_from_jax(_this_rank(params_np), cfg), strict=True)
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
        out = _host_f32(tensors[name])
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


# ---------------------------------------------------------------------------
# pipeline stages (BertEncoderCore chunks, the tied embedding)
# ---------------------------------------------------------------------------


def _core_from_jax(core_np: Mapping, num_layers: int) -> dict:
    layer = core_np["params"]["layers"]["layer"]
    out = {}
    for i in range(num_layers):
        for name, path, tr in _BERT_LAYER_LEAVES:
            a = torch.from_numpy(np.array(_get(layer, path)[i],
                                          dtype=np.float32))
            out[f"layers/{i}/" + name.replace(".", "/")] = (
                a.T.contiguous() if tr else a)
    return out


def _core_to_jax(core: Mapping, num_layers: int) -> dict:
    layer: dict = {}
    for name, path, tr in _BERT_LAYER_LEAVES:
        rows = []
        for i in range(num_layers):
            a = core[f"layers/{i}/" + name.replace(".", "/")]
            a = _host_f32(a)
            rows.append(a.T if tr else a)
        _put(layer, path, np.stack(rows))
    return {"params": {"layers": {"layer": layer}}}


def pipeline_stage_from_jax(tree_np: Mapping, num_layers: int, *,
                            num_chunks: Optional[int] = None,
                            device="cuda") -> dict:
    """A JAX pipeline stage tree of numpy arrays (``core``, ``embed``,
    ``is_chunk0``; with ``num_chunks`` every leaf stacked on a leading
    chunk axis) as the port's stage params on ``device``: ``core`` keyed
    as ``module_params(BertEncoderCore(cfg, num_layers))``, weights
    ``(out, in)``."""
    dev = resolve_device(device)

    def one(t):
        return {"core": _core_from_jax(t["core"], num_layers),
                "embed": torch.from_numpy(np.array(t["embed"], np.float32)),
                "is_chunk0": torch.tensor(float(np.asarray(t["is_chunk0"])))}

    if num_chunks is None:
        tree = one(tree_np)
    else:
        chunks = [one(_tree_map(lambda a, c=c: np.asarray(a)[c], tree_np))
                  for c in range(num_chunks)]
        tree = {"core": {k: torch.stack([c["core"][k] for c in chunks])
                         for k in chunks[0]["core"]},
                "embed": torch.stack([c["embed"] for c in chunks]),
                "is_chunk0": torch.stack([c["is_chunk0"] for c in chunks])}
    return _tree_map(lambda t: t.to(dev), tree)


def pipeline_stage_to_jax(tree: Mapping, num_layers: int, *,
                          num_chunks: Optional[int] = None) -> dict:
    """The inverse of :func:`pipeline_stage_from_jax`: f32 numpy arrays
    in the JAX stage layout (stacked on the chunk axis with
    ``num_chunks``)."""
    def one(t):
        return {"core": _core_to_jax(t["core"], num_layers),
                "embed": _host_f32(t["embed"]),
                "is_chunk0": _host_f32(t["is_chunk0"])}

    if num_chunks is None:
        return one(tree)
    chunks = [one(_tree_map(lambda a, c=c: a[c], tree))
              for c in range(num_chunks)]
    return _tree_map_many(lambda *xs: np.stack(xs), chunks)


def _tree_map_many(fn, trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _tree_map_many(fn, [t[k] for t in trees]) for k in first}
    return fn(*trees)


# ---------------------------------------------------------------------------
# OpenFold evoformer modules
# ---------------------------------------------------------------------------


def _evoformer_leaves(module: torch.nn.Module):
    """(port name, JAX path below ``params``, is an (in, out) matrix) of
    every parameter of ``module``."""
    linears = {name for name, mod in module.named_modules()
               if isinstance(mod, torch.nn.Linear)}
    for name, _ in module.named_parameters():
        parent, _, leaf = name.rpartition(".")
        if parent in linears:
            yield (name, (*parent.split("."),
                          "kernel" if leaf == "weight" else "bias"),
                   leaf == "weight")
        else:
            yield name, tuple(name.split(".")), False


def evoformer_from_jax_params(params_np: Mapping,
                              module: torch.nn.Module) -> torch.nn.Module:
    """Load a JAX tree of f32 numpy arrays (``{"params": {...}}`` or the
    inner dict) into the ported openfold ``module`` in place, exactly,
    on the module's device; returns the module.  Every parameter of the
    module must be in the tree and every leaf of the tree used."""
    tree = params_np.get("params", params_np)
    sd = {}
    for name, path, transpose in _evoformer_leaves(module):
        leaf = torch.from_numpy(np.array(_get(tree, path), dtype=np.float32))
        sd[name] = leaf.T.contiguous() if transpose else leaf
    n_leaves = sum(1 for _ in _walk_leaves(tree))
    if n_leaves != len(sd):
        raise ValueError(
            f"the JAX tree has {n_leaves} leaves, the module {len(sd)} "
            f"parameters")
    module.load_state_dict(sd, strict=True)
    return module


def _walk_leaves(tree):
    for value in tree.values():
        if isinstance(value, Mapping):
            yield from _walk_leaves(value)
        else:
            yield value


def evoformer_to_jax_params(
        module: torch.nn.Module,
        tensors: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """The inverse of :func:`evoformer_from_jax_params`: the JAX-shaped
    tree ``{"params": {...}}`` of f32 numpy arrays.  ``tensors`` maps the
    module's parameter names to the tensors to lay out (for example each
    parameter's ``.grad``); by default the parameters themselves."""
    if tensors is None:
        tensors = dict(module.named_parameters())
    tree: dict = {}
    for name, path, transpose in _evoformer_leaves(module):
        out = _host_f32(tensors[name])
        _put(tree, path, out.T if transpose else out)
    return {"params": tree}


# ---------------------------------------------------------------------------
# optimizer state: the JAX FusedLAMB / FusedAdam states, the stateful
# optimizers' state
# ---------------------------------------------------------------------------


def _moments(opt_state_np):
    """``(count, m, v)`` of a JAX ``FusedLAMBState`` / ``FusedAdamState``:
    the NamedTuple itself, or what a checkpoint restores it as (a dict of
    its fields, or a sequence in field order)."""
    if hasattr(opt_state_np, "_fields"):
        return opt_state_np.count, opt_state_np.m, opt_state_np.v
    if isinstance(opt_state_np, Mapping):
        return opt_state_np["count"], opt_state_np["m"], opt_state_np["v"]
    count, m, v = opt_state_np
    return count, m, v


def bert_lamb_state_from_jax(opt_state_np, cfg: BertConfig, *,
                             device="cuda") -> FusedLAMBState:
    """The JAX ``fused_lamb`` state of a BERT (``count`` and the f32
    moments ``m``, ``v`` over the params tree, as numpy) as the port's
    :class:`FusedLAMBState`, the moments keyed by parameter name (the
    leaf mapping of :func:`bert_from_jax_params`) on ``device``."""
    dev = resolve_device(device)
    count, m, v = _moments(opt_state_np)
    return FusedLAMBState(
        count=int(np.asarray(count)),
        m={k: t.to(dev) for k, t in _bert_state_dict_from_jax(m, cfg).items()},
        v={k: t.to(dev) for k, t in _bert_state_dict_from_jax(v, cfg).items()},
    )


def adam_state_from_jax(opt_state_np, cfg: GptConfig, *,
                        device="cuda") -> FusedAdamState:
    """The JAX ``fused_adam`` state of a GPT as the port's
    :class:`FusedAdamState`, the moments keyed by parameter name (the
    leaf mapping of :func:`from_jax_params`) on ``device``."""
    dev = resolve_device(device)
    count, m, v = _moments(opt_state_np)
    return FusedAdamState(
        count=int(np.asarray(count)),
        m={k: t.to(dev) for k, t in _state_dict_from_jax(m, cfg).items()},
        v={k: t.to(dev) for k, t in _state_dict_from_jax(v, cfg).items()},
    )


def optimizer_state(optimizer: torch.optim.Optimizer,
                    model: torch.nn.Module) -> dict:
    """A stateful :class:`FusedLAMB` / :class:`FusedAdam`'s state as a
    tree keyed by ``model``'s parameter names: ``{"count": steps taken,
    "m": {name: tensor}, "v": {name: tensor}}``, the live moment tensors
    (zeros created for a parameter that has none yet, as its first step
    would), so a checkpoint restore with this tree as the template loads
    them in place."""
    for p in model.parameters():
        if not optimizer.state[p]:
            optimizer.state[p]["m"] = torch.zeros_like(p, dtype=torch.float32)
            optimizer.state[p]["v"] = torch.zeros_like(p, dtype=torch.float32)
    named = list(model.named_parameters())
    return {"count": int(optimizer.param_groups[0]["step"]),
            "m": {k: optimizer.state[p]["m"] for k, p in named},
            "v": {k: optimizer.state[p]["v"] for k, p in named}}


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module, state) -> None:
    """Set a stateful :class:`FusedLAMB` / :class:`FusedAdam` to ``state``
    (a :class:`FusedLAMBState` / :class:`FusedAdamState`, or the tree of
    :func:`optimizer_state`): every group's step count and each
    parameter's f32 moments, copied in place (a moment that already is
    the live tensor is left as it is)."""
    count, m, v = _moments(state)
    for group in optimizer.param_groups:
        group["step"] = int(count)
    with torch.no_grad():
        for name, p in model.named_parameters():
            slot = optimizer.state[p]
            for key, src in (("m", m[name]), ("v", v[name])):
                dst = slot.get(key)
                if dst is None:
                    slot[key] = dst = torch.zeros_like(p, dtype=torch.float32)
                if dst is not src:
                    dst.copy_(src)

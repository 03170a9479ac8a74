"""apex_tpu_torch's structural contracts, checked without a GPU.

- the port and ``chip_smoke.py`` import neither ``jax``, ``apex_tpu`` nor
  ``orbax`` (AST scan of every module);
- every port module with a counterpart at the same path carries the
  reference module's public names, less the stated JAX-only ones, and
  the lazy submodule lists cover the reference's;
- entry points (the GPT and BERT models, the engine with and without a
  draft, the converters of weights and optimizer states, the example
  trainers and the BERT example's resume, the OpenFold modules, the
  trainer (its demo, ``Trainer.build`` and ``build_guarded``), the loss
  scaler's state, ``params_from_numpy``,
  ``rope_tables``, ``DevicePrefetcher``, ``ResumableStream``'s
  prefetch and the serving chaos drill) run on the card by default
  and raise without one, unless the caller passes ``device="cpu"``;
- kernel wrappers launch their kernel or raise: handed CPU tensors, a
  kernel entry refuses instead of computing the plain version, and a
  kernel that cannot be built raises; a trainable attention bias on the
  card goes through K5;
- every kernel source carries its note (what it replaces, its bound on
  the card, what its design does about it);
- K3 and K4 are built for Hopper (TMA, mbarriers, wgmma, no wmma), K4
  has no atomics, their C argument lists stay as the wrappers declare
  them, and no kernel links libcuda;
- K5's f32 instance multiplies on the tensor cores (3xTF32 ``mma.sync``,
  no FFMA tile loop) through a cp.async ring and, like K6, uses no float
  atomic or reduction; K6 loads through cp.async, and its C arguments
  match the wrapper's list.
"""

import ast
import ctypes
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_workers as workers

from apex_tpu_torch.contrib.openfold import DAPAxialBlock, EvoformerBlock
from apex_tpu_torch.models import (
    BertConfig,
    BertForPreTraining,
    GptConfig,
    GptModel,
    adam_state_from_jax,
    bert_from_jax_params,
    bert_lamb_state_from_jax,
    from_jax_params,
)
from apex_tpu_torch.ops import _build, _dispatch
from apex_tpu_torch.examples import pretrain_bert, train_gpt
from apex_tpu_torch.ops import attention
from apex_tpu_torch.ops.attention import flash_bwd, flash_dbias, flash_fwd
from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
from apex_tpu_torch.ops.paged_attention import paged_decode_fwd
from apex_tpu_torch.ops import paged_attention
from apex_tpu_torch.data import DevicePrefetcher
from apex_tpu_torch.goodput import ResumableStream
from apex_tpu_torch.tools import serve_chaos_drill
from apex_tpu_torch.serve import (
    InferenceEngine,
    ServeConfig,
    SpecConfig,
    init_kv_pages,
    rope_tables,
)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=32, hidden_size=32, num_layers=1, num_heads=2,
            intermediate_size=64, max_seq_len=64, dtype=torch.float32)
TINY_BERT = dict(vocab_size=32, hidden_size=32, num_layers=1, num_heads=2,
                 intermediate_size=64, max_position_embeddings=64,
                 dtype=torch.float32)


@pytest.fixture(autouse=True)
def _destroy_port_parallel_state():
    """Leave no port ``parallel_state`` behind (an example's ``main``
    leaves it initialized) for the next test or the next file in this
    worker."""
    yield from workers.port_state_guard()


def _port_files():
    return sorted((ROOT / "apex_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"
    ]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_apex_tpu():
    files = _port_files()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    bad = [
        (p.relative_to(ROOT).as_posix(), mod)
        for p in files
        for mod in _imported_modules(p)
        if mod.split(".")[0] in ("jax", "jaxlib", "apex_tpu", "flax", "orbax")
    ]
    assert bad == []


#: the port's modules, each under its JAX counterpart's name
COUNTERPARTS = (
    "ops/layer_norm.py", "ops/rope.py", "ops/attention.py",
    "ops/paged_attention.py", "models/gpt.py", "models/bert.py",
    "optimizers/fused_adam.py", "optimizers/fused_lamb.py",
    "transformer/tensor_parallel/cross_entropy.py",
    "contrib/openfold/evoformer.py", "parallel/comm.py", "serve/cache.py",
    "serve/model.py", "serve/engine.py", "serve/scheduler.py",
    "serve/spec.py", "ops/xentropy.py", "ops/scaled_softmax.py",
    "transformer/enums.py", "transformer/functional/fused_softmax.py",
    "transformer/pipeline_parallel/schedules.py",
    "transformer/tensor_parallel/random.py", "observability/locks.py",
    "checkpoint/__init__.py", "resilience/__init__.py",
    "resilience/chaos.py", "resilience/retry.py", "resilience/runner.py",
    "goodput/__init__.py", "goodput/async_ckpt.py", "goodput/stream.py",
    "observability/__init__.py", "observability/meter.py",
    "observability/ometrics.py", "observability/metrics.py",
    "observability/flight.py", "observability/spans.py",
    "observability/health.py", "parallel_state.py",
    "parallel/__init__.py", "parallel/distributed.py",
    "parallel/quantized.py", "parallel/distributed_fused_optimizers.py",
    "parallel/sync_batchnorm.py", "parallel/multihost.py",
    "transformer/tensor_parallel/__init__.py",
    "transformer/tensor_parallel/mappings.py",
    "transformer/tensor_parallel/layers.py",
    "transformer/tensor_parallel/data.py",
    "transformer/tensor_parallel/utils.py",
    "contrib/openfold/__init__.py", "analysis/__init__.py",
    "analysis/sharding.py", "train/__init__.py", "train/config.py",
    "train/sharding.py", "train/trainer.py", "train/demo.py",
    "train/guarded.py", "amp/__init__.py", "amp/policy.py",
    "amp/scaler.py", "resilience/guards.py", "transformer/amp/__init__.py",
    "transformer/amp/grad_scaler.py", "transformer/__init__.py",
    "transformer/microbatches.py", "transformer/context_parallel.py",
    "transformer/moe.py", "transformer/pipeline_parallel/__init__.py",
    "transformer/pipeline_parallel/p2p_communication.py",
    "transformer/pipeline_parallel/utils.py",
    # amp's frontend and lists, fp16_utils (item 10); the source lints
    # and the retrace sentinel (the first part of item 9)
    "amp/frontend.py", "amp/lists/__init__.py", "amp/lists/_registry.py",
    "amp/lists/functional_overrides.py", "_autocast_utils.py",
    "fp16_utils/__init__.py", "analysis/findings.py",
    "analysis/concurrency.py", "analysis/purity.py", "analysis/retrace.py",
    # the rest of item 9 (the recorded step's reader and passes, the
    # memory estimate, the kernel passes) and item 8's first part
    "analysis/hlo.py", "analysis/passes.py", "analysis/memory.py",
    "analysis/kernels.py", "observability/export.py",
    "observability/memstats.py",
    # the rest of item 8: profiler windows, attribution, the fleet view,
    # SLOs, canaries and the fleet control plane
    "observability/trace.py", "observability/attribution.py",
    "observability/fleet.py", "observability/slo.py",
    "observability/canary.py", "fleetctl/__init__.py",
    "fleetctl/replica.py", "fleetctl/router.py", "fleetctl/autoscale.py",
    "fleetctl/fleet.py",
    # item 11's first part: the norm modules, the contrib modules over
    # K1-K4, ResNet, the remaining optimizers and multi_tensor_apply
    "normalization/__init__.py", "normalization/instance_norm.py",
    "contrib/layer_norm/__init__.py", "contrib/xentropy/__init__.py",
    "contrib/fmha/__init__.py", "contrib/multihead_attn/__init__.py",
    "contrib/multihead_attn/modules.py", "contrib/clip_grad/__init__.py",
    "models/resnet.py", "optimizers/__init__.py", "optimizers/fused_sgd.py",
    "optimizers/larc.py", "optimizers/clip_grad.py",
    "optimizers/fused_adagrad.py", "optimizers/fused_novograd.py",
    "optimizers/fused_mixed_precision_lamb.py", "optimizers/multi_tensor.py",
    "multi_tensor_apply/__init__.py",
    # item 11 step 6: the remaining contrib packages
    *(f"contrib/{pkg}/__init__.py" for pkg in (
        "nccl_allocator", "gpu_direct_storage", "peer_memory", "nccl_p2p",
        "conv_bias_relu", "group_norm", "groupbn", "cudnn_gbn", "bottleneck",
        "focal_loss", "index_mul_2d", "transducer", "sparsity")),
    "contrib/sparsity/permutation.py",
)

#: modules of item 9 and item 8's first part whose counterparts live at
#: another path (the reference keeps its Pallas plumbing under
#: ``ops/pallas/``, its examples under ``examples/simple/``)
ITEM9_FILES = {
    "analysis/hlo.py": "apex_tpu/analysis/hlo.py",
    "analysis/passes.py": "apex_tpu/analysis/passes.py",
    "analysis/memory.py": "apex_tpu/analysis/memory.py",
    "analysis/kernels.py": "apex_tpu/analysis/kernels.py",
    "ops/tune_cache.py": "apex_tpu/ops/pallas/tune_cache.py",
    "ops/introspect.py": "apex_tpu/ops/pallas/introspect.py",
    "observability/export.py": "apex_tpu/observability/export.py",
    "observability/memstats.py": "apex_tpu/observability/memstats.py",
    "examples/serve_gpt.py": "examples/simple/serve/serve_gpt.py",
    "tools/graph_lint.py": "tools/graph_lint.py",
    "tools/kernel_lint.py": "tools/kernel_lint.py",
}


#: the rest of item 8's files whose counterparts live at another path
ITEM8_FILES = {
    "examples/train_resilient.py": "examples/simple/resilient/train_resilient.py",
    "tools/fleet_drill.py": "tools/fleet_drill.py",
    "tools/canary_drill.py": "tools/canary_drill.py",
    "observability/trace.py": "apex_tpu/observability/trace.py",
    "observability/attribution.py": "apex_tpu/observability/attribution.py",
    "observability/fleet.py": "apex_tpu/observability/fleet.py",
    "observability/slo.py": "apex_tpu/observability/slo.py",
    "observability/canary.py": "apex_tpu/observability/canary.py",
    "fleetctl/fleet.py": "apex_tpu/fleetctl/fleet.py",
    "fleetctl/replica.py": "apex_tpu/fleetctl/replica.py",
    "fleetctl/router.py": "apex_tpu/fleetctl/router.py",
    "fleetctl/autoscale.py": "apex_tpu/fleetctl/autoscale.py",
}


@pytest.mark.parametrize("module", sorted(ITEM9_FILES) + sorted(ITEM8_FILES))
def test_item9_modules_are_in_the_isolation_walk(module):
    path = ROOT / "apex_tpu_torch" / module
    assert path in _port_files(), module
    assert not [m for m in _imported_modules(path)
                if m.split(".")[0] in ("jax", "jaxlib", "apex_tpu", "flax",
                                       "orbax", "optax")], module
    assert (ROOT / {**ITEM9_FILES, **ITEM8_FILES}[module]).is_file(), module

#: the modules this walk must see (each imported nothing of JAX above)
#: and the examples under their counterparts' names (``examples/`` at the
#: repository root holds the reference's)
ITEM10_FILES = (
    "amp/frontend.py", "amp/lists/_registry.py",
    "amp/lists/functional_overrides.py", "_autocast_utils.py",
    "fp16_utils/__init__.py", "analysis/findings.py",
    "analysis/concurrency.py", "analysis/purity.py", "analysis/retrace.py",
    "examples/dcgan/main_amp.py",
)
#: and item 11's
ITEM11_FILES = (
    "normalization/__init__.py", "contrib/multihead_attn/modules.py",
    "contrib/fmha/__init__.py", "models/resnet.py",
    "optimizers/fused_mixed_precision_lamb.py",
    "multi_tensor_apply/__init__.py", "examples/imagenet/main_amp.py",
    "mlp/__init__.py", "fused_dense/__init__.py", "RNN/__init__.py",
    "reparameterization/__init__.py", "transformer/layers/__init__.py",
    "transformer/log_util.py", "transformer/testing/__init__.py",
    "transformer/testing/commons.py",
    "transformer/testing/standalone_bert.py",
    "transformer/testing/standalone_gpt.py", "utils/__init__.py",
    "utils/profiling.py", "_native/__init__.py",
    "tools/trace_summary.py", "tools/step_profile.py", "tools/timeline.py",
    *(p for p in COUNTERPARTS if p.startswith("contrib/")
      and p.split("/")[1] not in ("openfold", "layer_norm", "xentropy",
                                  "fmha", "multihead_attn", "clip_grad")),
)


#: ROADMAP item 12: the root tools that drive the system
ITEM12_FILES = (
    "tools/serve_bench.py", "tools/goodput_drill.py", "tools/flight_view.py",
    "tools/concurrency_lint.py", "tools/int8wire_sensitivity.py",
    "tools/pipeline_cost.py", "tools/_ranks.py",
)


@pytest.mark.parametrize("module",
                         ITEM10_FILES + ITEM11_FILES + ITEM12_FILES)
def test_new_modules_are_in_the_isolation_walk(module):
    path = ROOT / "apex_tpu_torch" / module
    assert path in _port_files(), module
    assert not [m for m in _imported_modules(path)
                if m.split(".")[0] in ("jax", "jaxlib", "apex_tpu", "flax",
                                       "orbax", "optax")], module
    if module.startswith("examples/"):
        assert (ROOT / module).is_file(), module


@pytest.mark.parametrize("module", COUNTERPARTS)
def test_port_modules_keep_their_counterparts_names(module):
    assert (ROOT / "apex_tpu" / module).is_file(), module
    assert (ROOT / "apex_tpu_torch" / module).is_file(), module


#: the port's tools under the reference's tools/ names
TOOLS = ("serve_chaos_drill.py", "graph_lint.py", "kernel_lint.py",
         "fleet_drill.py", "canary_drill.py", "trace_summary.py",
         "step_profile.py", "timeline.py", "serve_bench.py",
         "goodput_drill.py", "flight_view.py", "concurrency_lint.py",
         "int8wire_sensitivity.py", "pipeline_cost.py", "ln_tune.py",
         "comm_structure.py", "shard_report.py", "repo_lint.py")

#: the root tools with no counterpart in the port, each with its reason
TOOLS_WITHOUT_COUNTERPART = {
    "bench_all.py": "the reference's TPU baseline run; the port's "
                    "benchmark brings its own",
    "bench_diff.py": "compares the reference's TPU baseline runs; the "
                     "port's benchmark brings its own",
    "mfu_sweep.py": "the reference's TPU MFU sweep; the port's benchmark "
                    "brings its own",
    "attn_tune.py": "a Pallas block tuner (tools/flash_tiles.py tunes "
                    "the CUDA kernels' tiles)",
}

#: the ported tools whose reference functions the port keeps by name
#: (every public top-level function of the reference's file)
TOOLS_KEEPING_FUNCTIONS = ("ln_tune.py", "comm_structure.py",
                           "shard_report.py", "repo_lint.py")

#: flags of a reference tool that its port drops, each with its reason
DROPPED_FLAGS = {
    "shard_report.py": {
        "--hlo": "reads an optimized-HLO text dump; the port compiles no "
                 "program text, and its step records live only in the "
                 "process that ran the step",
        "--donated": "the declared donated-leaf count that only the --hlo "
                     "mode reads",
    },
    "comm_structure.py": {
        "--round": "names the root artifact COMM_STRUCTURE_r{N}.json; the "
                   "port writes build/COMM_STRUCTURE_torch.json (--out)",
    },
}


@pytest.mark.parametrize("tool", TOOLS)
def test_port_tools_keep_their_counterparts_names(tool):
    assert (ROOT / "tools" / tool).is_file(), tool
    assert (ROOT / "apex_tpu_torch" / "tools" / tool).is_file(), tool


def _ref_source(tool):
    return (ROOT / "tools" / tool).read_text()


@pytest.mark.parametrize("tool", TOOLS_KEEPING_FUNCTIONS)
def test_ported_tools_keep_the_references_functions(tool):
    tree = ast.parse(_ref_source(tool))
    names = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)
             and not n.name.startswith("_")]
    assert names, tool
    mod = importlib.import_module(
        f"apex_tpu_torch.tools.{tool.removesuffix('.py')}")
    missing = [n for n in names if not callable(getattr(mod, n, None))]
    assert not missing, (tool, missing)


@pytest.mark.parametrize("tool", TOOLS_KEEPING_FUNCTIONS)
def test_ported_tools_take_the_references_flags(tool):
    ref_flags = set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"',
                               _ref_source(tool)))
    mod = importlib.import_module(
        f"apex_tpu_torch.tools.{tool.removesuffix('.py')}")
    port_src = Path(mod.__file__).read_text()
    port_flags = set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"',
                                port_src))
    dropped = DROPPED_FLAGS.get(tool, {})
    assert all(reason for reason in dropped.values())
    assert ref_flags - port_flags == set(dropped), tool
    # a dropped flag is named, with its reason, in the tool's docstring
    for flag in dropped:
        assert flag in (mod.__doc__ or ""), (tool, flag)


def test_every_root_tool_is_ported_or_has_its_reason():
    root_tools = sorted(p.name for p in (ROOT / "tools").glob("*.py"))
    assert not set(TOOLS) & set(TOOLS_WITHOUT_COUNTERPART)
    assert root_tools == sorted((*TOOLS, *TOOLS_WITHOUT_COUNTERPART))
    for name, reason in TOOLS_WITHOUT_COUNTERPART.items():
        assert reason and not (ROOT / "apex_tpu_torch" / "tools"
                               / name).exists(), name


def test_native_host_ops_have_their_own_source():
    """The port builds its own copy of the host C++ (its body the
    reference's), not the JAX package's file."""
    port = ROOT / "apex_tpu_torch" / "_native" / "host_ops.cpp"
    ref = ROOT / "apex_tpu" / "_native" / "host_ops.cpp"

    def body(p):
        text = p.read_text()
        return text[text.index("#include <cstdint>"):]

    assert port.is_file() and body(port) == body(ref)
    assert "apex_tpu/_native" not in (
        ROOT / "apex_tpu_torch" / "_native" / "__init__.py").read_text()


#: public names of a reference module that the port does not carry at
#: the same path, each with the reason (ROADMAP C13)
JAX_ONLY_NAMES = {
    "ops": {
        "use_pallas": "the Pallas-or-jnp switch: the port's rule is the "
                      "tensor's device (ops._dispatch.on_card)",
        "set_use_pallas": "forces that switch",
    },
    "ops._dispatch": {
        "use_pallas": "as ops.use_pallas",
        "set_use_pallas": "as ops.set_use_pallas",
        "pallas_interpret": "Pallas's interpret mode off a TPU; a CUDA "
                            "kernel has none (the CPU runs the twin)",
        "forced": "reads the Pallas switch's forced state",
    },
    "parallel_state": {
        "named_sharding": "a jax NamedSharding over the mesh; a rank "
                          "holds its own shard (get_group, axis_rank)",
        "data_parallel_sharding": "a jax sharding of the batch; "
                                  "data_parallel_shard slices it here",
        "replicated_sharding": "every process holds its own replica",
    },
    "analysis": {
        "lint_jaxpr": "lints a jaxpr; the port lints a recorded step "
                      "(analysis.passes.run_passes)",
        "lint_hlo": "lints compiled HLO text, which the port has none of",
        "iter_eqns": "walks jaxpr equations; passes.iter_ops walks a "
                     "StepRecord",
    },
    "analysis.passes": {"iter_eqns": "as analysis.iter_eqns"},
    "analysis.hlo": {
        "COLLECTIVE_KINDS": "HLO collective opcodes of compiled text",
        "async_start_result": "reads an HLO async-start's result shape",
        "ring_wire_bytes": "wire bytes of a compiled HLO collective "
                           "(parallel.comm.ring_wire_bytes is the port's)",
        "overlap_collect": "the async collectives' overlap in HLO text",
        "num_partitions": "the SPMD partition count of a compiled module",
        "parameter_shardings": "GSPMD shardings of compiled parameters",
        "parse_sharding": "parses an HLO sharding annotation",
        "collective_instructions": "HLO collectives of compiled text",
        "replica_group_size": "an HLO collective's replica groups",
    },
    "analysis.sharding": {
        "DEFAULT_MIN_BYTES": "a threshold of the GSPMD sharding pass",
        "DEFAULT_UNPLANNED_TOLERANCE": "a threshold of the reshard pass",
        "normalize_param_path": "maps GSPMD op_name metadata to a path",
        "mesh_axis_groups": "device-id replica groups of a jax Mesh",
        "infer_collective_axis": "a compiled collective's mesh axis from "
                                 "its replica groups",
        "plan_table": "compiled parameter shardings against the rules",
        "sharding_pass": "checks compiled GSPMD shardings; the trainer "
                         "checks its shards against the rule tables",
        "reshard_pass": "finds compiler-inserted reshards; the port holds "
                        "the collective call log to the plan",
    },
    "observability.meter": {
        "VMEM_BYTES": "the TPU's VMEM sizes (SMEM_BYTES is the port's)",
        "vmem_bytes_for": "a TPU's VMEM size (smem_bytes_for here)",
    },
    "analysis.kernels": {
        "vmem_footprint": "a Pallas call's VMEM blocks; a launch plan's "
                          "shared memory is KernelSpec.smem_bytes",
    },
}


def _reference_public_names(path):
    """A reference module's ``__all__``, or (without one) its public
    top-level definitions and the names it imports from its own
    package."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets)):
            return list(ast.literal_eval(node.value))
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.append(node.target.id)
        elif isinstance(node, ast.ImportFrom) and (
                node.level or (node.module or "").startswith("apex_tpu")):
            names += [a.asname or a.name for a in node.names]
    return [n for n in names if not n.startswith("_")]


def _walked_modules():
    out = []
    for path in sorted((ROOT / "apex_tpu_torch").rglob("*.py")):
        rel = path.relative_to(ROOT / "apex_tpu_torch")
        if (ROOT / "apex_tpu" / rel).is_file():
            parts = rel.with_suffix("").parts
            out.append(".".join(parts[:-1] if parts[-1] == "__init__"
                                else parts))
    return out


WALKED = _walked_modules()


def test_the_walk_sees_every_counterpart():
    assert len(WALKED) > 100
    assert set(JAX_ONLY_NAMES) <= set(WALKED)
    for mod in ("mlp", "fused_dense", "RNN", "reparameterization", "utils",
                "utils.profiling", "_native", "transformer.layers",
                "transformer.log_util", "transformer.testing.commons",
                "contrib.peer_memory", "contrib.groupbn", "contrib.bottleneck",
                "contrib.transducer", "contrib.sparsity",
                "contrib.sparsity.permutation"):
        assert mod in WALKED, mod


@pytest.mark.parametrize("module", WALKED)
def test_port_modules_carry_the_references_public_names(module):
    """Every public name of the reference module at the same path is in
    the port's module, less the stated JAX-only names."""
    import importlib

    rel = module.replace(".", "/")
    ref = ROOT / "apex_tpu" / f"{rel}.py"
    if not ref.is_file():
        ref = ROOT / "apex_tpu" / rel / "__init__.py"
    port = importlib.import_module(
        "apex_tpu_torch" if module == "" else f"apex_tpu_torch.{module}")
    gaps = JAX_ONLY_NAMES.get(module, {})
    missing = [n for n in _reference_public_names(ref)
               if n not in gaps and not hasattr(port, n)]
    assert missing == [], module
    # the stated gaps are gaps: each is the reference's and not the port's
    for name in gaps:
        assert name in _reference_public_names(ref), (module, name)
        assert not hasattr(port, name), (module, name)


def _lazy_list(path, name):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return set(ast.literal_eval(node.value))
    raise AssertionError(f"{path} has no {name}")


@pytest.mark.parametrize("pkg,name", [("", "_LAZY_SUBMODULES"),
                                      ("transformer", "_LAZY")])
def test_lazy_submodules_cover_the_references(pkg, name):
    import importlib

    ref = _lazy_list(ROOT / "apex_tpu" / pkg / "__init__.py", name)
    port = _lazy_list(ROOT / "apex_tpu_torch" / pkg / "__init__.py", name)
    # the reference's lazy names less its JAX-only plumbing, and every
    # package this port has added since
    assert ref <= port
    if not pkg:
        assert {"fp16_utils", "mlp", "fused_dense", "RNN",
                "reparameterization", "utils"} <= port
    mod = importlib.import_module(
        "apex_tpu_torch" + (f".{pkg}" if pkg else ""))
    for sub in port:
        assert getattr(mod, sub) is not None, sub


def test_contrib_packages_cover_the_references():
    """Every package of the reference's ``contrib`` has its counterpart
    (item 11 closed), each importable from the port's ``contrib``."""
    import importlib

    def packages(root):
        return {p.name for p in (ROOT / root / "contrib").iterdir()
                if (p / "__init__.py").is_file()}

    ref, port = packages("apex_tpu"), packages("apex_tpu_torch")
    assert len(ref) == 20 and ref == port
    for pkg in sorted(port):
        mod = importlib.import_module(f"apex_tpu_torch.contrib.{pkg}")
        assert f"apex_tpu_torch.contrib.{pkg}" in mod.__name__
        assert f":mod:`apex_tpu_torch.contrib.{pkg}`" in importlib.import_module(
            "apex_tpu_torch.contrib").__doc__, pkg


#: the data- and tensor-parallel modules (ROADMAP item 5), the DAP, the
#: trainer, amp and the guards (item 6) and the public names each must
#: carry over from its counterpart
PARALLEL_NAMES = {
    "parallel_state": (
        "initialize_model_parallel", "destroy_model_parallel",
        "model_parallel_is_initialized", "get_mesh",
        "get_data_parallel_world_size", "get_data_parallel_rank",
        "get_tensor_model_parallel_world_size",
        "get_tensor_model_parallel_rank",
        "get_tensor_model_parallel_src_rank",
        "get_pipeline_model_parallel_world_size",
        "get_pipeline_model_parallel_rank",
        "get_pipeline_model_parallel_next_rank",
        "get_pipeline_model_parallel_prev_rank",
        "get_context_parallel_world_size", "get_context_parallel_rank",
        "get_expert_model_parallel_world_size",
        "get_expert_model_parallel_rank", "is_pipeline_first_stage",
        "is_pipeline_last_stage", "get_virtual_pipeline_model_parallel_rank",
        "set_virtual_pipeline_model_parallel_rank",
        "get_virtual_pipeline_model_parallel_world_size",
        "set_virtual_pipeline_model_parallel_world_size",
        "register_sequence_parallel_param", "sequence_parallel_param_paths",
        "clear_sequence_parallel_params", "divide", "bound_axis_size",
        "axis_is_bound", "DATA_PARALLEL_AXIS", "TENSOR_PARALLEL_AXIS",
        "PIPELINE_PARALLEL_AXIS", "CONTEXT_PARALLEL_AXIS",
        "EXPERT_PARALLEL_AXIS"),
    "parallel": (
        "DistributedDataParallel", "Reducer", "all_reduce_gradients",
        "DistributedFusedAdam", "DistributedFusedLAMB", "SyncBatchNorm",
        "convert_syncbn_model", "quantized_all_reduce_gradients",
        "initialize_distributed", "distributed_is_initialized",
        "finalize_distributed", "sync_gradients", "reduce_scatter_flat",
        "all_gather_flat", "collective_summary"),
    "parallel.comm": (
        "WIRE_FORMATS", "DEFAULT_BLOCK", "check_wire", "sync_gradients",
        "reduce_scatter_flat", "all_gather_flat", "all_gather_rows",
        "resolve_chunks", "chunks_requested", "wire_bytes_per_element",
        "quantize_blocks", "dequantize_blocks", "pack_int8", "unpack_int8",
        "wire_payload_bytes", "sync_plan", "zero_plan",
        "collective_summary", "compiled_collectives", "ring_wire_bytes",
        "publish_collective_summary"),
    "parallel.multihost": (
        "initialize_distributed", "distributed_is_initialized",
        "finalize_distributed", "cluster_env_hints", "host_barrier",
        "host_id", "host_count"),
    "parallel.distributed_fused_optimizers": (
        "DistributedFusedAdam", "DistributedFusedLAMB",
        "DistributedFusedLamb"),
    "transformer.tensor_parallel": (
        "vocab_parallel_cross_entropy", "broadcast_data",
        "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
        "sharded_init", "_reduce", "_split_along_last_dim",
        "_gather_along_last_dim", "_split_along_first_dim",
        "_gather_along_first_dim", "_reduce_scatter_along_first_dim",
        "allreduce_sequence_parallel_gradients",
        "copy_to_tensor_model_parallel_region",
        "gather_from_sequence_parallel_region",
        "gather_from_tensor_model_parallel_region",
        "reduce_from_tensor_model_parallel_region",
        "reduce_scatter_to_sequence_parallel_region",
        "scatter_to_sequence_parallel_region",
        "scatter_to_tensor_model_parallel_region", "TPURNGStatesTracker",
        "checkpoint", "get_cuda_rng_tracker", "get_tpu_rng_tracker",
        "model_parallel_cuda_manual_seed", "model_parallel_tpu_manual_seed",
        "to_per_rank_key", "VocabUtility", "divide",
        "split_tensor_along_last_dim"),
    "resilience": ("robust_initialize_distributed", "GradGuard",
                   "GuardState", "GuardVerdict", "guard_metrics",
                   "guarded_amp_update"),
    "resilience.guards": ("GradGuard", "GuardState", "GuardVerdict",
                          "guard_metrics", "guarded_amp_update"),
    "contrib.openfold": ("scatter", "gather", "row_to_col", "col_to_row",
                         "scatter_rows_gather_cols",
                         "scatter_cols_gather_rows", "DAPAxialBlock",
                         "EvoformerBlock", "EvoformerPairBlock"),
    "train": ("TrainConfig", "Trainer", "TrainStep", "TrainBuildError",
              "UpdateShardingDecision", "decide_update_sharding",
              "UPDATE_SHARDING_MODES", "VERIFY_LEVELS", "GuardedStep",
              "build_guarded", "build_demo", "demo"),
    "train.sharding": ("ZERO_TWINS", "UpdateShardingDecision",
                       "decide_update_sharding", "resolve_param_specs",
                       "resolve_batch_specs", "mirror_optimizer_specs",
                       "exact_entry_rules", "local_shape", "slice_local",
                       "plan_wire_bytes"),
    "train.demo": ("demo_rules", "demo_params", "demo_batch", "demo_loss",
                   "demo_model_collectives", "demo_config", "build_demo"),
    "amp": ("Policy", "Properties", "opt_levels", "LossScaleState",
            "DynamicLossScaler", "StaticLossScaler", "amp_update", "lists",
            "AmpHandle", "AmpState", "initialize", "scale_loss",
            "master_params", "state_dict", "load_state_dict"),
    "amp.lists": ("CastPolicy", "active_policy", "amp_cast", "category",
                  "o1_patch", "register", "FP16_FUNCS", "FP32_FUNCS",
                  "CASTS"),
    "fp16_utils": ("tofp16", "network_to_half", "BN_convert_float",
                   "prep_param_lists", "master_params_to_model_params",
                   "model_grads_to_master_grads", "FP16_Optimizer"),
    "_autocast_utils": ("_cast_if_autocast_enabled", "cast_inputs"),
    "analysis.findings": ("ERROR", "WARNING", "INFO", "RULES", "Finding",
                          "Report", "make_finding"),
    "analysis.concurrency": ("LOCK_CTORS", "BLOCKING_CALLS",
                             "analyze_class", "lint_source", "lint_sources",
                             "concurrency_pass"),
    "analysis.purity": ("REPLAY_CRITICAL", "WALL_CLOCK_PATTERNS",
                        "WAIVER_RE", "is_replay_critical",
                        "collect_sources", "lint_source", "lint_sources",
                        "purity_pass"),
    "analysis.retrace": ("abstract_signature", "RetraceSentinel"),
    "transformer.amp": ("GradScaler",),
    "analysis.sharding": ("tree_paths", "match_partition_rules",
                          "spec_dim_factors"),
    "optimizers": ("FACTORIES", "by_name"),
    "observability.meter": ("StepMeter", "GoodputAccountant",
                            "transformer_train_flops", "peak_flops_for",
                            "peak_hbm_bandwidth_for",
                            "peak_ici_bandwidth_for", "chip_peak_flops",
                            "total_peak_flops", "percentile"),
    "contrib.optimizers": ("DistributedFusedAdam", "DistributedFusedLAMB",
                           "DistributedFusedLamb"),
    # pipeline, context and expert parallelism (item 7)
    "transformer.pipeline_parallel": (
        "p2p_communication", "forward_backward_no_pipelining",
        "forward_backward_pipelining_1f1b",
        "forward_backward_pipelining_interleaved_1f1b",
        "forward_backward_pipelining_with_interleaving",
        "forward_backward_pipelining_without_interleaving",
        "get_forward_backward_func", "get_current_global_batch_size",
        "get_kth_microbatch", "get_num_microbatches", "listify_model",
        "setup_microbatch_calculator", "split_batch_into_microbatches",
        "update_num_microbatches"),
    "transformer.pipeline_parallel.p2p_communication": (
        "send_forward", "recv_forward", "send_backward", "recv_backward",
        "send_forward_recv_backward", "send_backward_recv_forward",
        "send_forward_recv_forward", "send_backward_recv_backward",
        "_shift"),
    "transformer.microbatches": (
        "ConstantNumMicroBatches", "RampupBatchsizeNumMicroBatches",
        "build_num_microbatches_calculator"),
    "transformer.context_parallel": (
        "ring_attention", "ulysses_attention", "zigzag_shard",
        "zigzag_split", "zigzag_merge", "_block_attend", "_merge_block",
        "_skipped_block", "_ring_attention_zigzag"),
    "transformer.moe": ("MoeConfig", "SwitchMoe", "moe_dispatch_combine",
                        "sync_moe_gradients"),
    "models.gpt": ("gpt_lm_loss_cp", "_cp_world", "_cp_shard_rows",
                   "_apply_with_moe_aux"),
}


@pytest.mark.parametrize("module", sorted(PARALLEL_NAMES))
def test_parallel_modules_carry_the_references_names(module):
    import importlib

    port = importlib.import_module(f"apex_tpu_torch.{module}")
    for name in PARALLEL_NAMES[module]:
        assert hasattr(port, name), (module, name)
    # the reference has each of them too (LARC is left out on purpose)
    ref_src = (ROOT / "apex_tpu" / (module.replace(".", "/") + ".py"))
    if not ref_src.exists():
        ref_src = ref_src.with_suffix("") / "__init__.py"
    assert ref_src.is_file(), module


def test_new_public_names_are_the_references():
    """The serving and observability names this port carries over."""
    import apex_tpu_torch.observability as obs
    import apex_tpu_torch.serve as serve
    from apex_tpu_torch.serve import scheduler

    for name in ("SHED_REROUTED", "TTFT_COMPONENTS", "declare_serve_metrics",
                 "ttft_attribution", "target_probs"):
        assert hasattr(serve, name), name
    for name in ("RETRYING", "SHED_DEADLINE", "SHED_QUEUE_FULL",
                 "SHED_RETRIES_EXHAUSTED", "SHED_DRAINING", "SHED_REROUTED"):
        assert hasattr(scheduler, name), name
    sched = scheduler.ContinuousBatchingScheduler
    for name in ("_send_to_retry", "_on_engine_fault", "_run_rebuild",
                 "flush_rebuild", "_overloaded", "_readmit", "drain",
                 "start_drain", "finish_drain", "resume", "batch_fill"):
        assert callable(getattr(sched, name)), name
    for name in ("_chaos_gate", "rebuild", "probe_stream"):
        assert callable(getattr(InferenceEngine, name)), name
    assert {"ttft_ms", "ttft_components"} <= set(dir(scheduler.Request))
    for name in ("MetricRegistry", "Board", "board", "FlightRecorder",
                 "SpanRecorder", "Watchdog", "serve_rules", "render",
                 "parse_exposition", "OpsServer", "Histogram",
                 "metric_name", "ExportNamespace", "percentile",
                 "TTFTRule", "QueueDepthRule", "QueueWaitFractionRule",
                 "SpecAcceptanceRule", "ServeFaultRule", "HealthEvent",
                 "Rule", "wall_clock_anchor", "monotonic_to_epoch",
                 "parse_spans_spec", "json_safe", "parse_flight_spec",
                 "ENV_FLIGHT", "ops_port_from_env",
                 "DEFAULT_LATENCY_BUCKETS_MS"):
        assert hasattr(obs, name), name
    # the rest of item 8: every name the reference's package exports
    # from trace, attribution, fleet, health, slo and canary
    import apex_tpu_torch.fleetctl as fleetctl

    for name in ("TraceScheduler", "annotate", "nvtx_range", "range_push",
                 "range_pop", "trace", "CostAttribution",
                 "TraceAttribution", "attribute_cost_model",
                 "attribute_trace", "attribute_trace_dir", "hlo_bucket_map",
                 "publish_attribution", "roofline_report", "FleetAggregator",
                 "FleetView", "default_rules", "goodput_rules",
                 "CheckpointStallRule", "CollectiveFractionRule",
                 "HostStallRule", "InputStallRule", "MemoryBudgetRule",
                 "SLO", "BurnRateTracker", "CounterRatioSLO", "LatencySLO",
                 "SLORule", "Window", "fleet_slo_rules", "serve_slo_rules",
                 "CanaryAnalyzer", "CanaryConfig", "CanaryController",
                 "CanaryVerdict", "GoldenProbeSet", "binom_tail",
                 "fingerprint_distance", "mann_whitney_p",
                 "model_fingerprint", "BUCKETS", "categorize_op"):
        assert hasattr(obs, name), name
    import apex_tpu.fleetctl as ref_fleetctl

    assert fleetctl.__all__ == ref_fleetctl.__all__
    for name in fleetctl.__all__:
        assert hasattr(fleetctl, name), name
    for name in ("prepare_weights", "swap_weights"):
        assert callable(getattr(InferenceEngine, name)), name


class _OneBatchLoader:
    def iter_from(self, step):
        return iter([torch.zeros(2)])


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["model", "engine", "convert", "train",
                                   "bert_model", "bert_convert",
                                   "bert_train", "evoformer", "dap_axial",
                                   "kv_pages", "spec_engine", "rope_tables",
                                   "prefetcher", "lamb_convert",
                                   "adam_convert", "bert_resume",
                                   "resumable_stream", "chaos_drill",
                                   "init_distributed", "ddp_example",
                                   "gpt_tp_example", "trainer_demo",
                                   "trainer_config", "guarded",
                                   "loss_scaler", "params_from_numpy",
                                   "fleet_drill", "canary_drill",
                                   "train_resilient", "resnet",
                                   "imagenet_example", "multihead_attn",
                                   "fused_layer_norm", "instance_norm",
                                   "mlp", "fused_dense",
                                   "fused_dense_gelu_dense", "lstm",
                                   "mlstm", "gpt_provider", "bert_provider",
                                   "identity_layer", "step_profile",
                                   "group_norm", "batchnorm_nhwc",
                                   "bottleneck", "spatial_bottleneck"])
def test_entry_points_default_to_the_card(no_gpu, entry):
    cfg = GptConfig(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "model":
            GptModel(cfg)
        elif entry == "engine":
            InferenceEngine(cfg, GptModel(cfg, device="cpu"),
                            ServeConfig(max_pages_per_seq=4))
        elif entry == "convert":
            from_jax_params({}, cfg)
        elif entry == "train":
            train_gpt.main(["--tiny", "--steps", "1"])
        elif entry == "bert_model":
            BertForPreTraining(BertConfig(**TINY_BERT))
        elif entry == "bert_convert":
            bert_from_jax_params({}, BertConfig(**TINY_BERT))
        elif entry == "evoformer":
            EvoformerBlock(16, 8, 2)
        elif entry == "dap_axial":
            DAPAxialBlock(16, 2)
        elif entry == "kv_pages":
            init_kv_pages(1, 4, 2, 16, 8)
        elif entry == "spec_engine":
            InferenceEngine(cfg, GptModel(cfg, device="cpu"),
                            ServeConfig(max_pages_per_seq=4),
                            spec=SpecConfig(None, k=2))
        elif entry == "rope_tables":
            rope_tables(cfg)
        elif entry == "prefetcher":
            DevicePrefetcher(iter([]))
        elif entry == "lamb_convert":
            bert_lamb_state_from_jax({}, BertConfig(**TINY_BERT))
        elif entry == "adam_convert":
            adam_state_from_jax({}, cfg)
        elif entry == "bert_resume":
            pretrain_bert.main(["--tiny", "--steps", "1", "--resume",
                                "--ckpt-dir", "unused"])
        elif entry == "resumable_stream":
            ResumableStream(_OneBatchLoader(), prefetch=1)(0)
        elif entry == "chaos_drill":
            serve_chaos_drill.main([])
        elif entry == "init_distributed":
            from apex_tpu_torch.parallel import initialize_distributed

            initialize_distributed()
        elif entry == "ddp_example":
            from apex_tpu_torch.examples import distributed_data_parallel

            distributed_data_parallel.main(["--steps", "1"])
        elif entry == "trainer_demo":
            from apex_tpu_torch.train import build_demo

            build_demo(1, 1)
        elif entry == "trainer_config":
            from apex_tpu_torch.analysis import P
            from apex_tpu_torch.train import TrainConfig, Trainer

            Trainer(TrainConfig(mesh={"dp": 1}, rules=[(".*", P())])).build(
                lambda p, b: 0.0, {"w": torch.zeros(2)}, (torch.zeros(2),))
        elif entry == "guarded":
            from apex_tpu_torch.amp import DynamicLossScaler
            from apex_tpu_torch.analysis import P
            from apex_tpu_torch.optimizers import fused_adam
            from apex_tpu_torch.resilience import GradGuard
            from apex_tpu_torch.train import TrainConfig, Trainer

            Trainer(TrainConfig(mesh={"dp": 1}, rules=[(".*", P())])
                    ).build_guarded(lambda p, b: 0.0, {"w": torch.zeros(2)},
                                    tx=fused_adam(), scaler=DynamicLossScaler(),
                                    guard=GradGuard())
        elif entry == "loss_scaler":
            from apex_tpu_torch.amp import DynamicLossScaler

            DynamicLossScaler().init()
        elif entry == "params_from_numpy":
            from apex_tpu_torch.train import params_from_numpy

            params_from_numpy({"w": np.zeros(2, np.float32)})
        elif entry == "fleet_drill":
            from apex_tpu_torch.tools import fleet_drill

            fleet_drill.main([])
        elif entry == "canary_drill":
            from apex_tpu_torch.tools import canary_drill

            canary_drill.main([])
        elif entry == "train_resilient":
            from apex_tpu_torch.examples import train_resilient

            train_resilient.main(["--steps", "1", "--dir", "unused"])
        elif entry == "resnet":
            from apex_tpu_torch.models import resnet50

            resnet50(stage_sizes=(1, 1, 1, 1), width=8)
        elif entry == "imagenet_example":
            from apex_tpu_torch.examples.imagenet import main_amp

            main_amp.main(["--steps", "1"])
        elif entry == "multihead_attn":
            from apex_tpu_torch.contrib.multihead_attn import (
                SelfMultiheadAttn,
            )

            SelfMultiheadAttn(16, 2)
        elif entry == "fused_layer_norm":
            from apex_tpu_torch.normalization import FusedLayerNorm

            FusedLayerNorm(16)
        elif entry == "instance_norm":
            from apex_tpu_torch.normalization import InstanceNorm3d

            InstanceNorm3d(4)
        elif entry == "mlp":
            from apex_tpu_torch.mlp import MLP

            MLP([4, 8, 2])
        elif entry == "fused_dense":
            from apex_tpu_torch.fused_dense import FusedDense

            FusedDense(4, 8)
        elif entry == "fused_dense_gelu_dense":
            from apex_tpu_torch.fused_dense import FusedDenseGeluDense

            FusedDenseGeluDense(4, 8, 4)
        elif entry == "lstm":
            from apex_tpu_torch.RNN import LSTM

            LSTM(4, 8)
        elif entry == "mlstm":
            from apex_tpu_torch.RNN import mLSTM

            mLSTM(4, 8)
        elif entry == "gpt_provider":
            from apex_tpu_torch.transformer.testing import gpt_model_provider

            gpt_model_provider()
        elif entry == "bert_provider":
            from apex_tpu_torch.transformer.testing import (
                bert_model_provider,
            )

            bert_model_provider()
        elif entry == "identity_layer":
            from apex_tpu_torch.transformer.testing import IdentityLayer

            IdentityLayer((2, 2))
        elif entry == "step_profile":
            from apex_tpu_torch.tools import step_profile

            step_profile.main(["--target", "resilient"])
        elif entry == "group_norm":
            from apex_tpu_torch.contrib.group_norm import GroupNorm

            GroupNorm(2, 8)
        elif entry == "batchnorm_nhwc":
            from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC

            BatchNorm2d_NHWC(8)
        elif entry == "bottleneck":
            from apex_tpu_torch.contrib.bottleneck import Bottleneck

            Bottleneck(8, 4, 8)
        elif entry == "spatial_bottleneck":
            from apex_tpu_torch.contrib.bottleneck import SpatialBottleneck

            SpatialBottleneck(8, 4, 8)
        elif entry == "gpt_tp_example":
            train_gpt.main(["--tiny", "--steps", "1", "--tp", "2",
                            "--sequence-parallel"])
        else:
            pretrain_bert.main(["--tiny", "--steps", "1"])


def test_cpu_runs_when_asked(no_gpu):
    cfg = GptConfig(**TINY)
    eng = InferenceEngine(cfg, GptModel(cfg, device="cpu"),
                          ServeConfig(max_pages_per_seq=4), device="cpu")
    _, tok = eng.prefill([1, 2, 3], eng.pool.alloc(1))
    assert 0 <= tok < cfg.vocab_size


def test_kernel_entries_refuse_cpu_tensors():
    x = torch.zeros(4, 32)
    w = torch.ones(32)
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_fwd(x, w, w, eps=1e-5, rms=False)
    stats = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_bwd(x, w, w, stats, stats, x, rms=False,
                       x_is_output=False)
    q = torch.zeros(2, 16, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd(q, q, q, scale=0.125, causal=True)
    stats = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd(q, q, q, q, stats, stats, stats, scale=0.125, causal=True)
    bias = torch.zeros(1, 1, 16)
    seed = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd(q, q, q, bias, scale=0.125, causal=False, dropout_p=0.1,
                  seed=seed)
    pages = torch.zeros(4, 2, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_fwd(
            torch.zeros(1, 2, 64), pages, pages,
            torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), scale=0.125,
        )


@pytest.mark.parametrize("bias_rows,dropout_p", [(16, 0.0), (1, 0.1)])
def test_flash_dbias_refuses_cpu_tensors(bias_rows, dropout_p):
    q = torch.zeros(2, 16, 32, dtype=torch.bfloat16)
    stats = torch.zeros(2, 16)
    seed = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_dbias(q, q, q, q, stats, stats, stats,
                    torch.zeros(2, bias_rows, 16), scale=0.125, causal=False,
                    dropout_p=dropout_p, seed=seed)


@pytest.mark.parametrize("bias_grad", [True, False])
def test_trainable_bias_on_the_card_launches_k5(monkeypatch, bias_grad):
    """On the card a trainable bias goes through K3, K4 and K5 (and a
    mask-only bias through K3 and K4), with no plain path in between.
    The kernel wrappers are stood in for by their twins, counted."""
    monkeypatch.setattr(_dispatch, "on_card", lambda *tensors: True)
    calls = []
    for name in ("flash_fwd", "flash_bwd", "flash_dbias"):
        twin = getattr(attention, name + "_reference")

        def wrapper(*args, _name=name, _twin=twin, **kwargs):
            calls.append(_name)
            return _twin(*args, **kwargs)

        monkeypatch.setattr(attention, name, wrapper)
    q = torch.randn(1, 2, 16, 32, requires_grad=True)
    bias = torch.randn(1, 2, 16, 16, requires_grad=True)
    attention.flash_attention(q, q, q, bias, bias_grad=bias_grad).sum().backward()
    if bias_grad:
        assert calls == ["flash_fwd", "flash_bwd", "flash_dbias"]
        assert bias.grad.shape == bias.shape
    else:
        assert calls == ["flash_fwd", "flash_bwd"] and bias.grad is None


def test_device_rule():
    cpu = torch.zeros(2)
    assert _dispatch.on_card(cpu, cpu) is False
    with pytest.raises(ValueError, match="devices"):
        _dispatch.on_card(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        _dispatch.resolve_device("meta")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("paged_decode")


def test_build_dir(monkeypatch, tmp_path):
    # a checkout builds under its own build/; an installed copy under the
    # per-user cache
    assert _build._build_dir() == _build._PKG.parent / "build" / "apex_tpu_torch"
    monkeypatch.setattr(_build, "_PKG", tmp_path / "site" / "apex_tpu_torch")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build._build_dir() == tmp_path / "cache" / "apex_tpu_torch"


def test_launch_counters():
    _dispatch.reset_launches()
    _dispatch.count_launch("layer_norm_fwd")
    _dispatch.count_launch("layer_norm_fwd")
    assert _dispatch.launches() == {"layer_norm_fwd": 2}
    _dispatch.reset_launches()
    assert _dispatch.launches() == {}


@pytest.mark.parametrize("name", _build.KERNELS)
def test_kernel_sources_carry_their_note(name):
    src = _build.source_path(name).read_text()
    head = src.split("#include")[0]
    for field in ("Replaces:", "apex_tpu/ops/pallas/", "Bound on the H100:",
                  "Design:"):
        assert field in head, (name, field)
    assert 'extern "C"' in src and "cudaGetLastError" in src


def _translation_unit(name):
    """Kernel ``name``'s source with the csrc headers it includes: what
    nvcc compiles."""
    src = _build.source_path(name).read_text()
    csrc = _build.source_path(name).parent
    headers = [csrc / h for h in
               re.findall(r'#include "([^"]+)"', src)]
    return src, "\n".join([src] + [h.read_text() for h in headers])


def _code(text):
    """``text`` without its // comments."""
    return "\n".join(line.split("//")[0] for line in text.splitlines())


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd"])
def test_flash_kernels_run_on_wgmma_and_tma(name):
    """K3 and K4 load through TMA into an mbarrier ring and multiply on
    wgmma; no wmma fragment is left."""
    src, tu = _translation_unit(name)
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor",
                "mbarrier.try_wait", "mbarrier.arrive.expect_tx",
                "setmaxnreg"):
        assert ptx in tu, (name, ptx)
    for call in ("wgmma_ss(", "wgmma_rs(", "tma_load_3d(", "mbar_wait(",
                 "make_map("):
        assert call in src, (name, call)
    assert "wmma::" not in tu and "<mma.h>" not in tu


def test_flash_bwd_is_atomic_free():
    """K4's gradients are the same bits from run to run: two passes and
    no atomic or reduction to global memory."""
    _, tu = _translation_unit("flash_bwd")
    code = _code(tu)
    assert "atomic" not in code
    assert re.search(r"\bred\.", code) is None
    assert "cp.reduce.async" not in code
    # the dK/dV pass and the dQ pass, each also as the wide instance, and
    # the dQ pass with the dbias epilogue (flash_bwd_dbias)
    assert code.count("__global__") == 5


def test_flash_c_argument_lists_are_unchanged():
    """The redesigned K3 and K4 keep their C entry points' arguments."""
    p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_uint)
    assert attention._FWD_ARGS == [p] * 9 + [i] * 6 + [f, i, u, f, p]
    assert attention._BWD_ARGS == [p] * 12 + [i] * 6 + [f, i, u, f, p]
    for name, args in (("flash_fwd", attention._FWD_ARGS),
                       ("flash_bwd", attention._BWD_ARGS)):
        src = _build.source_path(name).read_text()
        entry = src.split(f'extern "C" int {name}(')[1].split(")")[0]
        assert entry.count(",") + 1 == len(args), name


def test_nvcc_flags_do_not_link_the_driver():
    """The tensor maps are encoded through the driver entry point that
    the runtime hands out, so no kernel links libcuda."""
    assert not any(flag.startswith("-l") for flag in _build.NVCC_FLAGS)
    assert "-lcuda" not in " ".join(_build.NVCC_FLAGS)
    _, tu = _translation_unit("flash_fwd")
    assert "cudaGetDriverEntryPoint" in tu


def test_tile_sweep_defines_reach_the_sources():
    """Every macro the tile sweep sets is read by its kernel's source,
    and each variant builds into a library of its own."""
    from apex_tpu_torch.tools import flash_tiles

    for name, variants in flash_tiles.VARIANTS.items():
        src = _build.source_path(name).read_text()
        targets = set()
        for _, defines in variants:
            for define in defines:
                assert f"#ifdef {define.split('=')[0]}" in src, define
            flags = _build.NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
            targets.add(_build._target(name, flags))
        assert len(targets) == len(variants)


def _kernel_body(code, name):
    """The text of ``__global__`` function ``name`` in ``code``."""
    start = code.index(name + "(")
    end = code.find("__global__", start)
    return code[start:end if end > 0 else len(code)]


@pytest.mark.parametrize("name", ["flash_f32", "paged_decode"])
def test_k5_f32_and_k6_use_no_float_atomics(name):
    """K5's f32 sums and K6's merge take a fixed order: no float atomic, no
    red. and no bulk reduction.  K6's one atomic is its integer arrival
    counter, whose result picks the CTA that merges."""
    _, tu = _translation_unit(name)
    code = _code(tu)
    assert re.search(r"\bred\.", code) is None
    assert "cp.reduce.async" not in code
    calls = re.findall(r"atomic\w*\(([^,]*),", code)
    if name == "flash_f32":
        assert calls == []
    else:
        assert calls == ["&counters[bh]"]
        assert "int* __restrict__ counters" in code


def test_k5_f32_runs_on_tensor_cores_through_a_cp_async_ring():
    """The redesigned K5 f32: 3xTF32 mma.sync products fed by cp.async,
    and no SIMT FFMA tile loop left."""
    _, tu = _translation_unit("flash_f32")
    code = _code(tu)
    body = _kernel_body(code, "flash_dbias_f32_kernel")
    for call in ("mma3(", "load_a(", "load_bt(", "stage_rows<",
                 "cp_async_wait<", "stage_bias<"):
        assert call in body, call
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in code
    assert "tile_product" not in code and "load_t<" not in code


def test_k6_loads_through_cp_async_and_declares_its_arguments():
    """K6 streams its K and V tiles through cp.async, and the wrapper's
    argument list (the split plan and the workspace included) matches the
    C entry point's."""
    src = _build.source_path("paged_decode").read_text()
    code = _code(src)
    assert "cp.async.cg.shared.global" in code
    assert "cp.async.wait_group" in code
    entry = src.split('extern "C" int paged_decode(')[1].split(")")[0]
    assert entry.count(",") + 1 == len(paged_attention._ARGS)
    assert paged_attention._ARGS[-1] is ctypes.c_void_p  # the stream

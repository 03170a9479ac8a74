"""Declarative training configuration — the single entry point's knobs.

Counterpart of ``apex_tpu/train/config.py``: the same fields, defaults,
validation and messages.  One :class:`TrainConfig` names everything
:class:`apex_tpu_torch.train.Trainer` needs: the process grid (``dp``/
``tp`` axes of :mod:`apex_tpu_torch.parallel_state`; ``pp`` is reserved
and validated to 1), the regex -> PartitionSpec rule table over
``tree_paths`` (:func:`apex_tpu_torch.analysis.sharding.
match_partition_rules`), the comm engine's wire knobs, the
update-sharding policy and the self-verification expectations.  The
same table slices each rank's shards at build and is the expectation
the step's shapes are verified against.

Port difference: the reference's ``devices`` (a device list for the
mesh) is ``device`` here — the device this process runs on (the card
unless the caller asks for the CPU); the process grid is the
``torch.distributed`` world.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple, Union

from apex_tpu_torch.parallel import comm

__all__ = ["TrainConfig", "UPDATE_SHARDING_MODES", "VERIFY_LEVELS"]

#: ``auto`` lets the framework decide (the headline: "Automatic
#: Cross-Replica Sharding of Weight Update in Data-Parallel Training",
#: PAPERS.md); ``shard``/``replicate`` are the explicit overrides.
UPDATE_SHARDING_MODES = ("auto", "shard", "replicate")

#: ``error`` = a build that fails its own analysis raises (the default:
#: a trainer that compiles an unplanned collective or a
#: replicated-but-should-be-sharded param must not hand out the step);
#: ``warn`` = findings print + ride the report; ``off`` = skip checks.
VERIFY_LEVELS = ("error", "warn", "off")


@dataclasses.dataclass
class TrainConfig:
    """Config for :class:`apex_tpu_torch.train.Trainer`.

    Field reference: ``docs/training.md``.
    """

    #: mesh axis sizes, e.g. ``{"dp": 2, "tp": 2}``.  Axis ORDER is the
    #: device-grid order (dp-major).  ``pp`` is reserved: accepted in
    #: the mapping but must be 1 until the pipeline stage lands.
    mesh: Mapping[str, int]

    #: regex → PartitionSpec over PARAM-RELATIVE paths (``"w1"``,
    #: ``"block_0/mlp/kernel"``).  First match wins; a param no rule
    #: covers fails the build loudly naming the path — a plan with
    #: holes is not a plan.
    rules: Sequence[Tuple[str, Any]]

    #: regex → PartitionSpec over BATCH-relative paths.  Default: every
    #: batch leaf shards its leading axis over ``dp``.
    batch_rules: Optional[Sequence[Tuple[str, Any]]] = None

    #: ``"adam"`` | ``"lamb"`` — resolved through
    #: :func:`apex_tpu_torch.optimizers.by_name` — or an object with
    #: functional ``init``/``update`` (the latter pins
    #: ``update_sharding="replicate"``: only the named optimizers have
    #: a ZeRO twin).
    optimizer: Union[str, Any] = "adam"
    optimizer_kwargs: Mapping[str, Any] = dataclasses.field(
        default_factory=dict
    )
    learning_rate: float = 1e-3

    # -- comm engine knobs (docs/comm.md), threaded through unchanged --
    wire: str = "f32"
    param_wire: Optional[str] = None
    chunks: Optional[int] = None
    block: int = comm.DEFAULT_BLOCK
    #: leaves under this many ELEMENTS ride the exact psum in the ddp
    #: path (comm.sync_gradients's min_size)
    min_sync_size: int = 1024

    # -- update sharding (the headline) --------------------------------
    update_sharding: str = "auto"
    #: the heuristic's floor: ``auto`` shards the update only when the
    #: f32 param bytes reach this (below it the optimizer state fits
    #: everywhere and the extra all-gather structure buys nothing)
    zero_min_bytes: int = 4 << 20

    # -- model-declared collectives ------------------------------------
    #: plan entries (reshard_pass schema) for the collectives the MODEL
    #: itself traces — tp activation all-reduces, MoE all-to-alls.  The
    #: trainer merges them with the comm engine's own plan; anything
    #: compiled beyond the merged plan fails the build.
    model_collectives: Sequence[Mapping[str, Any]] = ()

    # -- self-verification ---------------------------------------------
    verify: str = "error"
    hbm_budget: Optional[int] = None
    #: conformance floor for the sharding pass (bytes) — small leaves
    #: (biases, scalars) replicate for free
    min_shard_bytes: int = 1 << 10
    #: unplanned-collective latency tolerance (bytes) forwarded to the
    #: reshard pass
    unplanned_tolerance: int = 4096

    # -- observability ---------------------------------------------------
    #: build a MetricRegistry and fold train/loss (+ train/grad_norm
    #: when tracked) on the device inside the step
    metrics: bool = True
    #: fold the post-sync global gradient norm into the metrics.  Costs
    #: one scalar psum (and one over tp for tp-sharded leaves); turn
    #: off to pin exact collective counts in a declared plan.
    track_grad_norm: bool = False
    #: device→host metric fetch cadence (MetricRegistry fetch_every)
    fetch_every: int = 8

    #: the device this process runs on (the card by default; the CPU
    #: only when asked)
    device: Any = "cuda"

    # ------------------------------------------------------------------
    def __post_init__(self):
        mesh = dict(self.mesh)
        for axis, size in mesh.items():
            if axis not in ("dp", "tp", "pp"):
                raise ValueError(
                    f"unknown mesh axis {axis!r}; the trainer composes "
                    "over dp/tp (pp reserved)"
                )
            if int(size) < 1:
                raise ValueError(f"mesh axis {axis}={size} must be >= 1")
        if int(mesh.get("pp", 1)) != 1:
            raise NotImplementedError(
                "pipeline parallelism (pp) is reserved in TrainConfig: "
                "the axis is part of the schema but the trainer does not "
                "compose it yet — use "
                "apex_tpu.transformer.pipeline_parallel directly"
            )
        comm.check_wire(self.wire)
        if self.param_wire is not None:
            comm.check_wire(self.param_wire)
        if self.update_sharding not in UPDATE_SHARDING_MODES:
            raise ValueError(
                f"update_sharding must be one of {UPDATE_SHARDING_MODES}, "
                f"got {self.update_sharding!r}"
            )
        if self.verify not in VERIFY_LEVELS:
            raise ValueError(
                f"verify must be one of {VERIFY_LEVELS}, "
                f"got {self.verify!r}"
            )
        if not isinstance(self.optimizer, str):
            if not (hasattr(self.optimizer, "init")
                    and hasattr(self.optimizer, "update")):
                raise ValueError(
                    "optimizer must be a name ('adam'/'lamb'/'sgd') or an "
                    "optax-style GradientTransformation with init/update"
                )

    # -- derived ---------------------------------------------------------
    @property
    def dp(self) -> int:
        return int(dict(self.mesh).get("dp", 1))

    @property
    def tp(self) -> int:
        return int(dict(self.mesh).get("tp", 1))

    def mesh_dict(self) -> dict:
        """``{"dp": ..., "tp": ...}`` in rank-grid order — the exact
        mapping every ``expect_sharding``/``expect_plan`` carries."""
        return {"dp": self.dp, "tp": self.tp}

    def optimizer_name(self) -> Optional[str]:
        return self.optimizer if isinstance(self.optimizer, str) else None

"""``apex_tpu_torch.train`` — the single composable entry point for
training (counterpart of :mod:`apex_tpu.train`).

One config composes DDP and ZeRO (through the comm engine), tensor
parallelism (rule-table-placed shards over the ``(dp, tp)`` process
grid), the guarded amp update and the observability meters::

    from apex_tpu_torch.analysis import P
    from apex_tpu_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(
        mesh={"dp": 2, "tp": 2},
        rules=[(r"mlp/kernel", P(None, "tp")),
               (r"attn/out",   P("tp", None)),
               (r".*",         P())],
        wire="int8", optimizer="adam",
    )
    step = Trainer(cfg).build(loss_fn, params, example_batch)
    state, aux = step(step.state, batch)      # one step, global batch
    step.fit(batch_fn, 1000, directory=ckpt)  # run_resilient + goodput

Builds verify themselves (:meth:`TrainStep.verify`: the call log
against the declared plan, the shards' shapes against the rule table,
the memory budget) and a failing build raises :class:`TrainBuildError`.
:func:`params_from_numpy` / :func:`params_to_numpy` carry a parameter
tree (the reference's, as numpy) across.
"""

from apex_tpu_torch.train.config import (  # noqa: F401
    UPDATE_SHARDING_MODES,
    VERIFY_LEVELS,
    TrainConfig,
)
from apex_tpu_torch.train.sharding import (  # noqa: F401
    UpdateShardingDecision,
    decide_update_sharding,
)
from apex_tpu_torch.train.trainer import (  # noqa: F401
    TrainBuildError,
    Trainer,
    TrainStep,
    module_loss,
    module_params,
)
from apex_tpu_torch.train.guarded import (  # noqa: F401
    GuardedStep,
    build_guarded,
)
from apex_tpu_torch.train import demo  # noqa: F401
from apex_tpu_torch.train.demo import build_demo  # noqa: F401
from apex_tpu_torch.models.convert import (  # noqa: F401
    params_from_numpy,
    params_to_numpy,
)

__all__ = [
    "TrainConfig",
    "Trainer",
    "TrainStep",
    "TrainBuildError",
    "UpdateShardingDecision",
    "decide_update_sharding",
    "UPDATE_SHARDING_MODES",
    "VERIFY_LEVELS",
    "GuardedStep",
    "build_guarded",
    "build_demo",
    "demo",
    "module_loss",
    "module_params",
    "params_from_numpy",
    "params_to_numpy",
]

"""Optimizers of the port (counterpart of :mod:`apex_tpu.optimizers`)."""

from apex_tpu_torch.optimizers.fused_adam import (  # noqa: F401
    FusedAdam,
    FusedAdamState,
    fused_adam,
)
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB,
    FusedLAMBState,
    fused_lamb,
)
from apex_tpu_torch.optimizers.multi_tensor import (  # noqa: F401
    axpby,
    global_norm,
    per_tensor_norm,
    scale_with_overflow_check,
)

#: name -> functional factory (``init``/``update`` over dicts of
#: tensors): the registry ``apex_tpu_torch.train.TrainConfig(optimizer=
#: "adam")`` resolves through.  Which of these the trainer can shard
#: across replicas lives with the trainer (``train.sharding.ZERO_TWINS``).
FACTORIES = {
    "adam": fused_adam,
    "lamb": fused_lamb,
}

#: the reference's registered names whose optimizers are not ported yet
_NOT_PORTED = ("adagrad", "novograd", "sgd")


def by_name(name: str):
    """The functional optimizer factory registered under ``name``.  A
    name the reference registers but the port does not have yet raises
    ``NotImplementedError``; any other miss raises ``ValueError`` with the
    available names (a typo'd optimizer must fail the build loudly)."""
    try:
        return FACTORIES[name]
    except KeyError:
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"optimizer {name!r} is not ported yet (ROADMAP item 11); "
                f"have {sorted(FACTORIES)}") from None
        # the reference's message, over the names it registers
        raise ValueError(
            f"unknown optimizer {name!r}; have "
            f"{sorted(set(FACTORIES) | set(_NOT_PORTED))}") from None

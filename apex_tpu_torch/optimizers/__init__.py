"""Optimizers of the port (counterpart of :mod:`apex_tpu.optimizers`).

Two forms per optimizer, as in the reference: the lowercase functional
factory (``fused_sgd(...)``: ``init``/``update`` over dicts of tensors,
what amp's handle and the trainer take) and the CamelCase class
(``FusedAdam`` and ``FusedLAMB`` are ``torch.optim.Optimizer``s; the
others the reference's stateful wrapper, ``step(grads, params)``).
"""

from apex_tpu_torch.optimizers.clip_grad import (  # noqa: F401
    clip_grad_norm,
    clip_grad_norm_,
)
from apex_tpu_torch.optimizers.fused_adagrad import (  # noqa: F401
    FusedAdagrad,
    FusedAdagradState,
    fused_adagrad,
)
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
from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (  # noqa: F401
    FusedMixedPrecisionLamb,
    MixedPrecisionLambState,
    fused_mixed_precision_lamb,
)
from apex_tpu_torch.optimizers.fused_novograd import (  # noqa: F401
    FusedNovoGrad,
    FusedNovoGradState,
    fused_novograd,
)
from apex_tpu_torch.optimizers.fused_sgd import (  # noqa: F401
    FusedSGD,
    FusedSGDState,
    fused_sgd,
)
from apex_tpu_torch.optimizers.larc import LARC, chain, larc  # noqa: F401
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
    "adagrad": fused_adagrad,
    "adam": fused_adam,
    "lamb": fused_lamb,
    "novograd": fused_novograd,
    "sgd": fused_sgd,
}


def by_name(name: str):
    """The functional optimizer factory registered under ``name``;
    raises ``ValueError`` with the available names on a miss (a typo'd
    optimizer must fail the build loudly, not fall back)."""
    try:
        return FACTORIES[name]
    except KeyError:
        raise ValueError(
            f"unknown optimizer {name!r}; have {sorted(FACTORIES)}") from None

"""The canonical dp x tp demo trainer — one program description shared by
the tests and ``chip_smoke.py``.

Counterpart of ``apex_tpu/train/demo.py``: a Megatron-style
tensor-parallel MLP block written directly against
:mod:`apex_tpu_torch.transformer.tensor_parallel.mappings` (``w1``
column-sharded, ``w2`` row-sharded, one forward all-reduce over tp); the
batch shards its rows over dp.  About 0.5 MiB of params, over the
demo's 192 KiB ``zero_min_bytes`` floor, so the update-sharding
heuristic chooses ZeRO on every dp >= 2 arm.

The port draws its parameters with its own generator
(:func:`demo_params`); the tests carry the reference's draw across as
numpy (:func:`apex_tpu_torch.train.params_from_numpy`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.analysis.sharding import P
from apex_tpu_torch.train.config import TrainConfig
from apex_tpu_torch.train.trainer import Trainer, TrainStep

__all__ = [
    "DEMO_DIM",
    "DEMO_HIDDEN",
    "DEMO_ROWS",
    "demo_rules",
    "demo_params",
    "demo_batch",
    "demo_loss",
    "demo_model_collectives",
    "demo_config",
    "build_demo",
]

DEMO_DIM = 128
DEMO_HIDDEN = 512
DEMO_ROWS = 256

#: params ~ 515 KiB globally, ~ 257 KiB per tp = 2 shard — both over this
#: floor, so ``auto`` shards the update at every dp >= 2 arm
DEMO_ZERO_MIN_BYTES = 192 << 10


def demo_rules():
    """The regex -> PartitionSpec table: column-parallel ``w1``/``b1``,
    row-parallel ``w2``, replicated ``b2``."""
    return [
        (r"^w1$", P(None, "tp")),
        (r"^b1$", P("tp")),
        (r"^w2$", P("tp", None)),
        (r"^b2$", P()),
    ]


def demo_params(seed: int = 0, dim: int = DEMO_DIM,
                hidden: int = DEMO_HIDDEN):
    """The GLOBAL demo params (0.05 · N(0, 1) matrices, zero biases) as
    host tensors, drawn from a ``torch.Generator`` seeded with ``seed``
    (the same on every rank); the build moves them to its device."""
    gen = torch.Generator().manual_seed(seed)
    w1 = 0.05 * torch.randn((dim, hidden), generator=gen)
    w2 = 0.05 * torch.randn((hidden, dim), generator=gen)
    return {"w1": w1, "b1": torch.zeros(hidden),
            "w2": w2, "b2": torch.zeros(dim)}


def demo_batch(seed: int = 1, rows: int = DEMO_ROWS, dim: int = DEMO_DIM):
    """A fixed toy regression batch (x, y = x @ w) as host tensors,
    numpy's draw (the reference's, bit for bit)."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(rows, dim).astype(np.float32))
    w = torch.from_numpy((rs.randn(dim, dim) / np.sqrt(dim)).astype(
        np.float32))
    return x, x @ w


def demo_loss(params, batch):
    """Column -> row parallel MLP regression loss on this rank's shards
    and rows; the tp mappings are skipped at tp = 1."""
    from apex_tpu_torch.transformer.tensor_parallel.mappings import (
        copy_to_tensor_model_parallel_region as copy_to,
        reduce_from_tensor_model_parallel_region as reduce_from,
    )

    x, y = batch
    tp = ps.axis_size("tp")
    h = (copy_to(x) if tp > 1 else x) @ params["w1"] + params["b1"]
    h = torch.nn.functional.gelu(h, approximate="tanh")
    out = h @ params["w2"]
    if tp > 1:
        out = reduce_from(out)
    out = out + params["b2"]
    return torch.mean(torch.square(out - y))


def demo_model_collectives(dp: int, tp: int, rows: int = DEMO_ROWS,
                           dim: int = DEMO_DIM):
    """The model's own declared plan entries: with tp > 1 exactly one f32
    all-reduce over tp a step — the row-parallel output reduction of
    (rows/dp, dim) activations (the input copy's backward never runs:
    the batch is not differentiated)."""
    if tp <= 1:
        return []
    act = (rows // max(dp, 1)) * dim * 4
    return [{
        "kind": "all-reduce", "axis": "tp", "count": 1,
        "bytes": [0, act + 1024], "dtypes": ["f32"],
    }]


def demo_config(dp: int, tp: int, *, wire: str = "f32",
                update_sharding: str = "auto", verify: str = "error",
                hbm_budget: Optional[int] = None,
                chunks: Optional[int] = None, optimizer: str = "adam",
                rows: int = DEMO_ROWS, dim: int = DEMO_DIM,
                device="cuda") -> TrainConfig:
    return TrainConfig(
        mesh={"dp": dp, "tp": tp},
        rules=demo_rules(),
        optimizer=optimizer,
        learning_rate=1e-2,
        wire=wire,
        chunks=chunks,
        update_sharding=update_sharding,
        zero_min_bytes=DEMO_ZERO_MIN_BYTES,
        model_collectives=demo_model_collectives(dp, tp, rows, dim),
        verify=verify,
        hbm_budget=hbm_budget,
        device=device,
    )


def build_demo(dp: int, tp: int, *, wire: str = "f32",
               update_sharding: str = "auto", verify: str = "error",
               hbm_budget: Optional[int] = None,
               chunks: Optional[int] = None, optimizer: str = "adam",
               seed: int = 0, rows: int = DEMO_ROWS, dim: int = DEMO_DIM,
               hidden: int = DEMO_HIDDEN, device="cuda",
               params=None, batch=None,
               model_collectives=None) -> TrainStep:
    """Build the demo trainer at (dp, tp) on ``device`` (the card by
    default).  ``params``/``batch`` replace the seeded draws (the tests
    hand in the reference's); ``model_collectives`` replaces the
    declared tp plan (a planted bogus plan must fail the build)."""
    cfg = demo_config(dp, tp, wire=wire, update_sharding=update_sharding,
                      verify=verify, hbm_budget=hbm_budget, chunks=chunks,
                      optimizer=optimizer, rows=rows, dim=dim, device=device)
    if model_collectives is not None:
        cfg.model_collectives = model_collectives
    trainer = Trainer(cfg)
    if params is None:
        params = demo_params(seed, dim, hidden)
    if batch is None:
        batch = demo_batch(seed + 1, rows, dim)
    return trainer.build(demo_loss, params, batch,
                         name=f"train3d/dp{dp}tp{tp}")

"""Per-mode RNG tracking and RNG-correct activation checkpointing.

Counterpart of ``apex_tpu/transformer/tensor_parallel/random.py``
(≙ apex's ``CudaRNGStatesTracker`` / ``get_cuda_rng_tracker`` /
``model_parallel_cuda_manual_seed``).  The JAX tracker is a named
registry of PRNG keys; here it is a named registry of CPU
``torch.Generator``\\ s, the generators the port's dropout draws its
seeds from (``bert_pretrain_loss(..., generator=...)``):

- ``add(name, seed)`` registers a generator seeded with ``seed``;
- ``fork(name)`` hands out that stream's generator (the caller draws
  from it, which advances the stream);
- ``get_states`` / ``set_states`` carry ``generator.get_state()`` byte
  tensors, so a checkpoint pins every stream's position
  (:func:`apex_tpu_torch.checkpoint.snapshot_training_state`).

The bookkeeping is the reference's: the default stream at ``seed``, the
model-parallel stream at ``seed + 2718 + tp_rank``.  The streams are the
port's own — a torch generator cannot reproduce JAX's threefry keys (the
same kept divergence as the sampler's noise, ROADMAP C4).

:func:`to_per_rank_key` folds the tp rank into a seed (or a
generator's seed), the reference's ``fold_in``: dropout inside a
tp-sharded region then differs per rank while replicated regions keep
the shared seed.  :func:`checkpoint` is ``torch.utils.checkpoint`` that
also replays the tracker's streams: the recompute sees each stream as
the forward saw it (the default CPU and CUDA streams are kept by the
checkpoint's ``preserve_rng_state``), so a per-rank dropout stream
draws the same masks again.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.utils.checkpoint

from apex_tpu_torch import parallel_state as ps
from apex_tpu_torch.amp.lists import carry_policy

__all__ = [
    "TPURNGStatesTracker",
    "get_tpu_rng_tracker",
    "get_cuda_rng_tracker",  # parity alias
    "model_parallel_tpu_manual_seed",
    "model_parallel_cuda_manual_seed",  # parity alias
    "to_per_rank_key",
    "checkpoint",
    "_MODEL_PARALLEL_RNG_TRACKER_NAME",
]

_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"
_DEFAULT_RNG_TRACKER_NAME = "default-rng"
_MODEL_PARALLEL_SEED_OFFSET = 2718  # the reference's magic offset


class TPURNGStatesTracker:
    """≙ CudaRNGStatesTracker — a named registry of CPU generators."""

    def __init__(self):
        self._gens: Dict[str, torch.Generator] = {}

    def reset(self):
        self._gens.clear()

    def get_states(self) -> Dict[str, torch.Tensor]:
        """Each stream's ``get_state()`` (a uint8 CPU tensor, a copy)."""
        return {name: g.get_state() for name, g in self._gens.items()}

    def set_states(self, states) -> None:
        """Re-seat the streams from :meth:`get_states`' tensors (a
        stream not registered yet is created)."""
        for name, state in states.items():
            gen = self._gens.get(name)
            if gen is None:
                gen = self._gens[name] = torch.Generator()
            state = torch.as_tensor(state, dtype=torch.uint8).cpu()  # lint: allow(host-sync): host state
            gen.set_state(state)

    def add(self, name: str, seed: int) -> None:
        if name in self._gens:
            raise RuntimeError(f"RNG state {name} already exists")
        self._gens[name] = torch.Generator().manual_seed(int(seed))

    def fork(self, name: str = _MODEL_PARALLEL_RNG_TRACKER_NAME
             ) -> torch.Generator:
        """The named stream's generator; drawing from it advances it."""
        if name not in self._gens:
            raise RuntimeError(f"RNG state {name} is not added")
        return self._gens[name]


_TRACKER = TPURNGStatesTracker()


def get_tpu_rng_tracker() -> TPURNGStatesTracker:
    return _TRACKER


get_cuda_rng_tracker = get_tpu_rng_tracker  # parity alias


def model_parallel_tpu_manual_seed(seed: int, tp_rank: Optional[int] = None
                                   ) -> TPURNGStatesTracker:
    """≙ model_parallel_cuda_manual_seed: registers the default stream at
    ``seed`` and the model-parallel stream at ``seed + 2718 + tp_rank``
    (``tp_rank`` None takes this process's tp rank)."""
    if tp_rank is None:
        tp_rank = ps.axis_rank(ps.TENSOR_PARALLEL_AXIS)
    tracker = get_tpu_rng_tracker()
    tracker.reset()
    tracker.add(_DEFAULT_RNG_TRACKER_NAME, seed)
    tracker.add(_MODEL_PARALLEL_RNG_TRACKER_NAME,
                seed + _MODEL_PARALLEL_SEED_OFFSET + tp_rank)
    return tracker


model_parallel_cuda_manual_seed = model_parallel_tpu_manual_seed  # alias


_MASK31 = (1 << 31) - 1


def _fold(seed: int, rank: int) -> int:
    """A 31-bit mix of (seed, rank) (splitmix64's finalizer): distinct
    ranks give unrelated seeds."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(rank) + 1) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (z ^ (z >> 31)) & _MASK31


def to_per_rank_key(key, axis_name: str = ps.TENSOR_PARALLEL_AXIS):
    """Fold this process's rank on ``axis_name`` into ``key``: an int
    seed gives an int, an int32 seed tensor (the attention kernels'
    ``dropout_seed``) a tensor on its device, a ``torch.Generator`` a
    new generator seeded from its ``initial_seed()``."""
    rank = ps.axis_rank(axis_name)
    if isinstance(key, torch.Generator):
        return torch.Generator(device=key.device).manual_seed(
            _fold(key.initial_seed(), rank))
    if isinstance(key, torch.Tensor):
        words = key.reshape(-1).tolist()  # lint: allow(host-sync): key words
        folded = [_fold(v, rank) for v in words]
        return torch.tensor(folded, dtype=key.dtype,
                            device=key.device).reshape(key.shape)
    return _fold(key, rank)


def checkpoint(function, *args, **kwargs):
    """Activation checkpointing with an RNG-correct recompute
    (≙ ``tensor_parallel.random.checkpoint``): non-reentrant
    ``torch.utils.checkpoint`` with ``preserve_rng_state``, and the
    tracker's streams set back to their forward state for the recompute
    (and restored after it).

    The reference's ``distribute_saved_activations`` is accepted as a
    keyword or as its second positional argument and ignored (a leading
    bool argument of ``function`` is taken for it: close over one)."""
    kwargs.pop("distribute_saved_activations", None)
    if args and isinstance(args[0], bool):
        args = args[1:]
    tracker = get_tpu_rng_tracker()
    saved = tracker.get_states()
    calls = [0]

    def run(*a, **kw):
        calls[0] += 1
        if calls[0] == 1:
            return function(*a, **kw)
        after = tracker.get_states()
        tracker.set_states(saved)
        try:
            return function(*a, **kw)
        finally:
            tracker.set_states(after)

    return torch.utils.checkpoint.checkpoint(
        carry_policy(run), *args, use_reentrant=False,
        preserve_rng_state=True, **kwargs)

"""Per-mode RNG tracking at tensor parallelism 1.

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
``to_per_rank_key`` and the RNG-correct ``checkpoint`` wait for tensor
parallelism (ROADMAP item 5).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = [
    "TPURNGStatesTracker",
    "get_tpu_rng_tracker",
    "get_cuda_rng_tracker",  # parity alias
    "model_parallel_tpu_manual_seed",
    "model_parallel_cuda_manual_seed",  # parity alias
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
            gen.set_state(torch.as_tensor(state, dtype=torch.uint8).cpu())

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
    (``tp_rank`` None counts as 0: the port runs at tp = 1)."""
    tracker = get_tpu_rng_tracker()
    tracker.reset()
    tracker.add(_DEFAULT_RNG_TRACKER_NAME, seed)
    tracker.add(_MODEL_PARALLEL_RNG_TRACKER_NAME,
                seed + _MODEL_PARALLEL_SEED_OFFSET + (tp_rank or 0))
    return tracker


model_parallel_cuda_manual_seed = model_parallel_tpu_manual_seed  # alias

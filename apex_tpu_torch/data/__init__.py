"""Input pipeline — memory-mapped token datasets and a sharded shuffling
loader.

Counterpart of ``apex_tpu/data`` (``write_token_file``,
``synthetic_token_corpus``, ``TokenFileDataset``, ``DataLoader``), kept
as the port's own copy: the same file format, the same shuffle order and
the same batches for the same seed.  Batches are assembled with a numpy
gather where the JAX package calls its native row gather; the result is
the same array.

Layout contract: a *token file* is a flat binary array of token ids
(any integer dtype); samples are consecutive ``seq_len`` windows (the
packed-corpus format of GPT-style training).
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = [
    "DataLoader",
    "TokenFileDataset",
    "gather_rows",
    "synthetic_token_corpus",
    "write_token_file",
]


def write_token_file(path, tokens: np.ndarray) -> None:
    """Write a flat token array as a raw binary token file."""
    np.ascontiguousarray(tokens).ravel().tofile(os.fspath(path))


def synthetic_token_corpus(
    path,
    *,
    vocab_size: int,
    num_tokens: int = 1_000_000,
    floor: int = 0,
    zipf_a: float = 1.3,
    seed: int = 0,
) -> str:
    """Write (once, atomically) a zipf-distributed synthetic token corpus.

    Cached by existence at ``path`` with its generation parameters in a
    ``.meta.json`` sidecar: a file whose sidecar disagrees is rewritten,
    one without a sidecar is reused as it is.  The write goes to a
    pid-suffixed temp name and is ``os.replace``d into place, so an
    interrupted or concurrent first run never leaves a truncated file.
    Token ids land in ``[floor, vocab_size)``, stored as uint16.
    """
    if vocab_size > 2**16:
        raise ValueError(
            f"vocab_size {vocab_size} exceeds the uint16 token format "
            "(ids would silently truncate); use a wider-dtype corpus"
        )
    path = os.fspath(path)
    meta_path = f"{path}.meta.json"
    meta = {
        "vocab_size": vocab_size, "num_tokens": num_tokens,
        "floor": floor, "zipf_a": zipf_a, "seed": seed,
    }
    if os.path.exists(path):
        try:
            with open(meta_path) as f:
                recorded = json.load(f)
        except (OSError, ValueError):
            return path
        if recorded == meta:
            return path
    rng = np.random.default_rng(seed)
    toks = floor + (rng.zipf(zipf_a, size=num_tokens) % (vocab_size - floor))
    tmp = f"{path}.{os.getpid()}.tmp"
    write_token_file(tmp, toks.astype(np.uint16))
    meta_tmp = f"{meta_path}.{os.getpid()}.tmp"
    with open(meta_tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path)
    os.replace(meta_tmp, meta_path)
    return path


def gather_rows(base: np.ndarray, row_starts: np.ndarray,
                row_elems: int) -> np.ndarray:
    """``out[i] = base[row_starts[i] : row_starts[i] + row_elems]`` as one
    contiguous ``(len(row_starts), row_elems)`` array in ``base.dtype``
    (the numpy form of the JAX package's native row gather)."""
    starts = np.asarray(row_starts, dtype=np.int64)
    if starts.size and (
        starts.min() < 0 or starts.max() + row_elems > base.size
    ):
        raise IndexError(
            f"row [{starts.min()}, {starts.max()} + {row_elems}) out of "
            f"bounds for base of {base.size} elements"
        )
    return np.asarray(base[starts[:, None] + np.arange(row_elems)])


class TokenFileDataset:
    """Memory-mapped view of a packed token file as fixed-length samples.

    ``stride`` defaults to ``seq_len`` (disjoint windows); a smaller
    stride yields overlapping windows.  The file is never read eagerly.
    """

    def __init__(self, path, seq_len: int, dtype=np.uint16,
                 stride: Optional[int] = None):
        if seq_len < 1:
            raise ValueError(f"seq_len must be >= 1, got {seq_len}")
        self.path = os.fspath(path)
        self.seq_len = int(seq_len)
        self.stride = self.seq_len if stride is None else int(stride)
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        self.tokens = np.memmap(self.path, dtype=dtype, mode="r")
        if self.tokens.size < self.seq_len:
            raise ValueError(
                f"{self.path}: {self.tokens.size} tokens < seq_len {seq_len}"
            )
        self.num_samples = (self.tokens.size - self.seq_len) // self.stride + 1

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, i: int) -> np.ndarray:
        if not 0 <= i < self.num_samples:
            raise IndexError(i)
        s = i * self.stride
        return np.asarray(self.tokens[s : s + self.seq_len])

    def sample_starts(self, indices: np.ndarray) -> np.ndarray:
        return np.asarray(indices, np.int64) * self.stride


class DataLoader:
    """Sharded, shuffled, epoch-based batch loader.

    - ``shard=(rank, world)``: each rank sees a disjoint 1/world of every
      epoch's shuffled order.
    - The shuffle order is ``seed``- and epoch-deterministic across
      ranks, so all ranks agree on the global permutation and slice it.
    - ``drop_last=True`` keeps every batch the same shape.
    """

    def __init__(
        self,
        dataset: TokenFileDataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        shard: Tuple[int, int] = (0, 1),
        drop_last: bool = True,
    ):
        rank, world = shard
        if not 0 <= rank < world:
            raise ValueError(f"shard rank {rank} not in [0, {world})")
        if not drop_last:
            raise NotImplementedError(
                "drop_last=False would produce a ragged final batch (pad "
                "at the dataset level instead)"
            )
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.rank, self.world = rank, world
        per_rank = len(dataset) // world
        self.batches_per_epoch = per_rank // self.batch_size
        if self.batches_per_epoch < 1:
            raise ValueError(
                f"dataset ({len(dataset)} samples / world {world}) too "
                f"small for batch_size {batch_size}"
            )

    def epoch(self, epoch: int, start: int = 0) -> Iterator[np.ndarray]:
        """Yield this rank's ``(B, S)`` batches for one epoch, starting at
        in-epoch batch index ``start`` (skipped batches are never
        gathered)."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])
            ).permutation(n)
        else:
            order = np.arange(n)
        mine = order[self.rank :: self.world]
        for b in range(start, self.batches_per_epoch):
            idx = mine[b * self.batch_size : (b + 1) * self.batch_size]
            yield gather_rows(self.dataset.tokens,
                              self.dataset.sample_starts(idx),
                              self.dataset.seq_len)

    def iter_from(self, start_batch: int = 0) -> Iterator[np.ndarray]:
        """Endless epoch stream seeked to global batch ``start_batch``."""
        e, b = divmod(start_batch, self.batches_per_epoch)
        while True:
            yield from self.epoch(e, start=b)
            e, b = e + 1, 0

    def __iter__(self) -> Iterator[np.ndarray]:
        """Endless stream over epochs 0, 1, 2, ... (reshuffled each)."""
        return self.iter_from(0)

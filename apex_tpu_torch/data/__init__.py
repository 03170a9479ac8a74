"""Input pipeline — memory-mapped token datasets, a sharded shuffling
loader and the BERT masked-LM batches.

Counterpart of ``apex_tpu/data`` (``write_token_file``,
``synthetic_token_corpus``, ``TokenFileDataset``, ``DataLoader``,
``pack_mlm_predictions``, ``bert_mlm_batches``), kept as the port's own
copy: the same file format, the same shuffle order and the same batches
for the same seed.  Batches are assembled with a numpy gather where the
JAX package calls its native row gather, and the MLM corruption is the
numpy replay of its native ``mlm_mask_batch`` (the same splitmix64
stream); the results are the same arrays.

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
    "bert_mlm_batches",
    "gather_rows",
    "mlm_mask_batch",
    "pack_mlm_predictions",
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


# ---------------------------------------------------------------------------
# BERT masked-LM batches
# ---------------------------------------------------------------------------


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _u01(bits: np.ndarray) -> np.ndarray:
    return (bits >> np.uint64(11)).astype(np.float64) / 9007199254740992.0


def mlm_mask_batch(ids: np.ndarray, seed: int, *, mask_prob: float = 0.15,
                   mask_id: int = 103, vocab_size: int = 30522,
                   special_floor: int = 1000):
    """BERT's 80/10/10 masked-LM corruption of int32 ``ids`` (any shape):
    ``(masked_ids, labels)`` with ``labels = -1`` where a position was
    not selected.  Deterministic in (seed, position) through a
    counter-based splitmix64 stream — the JAX package's numpy replay of
    its native ``mlm_mask_batch``, bit for bit.  Ids below
    ``special_floor`` are never selected."""
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    flat = ids.ravel()
    idx = np.arange(flat.size, dtype=np.uint64)
    r0 = _splitmix64(np.uint64(seed) ^ idx)
    selected = (flat >= special_floor) & (_u01(r0) < mask_prob)
    r1 = _splitmix64(r0)
    action = _u01(r1)
    r2 = _splitmix64(r1)
    rand_tok = special_floor + (
        _splitmix64(r2) % np.uint64(vocab_size - special_floor)
    ).astype(np.int32)
    out = flat.copy()
    out[selected & (action < 0.8)] = mask_id
    mid = selected & (action >= 0.8) & (action < 0.9)
    out[mid] = rand_tok[mid]
    labels = np.where(selected, flat, -1).astype(np.int32)
    return out.reshape(ids.shape), labels.reshape(ids.shape)


def pack_mlm_predictions(labels, max_predictions_per_seq: int = 20,
                         seq_first: bool = True,
                         rng: Optional[np.random.Generator] = None):
    """Dense MLM labels (S, B; -1 = unmasked) -> the fixed-K prediction
    triple ``(positions, label_ids, weights)``, each (K, B) (the BERT
    recipe's masked_lm_positions / masked_lm_ids / masked_lm_weights).

    A sequence with more than K masked positions keeps K of them: chosen
    uniformly by ``rng``, or the first K in position order without one;
    one with fewer is padded with position 0, id 0 and weight 0.  Real
    rows come first, in position order."""
    labels = np.asarray(labels)
    if not seq_first:
        labels = labels.T
    k = max_predictions_per_seq
    mask = labels >= 0
    if rng is None or mask.sum(axis=0).max(initial=0) <= k:
        # a stable sort of ~mask brings the masked rows to the front in
        # position order; the first K per column are kept
        order = np.argsort(~mask, axis=0, kind="stable")[:k]
    else:
        # a random key among masked rows picks a uniform K-subset; the
        # selection is then reordered: real rows in position order, then
        # the pad rows
        key = np.where(mask, rng.random(mask.shape), 2.0)
        sel = np.argsort(key, axis=0)[:k]
        selmask = np.take_along_axis(mask, sel, axis=0)
        rank = np.where(selmask, sel, labels.shape[0] + sel)
        order = np.take_along_axis(
            sel, np.argsort(rank, axis=0, kind="stable"), axis=0)
    weights = np.take_along_axis(mask, order, axis=0)
    if order.shape[0] < k:  # K > S: pad to keep the (K, B) contract
        pad = np.zeros((k - order.shape[0], order.shape[1]), order.dtype)
        order = np.concatenate([order, pad], axis=0)
        weights = np.concatenate([weights, pad.astype(bool)], axis=0)
    ids = np.where(weights, np.take_along_axis(labels, order, axis=0), 0)
    positions = np.where(weights, order, 0)
    return (positions.astype(np.int32), ids.astype(np.int32),
            weights.astype(np.float32))


def bert_mlm_batches(loader: DataLoader, *, seed: int = 0,
                     mask_prob: float = 0.15, mask_id: int = 103,
                     vocab_size: int = 30522, special_floor: int = 1000,
                     seq_first: bool = True, start_step: int = 0,
                     max_predictions_per_seq: Optional[int] = None
                     ) -> Iterator[dict]:
    """Endless BERT phase-1 batches (dicts of numpy arrays) from a token
    loader: the MLM corruption of :func:`mlm_mask_batch`, deterministic in
    (seed, step, position), ``token_type_ids`` of zeros, an
    ``attention_mask`` of ones, pseudo-random NSP labels, seq-first by
    default.  ``start_step`` seeks the stream (batch N of a resumed
    stream is batch N of an uninterrupted one).  With
    ``max_predictions_per_seq`` each batch also carries the
    ``mlm_positions`` / ``mlm_label_ids`` / ``mlm_weights`` triple of
    :func:`pack_mlm_predictions`."""
    step = start_step
    for tokens in loader.iter_from(start_step):
        ids = tokens.astype(np.int32)
        # a full 64-bit (seed, step) mix: injective in step for one seed
        mix = (seed * 0x9E3779B97F4A7C15 + step) & 0xFFFFFFFFFFFFFFFF
        masked, labels = mlm_mask_batch(
            ids, mix, mask_prob=mask_prob, mask_id=mask_id,
            vocab_size=vocab_size, special_floor=special_floor,
        )
        if seq_first:
            masked, labels = masked.T, labels.T
        b = tokens.shape[0]
        # NSP labels: pseudo-random 0/1 per (seed, step), so the head
        # trains against a non-constant objective
        nsp = np.random.default_rng(
            np.random.SeedSequence([seed, step, 0x4E53])
        ).integers(0, 2, size=(b,)).astype(np.int32)
        out = {
            "input_ids": masked,
            "token_type_ids": np.zeros_like(masked),
            "attention_mask": np.ones(
                (b, masked.shape[0] if seq_first else masked.shape[1]),
                np.int32,
            ),
            "mlm_labels": labels,
            "nsp_labels": nsp,
        }
        if max_predictions_per_seq:
            pos, pids, w = pack_mlm_predictions(
                labels, max_predictions_per_seq, seq_first=seq_first,
                # deterministic in (seed, step), apart from the
                # corruption stream
                rng=np.random.default_rng(
                    np.random.SeedSequence([seed, step, 0x4D50])
                ),
            )
            if not seq_first:
                pos, pids, w = pos.T, pids.T, w.T
            out.update(mlm_positions=pos, mlm_label_ids=pids, mlm_weights=w)
        yield out
        step += 1

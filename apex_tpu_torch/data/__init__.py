"""Input pipeline — memory-mapped token datasets, a sharded shuffling
loader and the BERT masked-LM batches.

Counterpart of ``apex_tpu/data`` (``write_token_file``,
``synthetic_token_corpus``, ``TokenFileDataset``, ``DataLoader``,
``pack_mlm_predictions``, ``bert_mlm_batches``, ``DevicePrefetcher``),
kept as the port's own copy: the same file format, the same shuffle order and the same batches
for the same seed.  Batches are gathered and the MLM corruption applied
by the port's native host ops (:mod:`apex_tpu_torch._native`, where the
JAX package calls its own); ``gather_rows`` and ``mlm_mask_batch`` are
re-exported from there.

Layout contract: a *token file* is a flat binary array of token ids
(any integer dtype); samples are consecutive ``seq_len`` windows (the
packed-corpus format of GPT-style training).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch import _native
from apex_tpu_torch._native import gather_rows, mlm_mask_batch  # noqa: F401

__all__ = [
    "DataLoader",
    "DevicePrefetcher",
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
            yield _native.gather_rows(self.dataset.tokens,
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
        masked, labels = _native.mlm_mask_batch(
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


def _tree_map(fn, tree):
    """``fn`` over the arrays of a batch: a dict, list or tuple of them,
    nested, or one array."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class DevicePrefetcher:
    """Background host-to-device prefetch: a worker thread stays
    ``depth`` batches ahead of the consumer, copying each batch onto
    ``device`` while the step runs on the card.

    Wraps any iterator of batches (numpy arrays or CPU tensors, or
    dicts, lists and tuples of them); yields the same structure as
    tensors on ``device`` (the card by default; ``device="cpu"`` only
    converts).  On the card each array goes through pinned host memory
    with a ``non_blocking`` copy on the prefetcher's own stream; the
    consumer's stream waits for that copy's event before it reads the
    batch, and the batch's memory is recorded on the consumer's stream
    so the allocator does not reuse it early.

    Backpressure is bounded: the hand-off queue holds at most ``depth``
    batches, so a consumer that stops pulling stalls the worker instead
    of buffering the dataset.  :attr:`stall_fraction` is the share of
    wall time the consumer spent blocked on an empty queue (the
    input-bound signal), and :meth:`metrics` adds the producer's wait
    and the queue's occupancy.  From the 8th batch on the fraction is
    published on the board under ``board_key`` (None publishes nothing:
    give a second prefetcher, e.g. an eval loader, ``None`` so that it
    does not overwrite the training input's gauge).  Call :meth:`close`
    (or use the prefetcher as a context manager) to stop the worker.
    """

    _DONE = object()

    def __init__(self, it, device="cuda", depth: int = 2, *,
                 board_key: Optional[str] = "data/input_stall_fraction"):
        from apex_tpu_torch.ops._dispatch import resolve_device

        self._device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._src = iter(it)
        self.board_key = board_key
        self._t0 = time.monotonic()
        self._consumer_wait_s = 0.0  # queue empty: input-bound
        self._producer_wait_s = 0.0  # queue full: compute-bound (healthy)
        self._batches = 0
        self._occupancy_sum = 0.0
        # the one field both threads touch: the worker adds to it,
        # metrics() reads it from the consumer
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._fill, daemon=True)
        self._worker.start()

    def _to_device(self, batch):
        """The batch on the device, and the event its copies end at (None
        off the card)."""
        def put(x):
            t = torch.as_tensor(x)
            if self._stream is None:
                return t.to(self._device)
            return t.pin_memory().to(self._device, non_blocking=True)

        if self._stream is None:
            return _tree_map(put, batch), None
        with torch.cuda.stream(self._stream):
            out = _tree_map(put, batch)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _put(self, item) -> bool:
        """Enqueue with stop-aware timeout polling; False when stopped
        (an unbounded blocking put could pin the worker forever if the
        consumer abandons iteration without close())."""
        t0 = time.monotonic()
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                with self._lock:
                    self._producer_wait_s += time.monotonic() - t0
                return True
            except queue.Full:
                continue
        return False

    def _fill(self):
        try:
            for batch in self._src:
                if self._stop.is_set():
                    return
                if not self._put(self._to_device(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            self._put(e)
            return
        self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        # stop-aware polling get, as _put: an untimed get could hang if
        # close() drains the sentinel from another thread
        t0 = time.monotonic()
        self._occupancy_sum += self._q.qsize() / self._q.maxsize
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                continue
        if self._batches == 0:
            # the first fetch waits on the worker's start and first fill:
            # warm-up, not a steady-state stall; the clock starts here
            self._t0 = time.monotonic()
        else:
            self._consumer_wait_s += time.monotonic() - t0
        if item is self._DONE:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        self._batches += 1
        # publish once the fraction means something: the first batches'
        # worker start over a near-zero wall time would read as a stall
        if self.board_key is not None and self._batches >= 8:
            from apex_tpu_torch.observability.metrics import board

            board.set(self.board_key, self.stall_fraction)
        batch, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(done)
            _tree_map(lambda t: t.record_stream(consumer), batch)
        return batch

    @property
    def stall_fraction(self) -> float:
        """Share of wall time the consumer spent blocked on an empty
        prefetch queue."""
        wall = time.monotonic() - self._t0
        return min(1.0, self._consumer_wait_s / wall) if wall > 0 else 0.0

    def metrics(self) -> dict:
        """The pipeline-balance ledger: consumer stall (input-bound),
        producer wait (compute-bound backpressure, healthy), mean queue
        occupancy at fetch, batches served."""
        with self._lock:
            producer_wait_s = self._producer_wait_s
        return {
            "batches": self._batches,
            "stall_fraction": self.stall_fraction,
            "consumer_wait_s": self._consumer_wait_s,
            "producer_wait_s": producer_wait_s,
            "mean_occupancy": (
                self._occupancy_sum / self._batches if self._batches else 0.0
            ),
            "depth": self._q.maxsize,
        }

    def close(self) -> None:
        """Stop the worker and wait for it to exit."""
        self._stop.set()
        # drain so a blocked put() can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._worker.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

"""Checkpoint / resume on ``torch.distributed.checkpoint``.

Counterpart of ``apex_tpu/checkpoint/__init__.py``.  The JAX package
writes through orbax; the port writes each checkpoint with
``torch.distributed.checkpoint`` (DCP, shipped with PyTorch) with
``no_dist=True``: each process writes its own files.  A state is any tree of
dicts, lists and tuples whose leaves are tensors (CPU or CUDA), numpy
arrays or scalars, and Python scalars.  The tree's structure and every
non-tensor leaf go into ``tree.json`` beside DCP's files; tensors and
numpy arrays go through DCP.

Surface (as the reference's):

- :func:`save_checkpoint` / :func:`restore_checkpoint` — one-shot save
  and restore.  With a ``template`` (the same tree, e.g. the live
  training state) every tensor leaf is loaded **in place** into the
  template's tensor, on the template's device; without one, tensors
  come back as CPU tensors and numpy arrays as numpy arrays.
- :func:`latest_step` / :func:`all_steps` / :func:`restore_step_dir` —
  read-only scans of a step-numbered directory.
- :class:`CheckpointManager` — step-numbered checkpoints with
  ``max_to_keep`` / ``save_interval_steps`` (orbax's policy: the first
  save, then every step divisible by the interval).
- :func:`snapshot_training_state` / :func:`restore_training_state` —
  params + optimizer state + step + the amp scaler's state + the RNG
  tracker's states + the stream cursor in one tree.

**Several processes.**  When ``torch.distributed`` runs a world of more
than one process, a save is collective: every rank calls it with its
own state, in the same order.  A subtree wrapped in :class:`PerRank`
(:func:`per_rank`) holds this rank's own shards — the ZeRO flat
optimizer state — and every rank writes it into ``rank<r>/`` of the
step; every other leaf is replicated and only rank 0 writes it (into
``rank0/``, with ``tree.json``).  The ranks then report to each other
over a gloo group of their own (a flag all-reduced with max): only when
every rank has finished does rank 0 write the commit marker and rename
the staging directory, and a second round returns every rank after the
step is visible.  A rank that fails (or dies) mid-save leaves no
committed step.  A restore (same world) reads the replicated leaves from
``rank0/`` and each rank's own shards from ``rank<r>/``.

**The commit-marker rule.**  Every step is written into a staging
directory ``<step>.apex-ckpt-tmp-<pid>-<n>``; the commit marker
(``commit_success.txt``) is written last, and only then is the staging
directory renamed to ``<step>``.  :func:`all_steps` counts only
digit-named directories that carry a marker (any of the reference's
marker names), so debris — the port's staging directories, orbax-style
``*.orbax-checkpoint-tmp-*`` directories (what the chaos ``partial``
mode drops), half-written step directories — stays invisible and resume
falls back to the last complete step.  The manager and
:class:`~apex_tpu_torch.goodput.AsyncCheckpointEngine` write the same
flat layout, so :func:`restore_step_dir` restores a step of either.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import warnings
from typing import Any, List, Optional

import numpy as np
import torch

__all__ = [
    "PerRank",
    "per_rank",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "all_steps",
    "restore_step_dir",
    "CheckpointManager",
    "snapshot_training_state",
    "restore_training_state",
]

#: files whose presence at the top of a step directory proves the save
#: committed: the port writes ``commit_success.txt``; the others are the
#: orbax markers the reference's scan also accepts
_COMMIT_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "commit_success.txt")
_MARKER = "commit_success.txt"
_TREE = "tree.json"
#: the port's staging-directory infix (``<step>.apex-ckpt-tmp-<pid>-<n>``)
STAGING_INFIX = ".apex-ckpt-tmp-"
_STAGING_IDS = itertools.count()


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


#: files DCP writes a checkpoint into, one writer thread each
_WRITE_THREADS = 4
#: DCP warns on every call that it assumes one process, as asked
_ONE_PROCESS = "torch.distributed is disabled, unavailable or uninitialized"


def _abspath(path) -> str:
    return os.path.abspath(os.fspath(path))


class PerRank:
    """A subtree holding this rank's own shards (each rank saves and
    restores its own); any tree of dicts, lists, tuples and tensors.
    In one process it is saved like any other subtree."""

    __slots__ = ("tree",)

    def __init__(self, tree):
        self.tree = tree

    def __repr__(self) -> str:
        return f"PerRank({self.tree!r:.60})"


def per_rank(tree) -> PerRank:
    """Mark ``tree`` as this rank's own shards (see :class:`PerRank`)."""
    return tree if isinstance(tree, PerRank) else PerRank(tree)


def _world():
    """``(rank, world)`` of the default process group ((0, 1) without
    one)."""
    d = torch.distributed
    if d.is_available() and d.is_initialized() and d.get_world_size() > 1:
        return d.get_rank(), d.get_world_size()
    return 0, 1


_GROUP = None


def checkpoint_group():
    """A gloo group over the whole world for the saves' coordination
    (created on first use, collectively, on the calling thread): kept
    apart from the training collectives, so a background writer's
    rounds never interleave with a step's.  None in one process."""
    global _GROUP
    if _world()[1] == 1:
        return None
    if _GROUP is None:
        _GROUP = torch.distributed.new_group(backend="gloo")
    return _GROUP


# ---------------------------------------------------------------------------
# the tree codec: structure and scalars in tree.json, arrays through DCP
# ---------------------------------------------------------------------------


def _encode(node, leaves: List[torch.Tensor], ranked=None):
    """``node``'s ``tree.json`` entry; its arrays are appended to
    ``leaves`` (and, inside a :class:`PerRank`, their indices to
    ``ranked``)."""
    if isinstance(node, PerRank):
        if ranked is None:
            ranked = set()
        start = len(leaves)
        enc = _encode(node.tree, leaves, ranked)
        ranked.update(range(start, len(leaves)))
        return {"per_rank": enc}
    if isinstance(node, torch.Tensor):
        leaves.append(node.detach())
        return {"tensor": len(leaves) - 1}
    if isinstance(node, (np.ndarray, np.generic)):
        arr = np.asarray(node)
        if not arr.flags.c_contiguous:
            arr = arr.copy()
        leaves.append(torch.from_numpy(arr))
        return {"numpy": len(leaves) - 1, "dtype": arr.dtype.str}
    if isinstance(node, dict):
        for key in node:
            if not isinstance(key, str):
                raise TypeError(f"checkpoint dict keys must be str, got "
                                f"{key!r}")
        return {"dict": [[k, _encode(v, leaves, ranked)]
                         for k, v in node.items()]}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_encode(v, leaves, ranked) for v in node]}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    raise TypeError(f"cannot checkpoint a leaf of type {type(node).__name__}")


def _decode(node, tensors, template=None):
    """Rebuild one node from ``tree.json`` and the loaded ``tensors``;
    a template tensor was loaded in place and is returned itself."""
    if "per_rank" in node:
        return PerRank(_decode(node["per_rank"], tensors, None if template
                               is None else per_rank(template).tree))
    if "tensor" in node:
        return tensors[node["tensor"]]
    if "numpy" in node:
        return tensors[node["numpy"]].numpy().astype(np.dtype(node["dtype"]),
                                                     copy=False)
    if "value" in node:
        return node["value"]
    if "dict" in node:
        return {k: _decode(v, tensors, None if template is None
                           else template.get(k)) for k, v in node["dict"]}
    kind = "list" if "list" in node else "tuple"
    children = [_decode(v, tensors, None if template is None else t)
                for v, t in zip(node[kind], template if template is not None
                                else [None] * len(node[kind]))]
    if kind == "list":
        return children
    if template is not None and hasattr(template, "_fields"):
        return type(template)(*children)  # a NamedTuple, as templated
    return tuple(children)


def _targets(node, template, path, out):
    """Pair every tensor leaf of the saved tree with the template's tensor
    at the same place (``out[index] = tensor``), checking the structure."""
    if template is None:
        return
    where = "/".join(path) or "<root>"
    if "per_rank" in node:
        _targets(node["per_rank"], per_rank(template).tree, path, out)
    elif "dict" in node:
        if not isinstance(template, dict):
            raise ValueError(f"{where}: the checkpoint has a dict, the "
                             f"template a {type(template).__name__}")
        saved = [k for k, _ in node["dict"]]
        missing = sorted(set(template) - set(saved))
        if missing:
            raise ValueError(f"{where}: the template's keys {missing} are "
                             f"not in the checkpoint")
        for k, v in node["dict"]:
            _targets(v, template.get(k), path + [k], out)
    elif "list" in node or "tuple" in node:
        items = node.get("list", node.get("tuple"))
        if not isinstance(template, (list, tuple)) or len(template) != len(
                items):
            raise ValueError(f"{where}: a sequence of {len(items)} in the "
                             f"checkpoint, {template!r:.60} in the template")
        for i, (v, t) in enumerate(zip(items, template)):
            _targets(v, t, path + [str(i)], out)
    elif "tensor" in node and isinstance(template, torch.Tensor):
        out[node["tensor"]] = template


def _dcp_save(tensors: dict, directory: str) -> None:
    if not tensors:
        return
    dcp = _dcp()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_ONE_PROCESS)
        dcp.save(tensors, storage_writer=dcp.FileSystemWriter(
            directory, thread_count=_WRITE_THREADS), no_dist=True)


def _write_synced(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(path, state, *, force: bool = False,
                    group=None) -> None:
    """Write ``state`` to ``path``: staged, marked, then renamed into
    place (the commit-marker rule).  An existing checkpoint at ``path``
    raises unless ``force``, which replaces it.  In a world of several
    processes every rank calls it (see the module docstring); ``group``
    is the gloo group the ranks report over (default
    :func:`checkpoint_group`)."""
    path = _abspath(path)
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} already exists")
    rank, world = _world()
    if world > 1:
        _save_ranks(path, state, rank, world, group or checkpoint_group())
        return
    staging = f"{path}{STAGING_INFIX}{os.getpid()}-{next(_STAGING_IDS)}"
    shutil.rmtree(staging, ignore_errors=True)
    os.makedirs(staging)
    leaves: List[torch.Tensor] = []
    tree = _encode(state, leaves)
    _dcp_save({str(i): t for i, t in enumerate(leaves)}, staging)
    for name, text in ((_TREE, json.dumps(tree)), (_MARKER, "committed\n")):
        _write_synced(os.path.join(staging, name), text)
    _commit(staging, path)


def _commit(staging: str, path: str) -> None:
    """Rename a marked staging directory into place (replacing
    ``path``)."""
    if os.path.exists(path):
        old = f"{path}{STAGING_INFIX}old-{os.getpid()}-{next(_STAGING_IDS)}"
        os.rename(path, old)
        shutil.rmtree(old, ignore_errors=True)
    os.rename(staging, path)
    fd = os.open(os.path.dirname(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _round(flag: int, group) -> int:
    """One coordination round: the max over the ranks of ``flag``."""
    from apex_tpu_torch.parallel import comm

    t = torch.tensor([flag], dtype=torch.int64)
    comm.all_reduce(t, group, op="max")
    return int(t.item())


#: test hook: called with the rank just before it writes its files (a
#: planted failure stands for a rank that dies mid-save)
_rank_write_hook = None


def _save_ranks(path: str, state, rank: int, world: int, group) -> None:
    """The collective save: each rank writes its files, the ranks report,
    rank 0 commits only if every rank finished, a second round returns
    every rank after the commit."""
    from apex_tpu_torch.parallel import comm

    token = torch.tensor([os.getpid(), next(_STAGING_IDS)], dtype=torch.int64)
    comm.broadcast(token, 0, group)  # every rank stages into rank 0's name
    staging = f"{path}{STAGING_INFIX}{token[0].item()}-{token[1].item()}-w"
    failed = 0
    try:
        os.makedirs(staging, exist_ok=True)
        if _rank_write_hook is not None:
            _rank_write_hook(rank)
        leaves: List[torch.Tensor] = []
        ranked: set = set()
        tree = _encode(state, leaves, ranked)
        mine = {str(i): t for i, t in enumerate(leaves)
                if i in ranked or rank == 0}
        _dcp_save(mine, os.path.join(staging, f"rank{rank}"))
        if rank == 0:
            _write_synced(os.path.join(staging, _TREE), json.dumps(
                {"world": world, "ranked": sorted(ranked), "root": tree}))
    except Exception:
        failed = 1
        if _round(failed, group):
            raise
    if _round(failed, group):
        if rank == 0:
            shutil.rmtree(staging, ignore_errors=True)
        raise RuntimeError(
            f"checkpoint {path}: a rank failed to write its files; the step "
            "was not committed")
    if rank == 0:
        try:
            _write_synced(os.path.join(staging, _MARKER), "committed\n")
            _commit(staging, path)
        except Exception:
            failed = 1
            _round(failed, group)
            raise
    if _round(failed, group):
        raise RuntimeError(f"checkpoint {path}: rank 0 failed to commit")


def restore_checkpoint(path, template: Optional[Any] = None):
    """Restore the tree at ``path``.  With ``template`` (a tree of the
    same structure; a dict of the checkpoint may hold keys the template
    lacks, restored as without one) each tensor leaf is loaded in place
    into the template's tensor — same shape and dtype required, on its
    device — and returned; the other leaves come back as saved.  Without
    a template, tensors come back as CPU tensors."""
    path = _abspath(path)
    with open(os.path.join(path, _TREE)) as f:
        tree = json.load(f)
    targets: dict = {}
    if "world" in tree:  # written by several processes
        rank, world = _world()
        if world != tree["world"]:
            raise ValueError(
                f"checkpoint {path} was written by {tree['world']} "
                f"processes; this world has {world}")
        ranked = set(tree["ranked"])
        tree = tree["root"]
        _targets(tree, template, [], targets)
        # the replicated leaves from rank 0's files, this rank's shards
        # from its own
        tensors = _dcp_load(os.path.join(path, "rank0"), targets,
                            lambda i: i not in ranked)
        tensors.update(_dcp_load(os.path.join(path, f"rank{rank}"),
                                 targets, lambda i: i in ranked))
    else:
        _targets(tree, template, [], targets)
        tensors = _dcp_load(path, targets)
    return _decode(tree, tensors, template)


def _dcp_load(directory: str, targets: dict, keep=None) -> dict:
    """The tensors of one DCP directory (the indices ``keep`` accepts),
    each loaded in place into its template tensor where it has one."""
    if not os.path.exists(os.path.join(directory, ".metadata")):
        return {}
    dcp = _dcp()
    reader = dcp.FileSystemReader(directory)
    tensors = {}
    for key, md in reader.read_metadata().state_dict_metadata.items():
        i = int(key)
        if keep is not None and not keep(i):
            continue
        t = targets.get(i)
        if t is None:
            t = torch.empty(tuple(md.size), dtype=md.properties.dtype)
        elif tuple(t.shape) != tuple(md.size) or t.dtype != md.properties.dtype:
            raise ValueError(
                f"template leaf {i}: {tuple(t.shape)} {t.dtype}, the "
                f"checkpoint holds {tuple(md.size)} {md.properties.dtype}")
        tensors[i] = t
    if tensors:
        with torch.no_grad(), warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=_ONE_PROCESS)
            dcp.load({str(i): t for i, t in tensors.items()},
                     storage_reader=reader, no_dist=True)
    return tensors


# ---------------------------------------------------------------------------
# step-numbered directories
# ---------------------------------------------------------------------------


def _is_complete_step_dir(path: str) -> bool:
    """A step directory counts only with a commit marker on board (at its
    top, or inside an orbax manager layout's ``default/``)."""
    return any(os.path.exists(os.path.join(path, m))
               or os.path.exists(os.path.join(path, "default", m))
               for m in _COMMIT_MARKERS)


def all_steps(directory) -> List[int]:
    """COMPLETE step numbers under ``directory`` (read-only; [] if
    absent): digit-named directories that carry a commit marker."""
    directory = _abspath(directory)
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name) for name in os.listdir(directory)
        if name.isdigit() and os.path.isdir(os.path.join(directory, name))
        and _is_complete_step_dir(os.path.join(directory, name))
    )


def latest_step(directory) -> Optional[int]:
    """Newest COMPLETE step under ``directory`` (None if absent/empty);
    a missing directory is not created."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore_step_dir(directory, step: int, *, template=None):
    """Restore step ``step`` of ``directory``: written by
    :class:`CheckpointManager` or by the async engine (one layout)."""
    base = os.path.join(_abspath(directory), str(int(step)))
    if not _is_complete_step_dir(base):
        raise FileNotFoundError(
            f"step {step} under {directory} is missing or incomplete "
            "(no commit marker — a half-written checkpoint)"
        )
    return restore_checkpoint(base, template)


class CheckpointManager:
    """Step-numbered checkpoints with retention (``max_to_keep``) and the
    orbax interval policy: a step is saved when it is newer than every
    saved step and either the first save or divisible by
    ``save_interval_steps``.  Saves are written on the calling thread
    (the async engine is :class:`apex_tpu_torch.goodput.
    AsyncCheckpointEngine`); ``wait_until_finished`` and ``close`` have
    nothing left to wait for.

    >>> with CheckpointManager(d, max_to_keep=2, save_interval_steps=8) as m:
    ...     m.save(step, snapshot_training_state(params, opt_state, step=step))
    """

    def __init__(self, directory, *, max_to_keep: Optional[int] = None,
                 save_interval_steps: int = 1):
        if save_interval_steps < 1:
            raise ValueError("save_interval_steps must be >= 1")
        self.directory = _abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._interval = int(save_interval_steps)
        self._steps = set(all_steps(self.directory))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        pass

    def wait_until_finished(self):
        pass

    def should_save(self, step: int) -> bool:
        if self._steps and max(self._steps) >= step:
            return False
        return not self._steps or step % self._interval == 0

    def save(self, step: int, state, *, force: bool = False) -> bool:
        """Write ``state`` at ``step``; False when the policy skips it
        (``force`` bypasses the policy)."""
        if not force and not self.should_save(step):
            return False
        save_checkpoint(os.path.join(self.directory, str(int(step))), state,
                        force=force)
        self._steps.add(int(step))
        rank, world = _world()
        try:
            if self._max_to_keep is not None and rank == 0:
                steps = all_steps(self.directory)
                for s in steps[: max(0, len(steps) - self._max_to_keep)]:
                    shutil.rmtree(os.path.join(self.directory, str(s)),
                                  ignore_errors=True)
        finally:
            if world > 1:
                # every rank returns after rank 0's retention prune
                _round(0, checkpoint_group())
        return True

    def restore(self, step: Optional[int] = None, *, template=None):
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under "
                                        f"{self.directory}")
        return restore_step_dir(self.directory, step, template=template)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def all_steps(self) -> List[int]:
        return all_steps(self.directory)


# ---------------------------------------------------------------------------
# the training state in one tree
# ---------------------------------------------------------------------------


def snapshot_training_state(params, opt_state=None, *,
                            step: Optional[int] = None, amp_handle=None,
                            amp_state=None, stream=None,
                            extra=None) -> dict:
    """One checkpointable tree of everything a resume needs: ``params``
    and ``opt_state`` (trees of tensors), ``step``, the amp scaler's
    state (``amp_handle.state_dict(amp_state)`` under ``"amp"``: loss
    scale, growth tracker, hysteresis; the masters live in
    ``amp_state.master_params``, pass them or the whole ``AmpState`` as
    ``extra``), the RNG tracker's generator states (captured
    automatically), the stream cursor
    (:meth:`apex_tpu_torch.goodput.ResumableStream.state`) and ``extra``.
    Pass the live tensors (``p.detach()``) and restore with this tree as
    the template to load them back in place."""
    from apex_tpu_torch.transformer.tensor_parallel.random import (
        get_tpu_rng_tracker,
    )

    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    if step is not None:
        state["step"] = np.asarray(step, np.int64)
    if amp_handle is not None and amp_state is not None:
        state["amp"] = amp_handle.state_dict(amp_state)
    rng = get_tpu_rng_tracker().get_states()
    if rng:
        state["rng"] = rng
    if stream is not None:
        state["stream"] = stream
    if extra is not None:
        state["extra"] = extra
    return state


def restore_training_state(restored: dict, *, amp_handle=None,
                           amp_state=None):
    """Unpack a :func:`snapshot_training_state` tree after restore:
    re-seats the RNG tracker's streams and, given ``amp_handle`` and an
    ``amp_state`` to update, the amp scaler's state
    (``amp_handle.load_state_dict``); returns ``(params, opt_state,
    step, amp_state, extra)`` with None for absent pieces."""
    from apex_tpu_torch.transformer.tensor_parallel.random import (
        get_tpu_rng_tracker,
    )

    if "rng" in restored:
        get_tpu_rng_tracker().set_states(restored["rng"])
    new_amp_state = None
    if amp_handle is not None and amp_state is not None and "amp" in restored:
        new_amp_state = amp_handle.load_state_dict(amp_state,
                                                   restored["amp"])
    step = restored.get("step")
    return (restored.get("params"), restored.get("opt_state"),
            int(step) if step is not None else None, new_amp_state,
            restored.get("extra"))

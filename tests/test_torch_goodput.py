"""apex_tpu_torch.goodput on the CPU, against the JAX package's where the
two can be held side by side.

- the async engine, the cases of tests/test_goodput.py: snapshot
  isolation, dtypes kept, interval and retention (the reference's flags,
  steps and counts), save returning before the write lands, queue depth
  resolution, a mid-write crash keeping the previous step, a deferred
  error at the next save, a writer bootstrap failure that does not
  deadlock, phase spans in the events, close draining; queued snapshots
  owning their buffers under a queue deeper than one; the sync manager's
  snapshot isolation;
- streams: ``stream_state`` dicts equal to the reference's,
  ``verify_stream_state`` raising on the same mismatches, and
  ``ResumableStream(step)`` batches equal to the reference's bit for bit
  across reseeks, with and without prefetch.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import checkpoint as ref_ckpt
from apex_tpu import data as ref_data
from apex_tpu import goodput as ref_goodput
from apex_tpu_torch import checkpoint as port_ckpt
from apex_tpu_torch import data as port_data
from apex_tpu_torch.goodput import (
    AsyncCheckpointEngine,
    ResumableStream,
    StreamStateError,
    host_snapshot,
    resolve_queue_depth,
    stream_state,
    verify_stream_state,
)
from apex_tpu_torch.resilience import ResilientCheckpointManager


# ---------------------------------------------------------------------------
# host_snapshot
# ---------------------------------------------------------------------------


def test_host_snapshot_isolates_mutation():
    arr = np.arange(4.0, dtype=np.float32)
    t = torch.arange(3.0)
    snap = host_snapshot({"a": arr, "t": t, "s": 3, "g": np.int64(2)})
    arr[:] = -1.0
    t.fill_(-1.0)
    np.testing.assert_array_equal(snap["a"], [0.0, 1.0, 2.0, 3.0])
    assert snap["t"].tolist() == [0.0, 1.0, 2.0]
    assert snap["s"] == 3
    assert isinstance(snap["g"], np.ndarray) and snap["g"].shape == ()


def test_host_snapshot_preserves_dtypes():
    snap = host_snapshot({"bf": torch.ones(3, dtype=torch.bfloat16),
                          "i": np.asarray(7, np.int64),
                          "u8": torch.arange(4, dtype=torch.uint8)})
    assert snap["bf"].dtype == torch.bfloat16
    assert snap["i"].dtype == np.int64
    assert snap["u8"].dtype == torch.uint8


# ---------------------------------------------------------------------------
# AsyncCheckpointEngine
# ---------------------------------------------------------------------------


def test_engine_interval_and_retention_match_the_reference(tmp_path):
    got = {}
    for name, eng_cls, leaf in (
            ("ref", ref_goodput.AsyncCheckpointEngine, jnp.arange(4.0)),
            ("port", AsyncCheckpointEngine, torch.arange(4.0))):
        with eng_cls(tmp_path / name, max_to_keep=2,
                     save_interval_steps=2) as eng:
            saved = [eng.save(s, {"w": leaf + s,
                                  "n": np.asarray(0, np.int64)})
                     for s in range(6)]
            eng.wait_until_finished()
            st = eng.stats()
            out = eng.restore(template={"w": leaf * 0,
                                        "n": np.asarray(0, np.int64)})
            got[name] = (saved, eng.all_steps(), eng.latest_step(),
                         np.asarray(out["w"]).tolist(),
                         (st["saves"], st["writes"], st["failures"]))
    assert got["port"] == got["ref"]
    assert got["port"][1] == [2, 4]


def test_engine_save_returns_before_write_lands(tmp_path):
    gate = threading.Event()
    eng = AsyncCheckpointEngine(tmp_path)
    eng._commit_hook = lambda step: gate.wait(timeout=30)
    try:
        assert eng.save(0, {"w": torch.ones(2)})
        assert eng.latest_step() is None
        gate.set()
        eng.wait_until_finished()
        assert eng.latest_step() == 0
    finally:
        gate.set()
        eng.close()


def test_engine_queue_depth_resolution(tmp_path, monkeypatch):
    monkeypatch.delenv("APEX_TPU_CKPT_QUEUE", raising=False)
    got = [resolve_queue_depth(), resolve_queue_depth(9),
           resolve_queue_depth(0)]
    assert got == [ref_goodput.resolve_queue_depth(),
                   ref_goodput.resolve_queue_depth(9),
                   ref_goodput.resolve_queue_depth(0)] == [4, 9, 1]
    monkeypatch.setenv("APEX_TPU_CKPT_QUEUE", "16")
    assert resolve_queue_depth() == resolve_queue_depth(2) == 16
    eng = AsyncCheckpointEngine(tmp_path, queue_depth=2)
    try:
        assert eng._q.maxsize == 16
    finally:
        eng.close()


def test_engine_mutation_after_save_is_invisible(tmp_path):
    with AsyncCheckpointEngine(tmp_path) as eng:
        arr = np.ones((8,), np.float32)
        t = torch.ones(8)
        eng.save(0, {"a": arr, "t": t})
        arr[:] = 999.0
        t.fill_(999.0)
        eng.wait_until_finished()
        out = eng.restore(0)
        np.testing.assert_array_equal(np.asarray(out["a"]), np.ones((8,)))
        assert out["t"].tolist() == [1.0] * 8


def test_queued_snapshots_own_their_buffers(tmp_path):
    """Queue depth 3, the writer gated: three saves of the same live
    tensor, mutated in place between them, are three snapshots in three
    buffers, and each written step holds its own values."""
    gate = threading.Event()
    live = torch.zeros(1024)
    with AsyncCheckpointEngine(tmp_path, queue_depth=3) as eng:
        eng._commit_hook = lambda step: gate.wait(timeout=30)
        for step in range(3):
            live.fill_(float(step))
            eng.save(step, {"w": live})
        queued = list(eng._q.queue)
        ptrs = {item[1]["w"].data_ptr() for item in queued}
        assert len(ptrs) == len(queued) and live.data_ptr() not in ptrs
        gate.set()
        eng.wait_until_finished()
        for step in range(3):
            assert bool((eng.restore(step)["w"] == step).all())


def test_engine_snapshot_slots_are_bounded(tmp_path):
    """Queue depth 1, the writer gated: two saves take the two slots (the
    one being written and the queued one); a third waits for the writer
    to release one, and the pool never grows past depth + 1."""
    gate = threading.Event()
    with AsyncCheckpointEngine(tmp_path, queue_depth=1) as eng:
        eng._commit_hook = lambda step: gate.wait(timeout=30)
        eng.reserve({"w": torch.zeros(4)})
        for step in range(2):
            eng.save(step, {"w": torch.full((4,), float(step))})
        third = threading.Thread(
            target=eng.save, args=(2, {"w": torch.full((4,), 2.0)}))
        third.start()
        third.join(timeout=0.3)
        assert third.is_alive()
        gate.set()
        third.join(timeout=30)
        assert not third.is_alive()
        eng.wait_until_finished()
        assert eng.stats()["pinned_slots"] == 2.0
        for step in range(3):
            assert bool((eng.restore(step)["w"] == step).all())


def test_engine_midwrite_crash_keeps_previous_intact(tmp_path):
    with AsyncCheckpointEngine(tmp_path) as eng:
        eng.save(0, {"w": torch.zeros(2)})
        eng.wait_until_finished()

        def die(step):
            raise OSError(f"disk died mid-write of step {step}")

        eng._commit_hook = die
        eng.save(1, {"w": torch.ones(2)})
        with pytest.raises(OSError, match="mid-write"):
            eng.wait_until_finished()
        eng._commit_hook = None
        assert eng.all_steps() == [0]
        assert eng.restore(0)["w"].tolist() == [0.0, 0.0]
        assert eng.save(2, {"w": torch.full((2,), 2.0)})
        eng.wait_until_finished()
        assert eng.all_steps() == [0, 2]
        assert eng.stats()["failures"] == 1


def test_engine_deferred_error_surfaces_at_next_save(tmp_path):
    with AsyncCheckpointEngine(tmp_path) as eng:
        eng.save(0, {"w": torch.zeros(2)})
        eng.wait_until_finished()

        def die(step):
            raise OSError(f"disk died mid-write of step {step}")

        eng._commit_hook = die
        eng.save(1, {"w": torch.ones(2)})
        eng._q.join()
        eng._commit_hook = None
        with pytest.raises(OSError, match="mid-write"):
            eng.save(2, {"w": torch.ones(2)})
        assert eng.save(2, {"w": torch.full((2,), 2.0)})
        eng.wait_until_finished()
        assert eng.all_steps() == [0, 2]
        assert eng.stats()["failures"] == 1


def test_engine_writer_bootstrap_failure_does_not_deadlock(tmp_path,
                                                           monkeypatch):
    def boom():
        raise RuntimeError("checkpoint writer broken at writer bootstrap")

    monkeypatch.setattr(port_ckpt, "_dcp", boom)
    eng = AsyncCheckpointEngine(tmp_path)
    try:
        assert eng.save(0, {"w": torch.ones(2)})
        with pytest.raises(RuntimeError, match="writer bootstrap"):
            eng.wait_until_finished()
        assert eng.all_steps() == []
        eng._interval = 1
        eng.save(1, {"w": torch.ones(2)})
        with pytest.raises(RuntimeError, match="writer bootstrap"):
            eng.wait_until_finished()
        assert eng.all_steps() == []
    finally:
        eng.close()


def test_engine_events_carry_phase_spans(tmp_path):
    with AsyncCheckpointEngine(tmp_path) as eng:
        eng.save(0, {"w": torch.ones(2)})
        eng.wait_until_finished()
        evs = eng.drain_events()
    writes = [e for e in evs if e["phase"] == "write"]
    assert len(writes) == 1 and writes[0]["step"] == 0
    w = writes[0]
    assert w["snapshot_t0"] <= w["snapshot_t1"] <= w["t0"] <= w["t1"]
    assert w["ok"] is True and w["enqueue_ms"] >= 0.0
    assert eng.drain_events() == []


def test_engine_close_drains_and_refuses_later_saves(tmp_path):
    eng = AsyncCheckpointEngine(tmp_path)
    eng.save(0, {"w": torch.ones(4)})
    eng.close()
    assert port_ckpt.latest_step(tmp_path) == 0
    with pytest.raises(RuntimeError, match="closed"):
        eng.save(1, {"w": torch.ones(4)})


def test_engine_prunes_its_own_debris_not_orbax_debris(tmp_path):
    """The writer removes the port's staging debris and markerless step
    dirs; an orbax-style staging dir is not the port's and stays (and is
    invisible either way)."""
    (tmp_path / f"3{port_ckpt.STAGING_INFIX}1-0").mkdir(parents=True)
    (tmp_path / "7").mkdir()
    (tmp_path / "4.orbax-checkpoint-tmp-9").mkdir()
    with AsyncCheckpointEngine(tmp_path) as eng:
        eng.save(0, {"w": torch.ones(2)})
        eng.wait_until_finished()
    left = sorted(p.name for p in tmp_path.iterdir())
    assert left == ["0", "4.orbax-checkpoint-tmp-9"]
    assert port_ckpt.all_steps(tmp_path) == [0]


def test_rcm_sync_engine_gets_snapshot_isolation(tmp_path):
    with ResilientCheckpointManager(tmp_path, engine="sync") as mgr:
        arr = np.ones((8,), np.float32)
        assert mgr.save(0, {"a": arr})
        arr[:] = 999.0
        mgr.wait_until_finished()
        np.testing.assert_array_equal(np.asarray(mgr.restore(0)["a"]),
                                      np.ones((8,)))
    with pytest.raises(ValueError, match="engine"):
        ResilientCheckpointManager(tmp_path, engine="bogus")


def test_stall_fraction_is_zero_before_its_window(tmp_path):
    with AsyncCheckpointEngine(tmp_path) as eng:
        assert eng.stall_fraction() == 0.0
        eng.save(0, {"w": torch.ones(2)})
        assert eng.stall_fraction() == 0.0  # under MIN_STALL_WINDOW_S
        st = eng.stats()
        assert st["saves"] == 1.0 and st["snapshot_ms_total"] >= 0.0


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("stream") / "tokens.bin"
    tokens = np.arange(4096 * 4, dtype=np.uint16) % 1000
    port_data.write_token_file(path, tokens)
    return path


def _loaders(corpus, **kw):
    kw.setdefault("batch_size", 4)
    kw.setdefault("seed", 11)
    return (ref_data.DataLoader(ref_data.TokenFileDataset(corpus, seq_len=16),
                                **kw),
            port_data.DataLoader(port_data.TokenFileDataset(corpus,
                                                            seq_len=16),
                                 **kw))


@pytest.mark.parametrize("next_batch", [0, 7, 255, 1000])
def test_stream_state_matches_the_reference(corpus, next_batch):
    ref, port = _loaders(corpus, shard=(1, 2))
    a = stream_state(port, next_batch)
    b = ref_goodput.stream_state(ref, next_batch)
    assert list(a) == list(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and int(a[k]) == int(b[k]), k
    assert verify_stream_state(port, b) == next_batch
    with pytest.raises(StreamStateError):
        stream_state(port, -1)


@pytest.mark.parametrize("change", [
    dict(seed=12), dict(batch_size=8), dict(shuffle=False),
    dict(shard=(0, 2)), "missing", "version", "malformed",
])
def test_verify_stream_state_rejects_as_the_reference(corpus, change):
    ref, port = _loaders(corpus, shard=(1, 2))
    state = ref_goodput.stream_state(ref, 5)
    if change == "missing":
        state = {k: v for k, v in state.items() if k != "seed"}
    elif change == "version":
        state = dict(state, version=np.asarray(2, np.int64))
    elif change == "malformed":
        state = {"next_batch": state["next_batch"]}
    else:
        ref, port = _loaders(corpus, **{"shard": (1, 2), **change})
    with pytest.raises(ref_goodput.StreamStateError) as r:
        ref_goodput.verify_stream_state(ref, state)
    with pytest.raises(StreamStateError) as p:
        verify_stream_state(port, state)
    assert str(p.value) == str(r.value)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_resumable_stream_matches_the_reference_across_reseeks(corpus,
                                                               prefetch):
    ref_loader, port_loader = _loaders(corpus)
    ref = ref_goodput.ResumableStream(ref_loader)
    port = ResumableStream(port_loader, prefetch=prefetch, device="cpu")
    try:
        for step in (0, 1, 2, 3, 7, 8, 2, 3, 300, 301, 0):
            a, b = port(step), ref(step)
            a = a.numpy() if isinstance(a, torch.Tensor) else a
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
        assert port.seeks == ref.seeks == 4
        assert {k: int(v) for k, v in port.state().items()} == {
            k: int(v) for k, v in ref.state().items()}
        assert port.verify(ref.state()) == 1
        assert (port.stall_fraction() >= 0.0) and (prefetch or
                                                   port.stall_fraction() == 0)
    finally:
        port.close()
        ref.close()
    with pytest.raises(IndexError):
        ResumableStream(port_loader)(-1)

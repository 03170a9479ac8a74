"""apex_tpu_torch's native host ops against the JAX package's, bit for
bit.

``flatten_f32``, ``unflatten_f32``, ``gather_rows`` and
``mlm_mask_batch`` of :mod:`apex_tpu_torch._native` give
``np.array_equal`` results to :mod:`apex_tpu._native`'s on the same
inputs, on both of the port's paths: the library its own
``host_ops.cpp`` builds with ``g++`` (into ``build/apex_tpu_torch/``),
and the numpy replay a host without ``g++`` runs.  The port's
``DataLoader`` and ``bert_mlm_batches``, which now draw through
``_native``, give the reference's batches bit for bit, and
``data.gather_rows``/``data.mlm_mask_batch`` are ``_native``'s.
"""

import itertools

import numpy as np
import pytest

from apex_tpu import _native as jnative
from apex_tpu import data as jdata
from apex_tpu_torch import _native as pnative
from apex_tpu_torch import data as pdata


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """The port on its library, or on its numpy replay (the library
    unloaded and its build refused, as on a host without g++)."""
    if request.param == "native":
        assert pnative.available()
        assert pnative.NATIVE_AVAILABLE
        assert pnative.library_path().is_file()
    else:
        monkeypatch.setattr(pnative, "_LIB", None)
        monkeypatch.setattr(pnative, "_LOAD_FAILED", True)
        assert not pnative.available()
    return request.param


def _arrays(seed=0):
    rs = np.random.RandomState(seed)
    shapes = [(3, 5), (7,), (2, 3, 4), (1,), (0,), (16, 9)]
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def test_flatten_unflatten_match_reference(path):
    arrays = _arrays()
    flat = pnative.flatten_f32(arrays)
    ref = jnative.flatten_f32(arrays)
    assert flat.dtype == ref.dtype == np.float32
    assert np.array_equal(flat, ref)
    back = pnative.unflatten_f32(flat, arrays)
    for a, b, r in zip(back, arrays, jnative.unflatten_f32(ref, arrays)):
        assert a.shape == b.shape and np.array_equal(a, b)
        assert np.array_equal(a, r)
    with pytest.raises(ValueError):
        pnative.unflatten_f32(flat[:-1], arrays)


@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.float32])
def test_gather_rows_matches_reference(path, dtype):
    rs = np.random.RandomState(1)
    base = rs.randint(0, 60000, size=(997,)).astype(dtype)
    starts = rs.randint(0, 997 - 33, size=(12,)).astype(np.int64)
    got = pnative.gather_rows(base, starts, 33)
    ref = jnative.gather_rows(base, starts, 33)
    assert got.dtype == ref.dtype == dtype and got.shape == (12, 33)
    assert np.array_equal(got, ref)
    with pytest.raises(IndexError):
        pnative.gather_rows(base, np.array([997 - 32]), 33)
    with pytest.raises(IndexError):
        pnative.gather_rows(base, np.array([-1]), 33)


@pytest.mark.parametrize("seed", [0, 42, 2 ** 63 + 12345])
def test_mlm_mask_batch_matches_reference(path, seed):
    ids = np.random.RandomState(2).randint(0, 30522, size=(16, 128))
    kw = dict(mask_prob=0.2, mask_id=7, vocab_size=30522, special_floor=999)
    got = pnative.mlm_mask_batch(ids, seed, **kw)
    ref = jnative.mlm_mask_batch(ids.astype(np.int32), seed, **kw)
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype == np.int32 and a.shape == ids.shape
        assert np.array_equal(a, r)
    masked, labels = got
    sel = labels >= 0
    assert sel.any() and (ids[sel] >= 999).all()
    assert np.array_equal(masked[~sel], ids[~sel])


def test_both_paths_give_the_same_bits(monkeypatch):
    ids = np.random.RandomState(3).randint(0, 30522, size=(8, 64))
    arrays = _arrays(4)
    base = np.arange(5000, dtype=np.uint16)
    starts = np.array([0, 100, 4000], np.int64)
    assert pnative.available()
    native = (pnative.mlm_mask_batch(ids, 9), pnative.flatten_f32(arrays),
              pnative.gather_rows(base, starts, 64))
    monkeypatch.setattr(pnative, "_LIB", None)
    monkeypatch.setattr(pnative, "_LOAD_FAILED", True)
    replay = (pnative.mlm_mask_batch(ids, 9), pnative.flatten_f32(arrays),
              pnative.gather_rows(base, starts, 64))
    for a, r in zip(native[0], replay[0]):
        assert np.array_equal(a, r)
    assert np.array_equal(native[1], replay[1])
    assert np.array_equal(native[2], replay[2])


def test_data_reexports_native():
    assert pdata.gather_rows is pnative.gather_rows
    assert pdata.mlm_mask_batch is pnative.mlm_mask_batch


def _corpus(tmp_path, vocab=2048):
    path = tmp_path / "tokens.bin"
    pdata.synthetic_token_corpus(path, vocab_size=vocab, num_tokens=40000,
                                 floor=0, seed=3)
    return path


def test_loader_batches_match_reference_through_native(tmp_path, monkeypatch):
    path = _corpus(tmp_path)
    calls = []
    real = pnative.gather_rows
    monkeypatch.setattr(pnative, "gather_rows",
                        lambda *a: calls.append(1) or real(*a))
    for shard in ((0, 1), (1, 2)):
        pl = pdata.DataLoader(pdata.TokenFileDataset(path, 64), 8, seed=5,
                              shard=shard)
        jl = jdata.DataLoader(jdata.TokenFileDataset(path, 64), 8, seed=5,
                              shard=shard)
        for a, r in zip(itertools.islice(pl.iter_from(3), 6),
                        itertools.islice(jl.iter_from(3), 6)):
            assert a.dtype == r.dtype and np.array_equal(a, r)
    assert len(calls) == 12


@pytest.mark.parametrize("k", [None, 12])
def test_bert_batches_match_reference_through_native(tmp_path, monkeypatch,
                                                     k):
    path = _corpus(tmp_path, vocab=30522)
    calls = []
    real = pnative.mlm_mask_batch
    monkeypatch.setattr(pnative, "mlm_mask_batch",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    kw = dict(seed=11, start_step=2, max_predictions_per_seq=k)
    got = pdata.bert_mlm_batches(
        pdata.DataLoader(pdata.TokenFileDataset(path, 32), 4, seed=1), **kw)
    ref = jdata.bert_mlm_batches(
        jdata.DataLoader(jdata.TokenFileDataset(path, 32), 4, seed=1), **kw)
    for a, r in zip(itertools.islice(got, 3), itertools.islice(ref, 3)):
        assert sorted(a) == sorted(r)
        for key in r:
            assert np.array_equal(a[key], np.asarray(r[key])), key
    assert len(calls) == 3

"""The port's multi-device search and lane sharding (``seqalign_tpu_torch.
parallel``) against the JAX package's on the CPU: the port runs on
``[cpu] * D`` (the kernels' plain versions), the JAX package on the 8 CPU
devices ``conftest.py`` forces. Every comparison is exact (int32)."""

import functools

import jax
import numpy as np
import pytest
import torch

from seqalign_tpu import parallel as jax_parallel
from seqalign_tpu import pipeline as jax_pipeline
from seqalign_tpu.ops.swa_pallas import sw_pallas_stream
from seqalign_tpu.ops.swa_xla import sw_wavefront as jax_sw_wavefront
from seqalign_tpu_torch import device, pipeline
from seqalign_tpu_torch.ops import swa_cuda
from seqalign_tpu_torch.ops.swa_torch import make_profile, sw_wavefront
from seqalign_tpu_torch.parallel import (
    deal_chunks, host_stripe, make_mesh, merge_topk_candidates,
    multi_device_search, shard_db, sharded_engine, sharded_topk,
)

from _torch_cases import make_scoring, random_records
from conftest import random_protein

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")


@pytest.mark.parametrize("win", [256, 1000])
@pytest.mark.parametrize("n_devices", [1, 2, 3, 8])
def test_deal_chunks_matches_jax(n_devices, win):
    rng = np.random.default_rng(41)
    lengths = rng.integers(1, 400, 5000)
    order = np.argsort(-lengths, kind="stable")
    got = deal_chunks(order, lengths, n_devices, win=win)
    want = jax_parallel.deal_chunks(order, lengths, n_devices, win=win)
    assert len(got) == len(want) == n_devices
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.sort(np.concatenate(got)), np.arange(5000))


@pytest.mark.parametrize("n_devices", [1, 2, 3, 8])
def test_multi_device_search_matches_jax(n_devices):
    """1,300 records (six 256-lane groups) dealt over 1-8 entries: at 8,
    two entries get no group and launch nothing."""
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(42 + n_devices)
    q = sc.query_indices(random_protein(rng, 13))
    encoded = random_records(rng, 1300, 1, 30)
    db = pipeline._db_from_encoded(encoded)
    calls = swa_cuda.sw_stream_reference.calls
    got, dt = multi_device_search(
        make_profile(sc.table, q), db, sc.gap_open_total, sc.gap_extend,
        devices=[CPU] * n_devices,
    )
    assert swa_cuda.sw_stream_reference.calls - calls == min(n_devices, 6)
    want, _ = jax_pipeline.search_encoded(q, encoded, sc, engine="wavefront")
    single, _ = pipeline.search_database(q, db, sc)
    assert got.dtype == np.int32 and dt > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)


@pytest.mark.parametrize("n_devices", [1, 2, 3, 8])
def test_multi_device_search_stacked_queries_match_jax(n_devices):
    """A 3-D profile (three queries of unequal lengths, one empty) through
    K3's plain version, one launch per device entry and query block."""
    sc = make_scoring("PAM250")
    rng = np.random.default_rng(52 + n_devices)
    qs = [sc.query_indices(random_protein(rng, k)) for k in (9, 0, 16)]
    encoded = random_records(rng, 700, 1, 25)
    db = pipeline._db_from_encoded(encoded)
    calls = swa_cuda.sw_stream_multi_reference.calls
    got, _ = multi_device_search(
        pipeline.multi_profile(sc.table, qs), db, sc.gap_open_total,
        sc.gap_extend, devices=[CPU] * n_devices,
    )
    assert swa_cuda.sw_stream_multi_reference.calls - calls == min(n_devices, 3)
    want = np.stack([jax_pipeline.search_encoded(q, encoded, sc, engine="wavefront")[0]
                     for q in qs])
    single, _ = pipeline.search_database_multi(qs, db, sc)
    assert got.shape == (3, 700) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)


def test_multi_device_search_query_blocks(monkeypatch):
    """Several query blocks on each device (a budget of one query's output)
    give the same scores: every block's launch per device, one fetch."""
    monkeypatch.setattr(pipeline, "MULTI_SCRATCH_BYTES", 4 * 256)
    sc = make_scoring("BLOSUM45")
    rng = np.random.default_rng(61)
    qs = [sc.query_indices(random_protein(rng, k)) for k in (5, 11, 7)]
    encoded = random_records(rng, 400, 1, 20)
    db = pipeline._db_from_encoded(encoded)
    calls = swa_cuda.sw_stream_multi_reference.calls
    got, _ = multi_device_search(
        pipeline.multi_profile(sc.table, qs), db, sc.gap_open_total,
        sc.gap_extend, devices=[CPU] * 2,
    )
    assert swa_cuda.sw_stream_multi_reference.calls - calls == 2 * 3
    want = np.stack([jax_pipeline.search_encoded(q, encoded, sc, engine="wavefront")[0]
                     for q in qs])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ndim", [2, 3])
def test_multi_device_search_empty_database(ndim):
    sc = make_scoring("BLOSUM62")
    prof = make_profile(sc.table, sc.query_indices("MKVLAW"))
    if ndim == 3:
        prof = np.stack([prof, prof])
    got, dt = multi_device_search(
        prof, pipeline._db_from_encoded([]), sc.gap_open_total, sc.gap_extend,
        devices=[CPU] * 2,
    )
    assert got.shape == prof.shape[:-2] + (0,) and dt == 0.0


def _jax_mdev(profile, encoded, go, ge):
    """JAX's multi_device_search on two CPU devices with its interpret-mode
    stream kernel (as ``tests/test_multihost.py`` runs it)."""
    return jax_parallel.multi_device_search(
        profile, jax_pipeline._db_from_encoded(encoded), go, ge,
        devices=jax.devices()[:2],
        engine_fn=functools.partial(sw_pallas_stream, interpret=True),
    )


def test_query_over_row_limit_raises_in_both():
    """A 2000-residue query: JAX finds no kernel config before any launch;
    the port raises above MAX_QUERY_ROWS and launches nothing."""
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(71)
    prof = make_profile(sc.table, sc.query_indices(random_protein(rng, 2000)))
    encoded = random_records(rng, 50, 1, 20)
    go, ge = sc.gap_open_total, sc.gap_extend
    with pytest.raises(ValueError):
        _jax_mdev(prof, encoded, go, ge)
    calls = swa_cuda.sw_stream_reference.calls
    with pytest.raises(ValueError, match="MAX_QUERY_ROWS"):
        multi_device_search(prof, pipeline._db_from_encoded(encoded), go, ge,
                            devices=[CPU] * 2)
    assert swa_cuda.sw_stream_reference.calls == calls


def test_gap_open_positive_raises_in_both():
    """ge < go (a positive gap open): the JAX stream kernel raises and its
    multi-device search has no fallback; the port raises before packing
    and never scores through another engine."""
    from seqalign_tpu_torch.host import ScoringModel, load_builtin

    sc = load_builtin(
        "BLOSUM62", ScoringModel(gap_open=2, gap_extend=-1, use_match_mismatch=False))
    go, ge = sc.gap_open_total, sc.gap_extend
    assert ge < go
    rng = np.random.default_rng(72)
    prof = make_profile(sc.table, sc.query_indices(random_protein(rng, 8)))
    encoded = random_records(rng, 40, 1, 12)
    with pytest.raises(ValueError, match="ge >= go"):
        _jax_mdev(prof, encoded, go, ge)
    calls = swa_cuda.sw_stream_reference.calls
    with pytest.raises(ValueError, match="ge >= go"):
        multi_device_search(prof, pipeline._db_from_encoded(encoded), go, ge,
                            devices=[CPU] * 2)
    assert swa_cuda.sw_stream_reference.calls == calls


def test_engine_fn_hook():
    """``engine_fn`` replaces the kernel per device, called as the JAX
    package calls it."""
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(73)
    q = sc.query_indices(random_protein(rng, 10))
    db = pipeline._db_from_encoded(random_records(rng, 600, 1, 20))
    seen = []

    def engine(prof, streams, fs, go, ge, *, nslots, jb):
        seen.append((prof.device, nslots, jb))
        return swa_cuda.sw_stream_reference(prof, streams, fs, go, ge, nslots=nslots, jb=jb)

    got, _ = multi_device_search(make_profile(sc.table, q), db, sc.gap_open_total,
                                 sc.gap_extend, devices=["cpu", "cpu"], engine_fn=engine)
    assert [s[0] for s in seen] == [CPU, CPU] and {s[2] for s in seen} == {swa_cuda.STREAM_JB}
    assert sum(s[1] for s in seen) == 3  # 600 records: three 256-lane groups
    np.testing.assert_array_equal(got, pipeline.search_database(q, db, sc)[0])


def _tied_batch(rng, lb, lanes):
    """A ``(lb, lanes)`` int32 batch whose second half repeats its first
    (ties across shards), with repeated lanes inside a shard and all-'*'
    lanes (score 0)."""
    db = rng.integers(1, 27, (lb, lanes)).astype(np.int32)
    half = lanes // 2
    db[:, 3] = db[:, 1]
    db[:, 5:8] = 31
    db[:, half:] = db[:, :half]
    return db


@pytest.fixture(scope="module")
def jax_mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jax_parallel.make_mesh(jax.devices()[:8])


@pytest.mark.parametrize("pre_sharded", [False, True])
def test_sharded_engine_matches_jax(pre_sharded, jax_mesh8):
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(81)
    prof = make_profile(sc.table, sc.query_indices(random_protein(rng, 19)))
    db = _tied_batch(rng, 40, 8 * 16)
    go, ge = sc.gap_open_total, sc.gap_extend
    want = np.asarray(jax_parallel.sharded_engine(jax_sw_wavefront, jax_mesh8, go, ge)(
        prof, jax_parallel.shard_db(db, jax_mesh8)))
    mesh = make_mesh([CPU] * 8)
    run = sharded_engine(sw_wavefront, mesh, go, ge)
    got = run(prof, shard_db(db, mesh) if pre_sharded else db)
    assert got.shape == (8 * 16,) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 5, 16, 40])
def test_sharded_topk_matches_jax_with_ties(k, jax_mesh8):
    """Values and lane indices equal JAX's, ties included (the lower lane
    first); k = 16 and 40 exceed a shard's width of 8."""
    sc = make_scoring("PAM250")
    rng = np.random.default_rng(82)
    prof = make_profile(sc.table, sc.query_indices(random_protein(rng, 5)))
    db = _tied_batch(rng, 12, 8 * 8)
    go, ge = sc.gap_open_total, sc.gap_extend
    jv, ji = jax_parallel.sharded_topk(jax_sw_wavefront, jax_mesh8, go, ge, k=k)(
        prof, jax_parallel.shard_db(db, jax_mesh8))
    scores = np.asarray(jax_sw_wavefront(prof, db, go, ge))
    assert len(np.unique(scores)) < len(scores)  # the batch holds ties
    mesh = make_mesh([CPU] * 8)
    vals, idx = sharded_topk(sw_wavefront, mesh, go, ge, k=k)(prof, db)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    order = np.argsort(-scores, kind="stable")[:k]
    np.testing.assert_array_equal(idx.numpy(), order)


def test_sharded_fixed_batch_engine_equals_one_call():
    """The fixed-batch engine (K4's plain version here) over two shards of
    1,024 lanes equals one call on the whole batch, and its top-k a stable
    sort of those scores."""
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(83)
    prof = make_profile(sc.table, sc.query_indices(random_protein(rng, 7)))
    db = _tied_batch(rng, 9, 2 * swa_cuda.FIXED_WINDOW_LANES).astype(np.int8)
    go, ge = sc.gap_open_total, sc.gap_extend
    engine = pipeline.get_engine("windows")
    whole = engine(prof, db, go, ge).numpy()
    mesh = make_mesh(["cpu", "cpu"])
    calls = swa_cuda.sw_windows_reference.calls
    got = sharded_engine(engine, mesh, go, ge)(prof, shard_db(db, mesh))
    assert swa_cuda.sw_windows_reference.calls - calls == 2
    np.testing.assert_array_equal(got.numpy(), whole)
    vals, idx = sharded_topk(engine, mesh, go, ge, k=10)(prof, db)
    order = np.argsort(-whole, kind="stable")[:10]
    np.testing.assert_array_equal(idx.numpy(), order)
    np.testing.assert_array_equal(vals.numpy(), whole[order])


def test_shard_db_rejects_unequal_shards():
    with pytest.raises(ValueError, match="equal shards"):
        shard_db(np.zeros((4, 10), np.int8), make_mesh([CPU] * 3))


@pytest.mark.parametrize("nproc", [1, 3, 4])
def test_host_stripe_matches_jax(nproc):
    recs = list(range(23))
    for pid in range(nproc):
        assert (list(host_stripe(recs, pid, nproc))
                == list(jax_parallel.host_stripe(recs, pid, nproc)))


@pytest.mark.parametrize("k", [1, 4, 9, 30])
def test_merge_topk_candidates_matches_jax(k):
    """Three hosts' candidates with ties within and across hosts."""
    rng = np.random.default_rng(91)
    parts = [(rng.integers(0, 6, 7).astype(np.int32), rng.permutation(100)[:7])
             for _ in range(3)]
    for gathered in (parts[1:], None):  # three hosts, one host
        got = merge_topk_candidates(*parts[0], k, gathered)
        want = jax_parallel.merge_topk_candidates(*parts[0], k, gathered)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_local_devices(monkeypatch):
    """``[cpu]`` under SEQALIGN_PLATFORM=cpu; every card under cuda; with
    no GPU an error, never a CPU run."""
    assert device.local_devices() == [CPU]
    monkeypatch.delenv("SEQALIGN_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert device.local_devices() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.local_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_no_gpu_multi_device_search_raises(monkeypatch, tmp_path):
    """Without a GPU and without SEQALIGN_PLATFORM=cpu the entry points
    raise."""
    from seqalign_tpu_torch.parallel import multihost_search

    monkeypatch.delenv("SEQALIGN_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(92)
    q = sc.query_indices(random_protein(rng, 8))
    db = pipeline._db_from_encoded(random_records(rng, 30, 1, 12))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multi_device_search(make_profile(sc.table, q), db, sc.gap_open_total,
                            sc.gap_extend)
    fa = tmp_path / "db.fa"
    fa.write_text(">a\nMKVLAW\n>b\nHEAGAWGHEE\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost_search(q, str(fa), sc)

"""The port's row-striped stream kernel (K2): its plain version against the
JAX package's ``_stream_striped_pass`` and ``sw_pallas_stream_striped`` in
interpret mode, slot by slot and boundary by boundary, on the same
``pack_streams`` output carried across by ``convert.py``; and the long-query
pipeline with ``MAX_QUERY_ROWS`` and ``STRIPE_ROWS`` shrunk."""

import numpy as np
import pytest
import torch

from seqalign_tpu import pipeline as jax_pipeline
from seqalign_tpu.ops.oracle import sw_score_batch
from seqalign_tpu.ops.swa_pallas import _stream_striped_pass, sw_pallas_stream_striped
from seqalign_tpu.utils.native_io import EncodedDatabase
from seqalign_tpu.utils.packing import pack_streams
from seqalign_tpu_torch import pipeline
from seqalign_tpu_torch.convert import ROW_ALIGN, profile_stripes, stream_pack_to_torch
from seqalign_tpu_torch.ops import swa_cuda
from seqalign_tpu_torch.ops.swa_cuda import (
    sw_stream_reference, sw_stream_striped, sw_stream_striped_pass,
    sw_stream_striped_pass_reference, sw_stream_striped_reference,
)
from seqalign_tpu_torch.ops.swa_torch import make_profile

from _torch_cases import make_scoring, random_records
from conftest import random_protein

WIN, JB, SR = 128, 4, 8  # one 128-lane TPU window (sl=1); stripes of 8 rows


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")


def _pack(rng, nw, n=300, lo=1, hi=12, encoded=None, keep_order=False, grain=8):
    if encoded is None:
        encoded = random_records(rng, n, lo, hi)
    db = pipeline._db_from_encoded(encoded)
    order = np.arange(db.n) if keep_order else np.argsort(-db.lengths, kind="stable")
    return pack_streams(db, order, nw, win=WIN, jb=JB, grain=grain)


def _jax_bnd_to_port(bnd, nw):
    """JAX's ``(NW, L/jb, 2*jb, 1, 128)`` f32 boundary -> the port's ``(2,
    NW, L, 128)``: ``bnd[w, j, 2t]`` / ``[w, j, 2t+1]`` are Gg / F at
    position ``j*jb + t``."""
    b = np.asarray(bnd)
    nj = b.shape[1]
    b = b.reshape(nw, nj, JB, 2, WIN).transpose(3, 0, 1, 2, 4)
    return b.reshape(2, nw, nj * JB, WIN).astype(np.int32)


def _port_bnd_to_jax(bnd):
    b = bnd.numpy().astype(np.float32)
    _, nw, length, win = b.shape
    b = b.reshape(2, nw, length // JB, JB, win).transpose(1, 2, 3, 0, 4)
    return b.reshape(nw, length // JB, 2 * JB, 1, win)


@pytest.mark.parametrize("scoring", ["BLOSUM62", "PAM250", "match_mismatch", "go_eq_ge"])
def test_plain_pass_matches_jax_pass(scoring):
    """Two passes of one stripe each: the first from the boundary row -1,
    the second from the first's boundary; output slots and boundary both."""
    sc = make_scoring(scoring)
    rng = np.random.default_rng(90)
    q = sc.query_indices(random_protein(rng, 2 * SR))
    nw = 2
    pack = _pack(rng, nw)
    nslots = len(pack.slot_ids)
    assert (pack.fs[:, :, 0] > 0).sum() >= 1  # a segment start mid-stream
    prof = make_profile(sc.table, q)
    go, ge = sc.gap_open_total, sc.gap_extend
    streams, fs = stream_pack_to_torch(pack, "cpu")
    stripes = profile_stripes(prof, go, SR, "cpu")
    bnd = torch.zeros((2, 2, *streams.shape), dtype=torch.int32)
    kw = dict(nslots=nslots, sl=1, nw=nw, jb=JB, ic=4, ui=4, interpret=True)
    jax_in = None
    for p in range(2):
        want, want_bnd = _stream_striped_pass(
            prof[p * SR : (p + 1) * SR], pack.streams, pack.fs, jax_in, go, ge,
            has_in=p > 0, has_out=True, **kw,
        )
        got, got_bnd = sw_stream_striped_pass_reference(
            stripes[p], streams, fs, go, ge, nslots=nslots, jb=JB,
            bnd_in=bnd[p - 1] if p else None, bnd_out=bnd[p],
        )
        assert got.dtype == torch.int32 and got_bnd.data_ptr() == bnd[p].data_ptr()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_bnd.numpy(), _jax_bnd_to_port(want_bnd, nw))
        # Each pass reads the port's own boundary, carried across.
        jax_in = _port_bnd_to_jax(got_bnd)


# name: (scoring, query length, records, lo, hi, nw, grain, layout)
STRIPED_CASES = {
    "2_stripes_exact": ("BLOSUM62", 2 * SR, 300, 1, 10, 2, 8, None),
    "3_stripes_partial": ("PAM250", 2 * SR + 5, 300, 1, 10, 2, 8, None),
    "5_stripes_exact": ("match_mismatch", 5 * SR, 300, 1, 8, 2, 8, None),
    "2_stripes_partial_go_eq_ge": ("go_eq_ge", SR + 3, 300, 1, 8, 2, 8, None),
    "tail_segment": ("BLOSUM62", 2 * SR + 3, None, 0, 0, 1, JB, "tail"),
    "empty_window": ("PAM250", 2 * SR - 3, 140, 1, 10, 3, 8, "empty"),
}


@pytest.mark.parametrize("case", sorted(STRIPED_CASES))
def test_plain_driver_matches_jax_striped(case):
    name, lq, n, lo, hi, nw, grain, layout = STRIPED_CASES[case]
    sc = make_scoring(name)
    rng = np.random.default_rng(sorted(STRIPED_CASES).index(case) + 91)
    q = sc.query_indices(random_protein(rng, lq))
    if layout == "tail":
        # Segments of 20 and 4 positions: the second starts on the final
        # block, so its start flush and the window's end flush coincide.
        enc = random_records(rng, WIN, 20, 21) + random_records(rng, WIN, 3, 4)
        pack = _pack(rng, nw, encoded=enc, keep_order=True, grain=grain)
        starts = np.nonzero(pack.fs[:, 0, 0])[0]
        assert len(starts) == 1 and starts[0] == pack.fs.shape[0] - 1
    else:
        pack = _pack(rng, nw, n, lo, hi, grain=grain)
        if layout == "empty":
            assert not pack.fs[:, nw - 1].any()
    nslots = len(pack.slot_ids)
    prof = make_profile(sc.table, q)
    go, ge = sc.gap_open_total, sc.gap_extend
    want = np.asarray(sw_pallas_stream_striped(
        prof, pack.streams, pack.fs, go, ge, nslots=nslots, sl=1, nw=nw,
        jb=JB, ui=4, stripe_rows=SR, interpret=True,
    ))
    streams, fs = stream_pack_to_torch(pack, "cpu")
    stripes = profile_stripes(prof, go, SR, "cpu")
    assert len(stripes) == -(-lq // SR)
    calls = sw_stream_striped_pass_reference.calls
    got = sw_stream_striped_reference(
        stripes, streams, fs, go, ge, nslots=nslots, jb=JB).numpy()
    assert sw_stream_striped_pass_reference.calls == calls + len(stripes)
    assert got.shape == want.shape == (nslots, WIN) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_profile_stripes():
    sc = make_scoring("BLOSUM62")
    prof = make_profile(sc.table, sc.query_indices(random_protein(np.random.default_rng(1), 21)))
    go = sc.gap_open_total
    stripes = profile_stripes(prof, go, SR, "cpu")
    assert [tuple(s.shape) for s in stripes] == [(8, 32), (8, 32), (8, 32)]
    np.testing.assert_array_equal(torch.cat(stripes)[:21].numpy(), prof - go)
    assert not stripes[-1][5:].any()  # only the last stripe is padded
    assert all(s.dtype == torch.int32 for s in stripes)
    # At the port's own limits a query one row over K1's limit keeps whole
    # stripes and one short last stripe.
    long = np.zeros((swa_cuda.MAX_QUERY_ROWS + 1, 32), np.int32)
    rows = [s.shape[0] for s in profile_stripes(long, go, swa_cuda.STRIPE_ROWS, "cpu")]
    assert rows == [swa_cuda.STRIPE_ROWS] * (
        swa_cuda.MAX_QUERY_ROWS // swa_cuda.STRIPE_ROWS) + [ROW_ALIGN]
    with pytest.raises(ValueError):
        profile_stripes(prof, go, ROW_ALIGN + 2, "cpu")
    with pytest.raises(ValueError):
        profile_stripes(prof[None], go, SR, "cpu")


def _small_case(seed=95):
    sc = make_scoring("BLOSUM45")
    rng = np.random.default_rng(seed)
    pack = _pack(rng, 2, 200, 1, 10)
    go, ge = sc.gap_open_total, sc.gap_extend
    prof = make_profile(sc.table, sc.query_indices(random_protein(rng, 19)))
    streams, fs = stream_pack_to_torch(pack, "cpu")
    return profile_stripes(prof, go, SR, "cpu"), streams, fs, go, ge, dict(
        nslots=len(pack.slot_ids), jb=JB)


def test_striped_wrappers_on_cpu_are_the_plain_versions():
    stripes, streams, fs, go, ge, kw = _small_case()
    calls, launches = sw_stream_striped.calls, sw_stream_striped_pass.launches
    got = sw_stream_striped(stripes, streams, fs, go, ge, **kw)
    assert sw_stream_striped.calls == calls + 1
    assert sw_stream_striped_pass.launches == launches  # no kernel on a CPU tensor
    assert torch.equal(got, sw_stream_striped_reference(stripes, streams, fs, go, ge, **kw))
    bnd = torch.empty((2, *streams.shape), dtype=torch.int32)
    out, b = sw_stream_striped_pass(stripes[0], streams, fs, go, ge, bnd_out=bnd, **kw)
    ref, rb = sw_stream_striped_pass_reference(
        stripes[0], streams, fs, go, ge, bnd_out=bnd.clone(), **kw)
    assert b is bnd and torch.equal(out, ref) and torch.equal(b, rb)
    # One stripe is K1's work: the driver hands it to sw_stream.
    k1 = sw_stream_reference.calls
    assert torch.equal(
        sw_stream_striped([stripes[0]], streams, fs, go, ge, **kw),
        sw_stream_reference(stripes[0], streams, fs, go, ge, **kw),
    )
    assert sw_stream_reference.calls == k1 + 2


@pytest.mark.parametrize(
    "bad", ["bnd_shape", "bnd_dtype", "no_stripes", "3d_stripe", "no_boundary"])
def test_striped_wrappers_reject_malformed_input(bad):
    stripes, streams, fs, go, ge, kw = _small_case(96)
    bnd = torch.zeros((2, *streams.shape), dtype=torch.int32)
    if bad == "bnd_shape":
        bnd = bnd[:, :1].contiguous()
    elif bad == "bnd_dtype":
        bnd = bnd.float()
    if bad == "no_stripes":
        with pytest.raises(ValueError):
            sw_stream_striped([], streams, fs, go, ge, **kw)
    elif bad == "3d_stripe":
        with pytest.raises(ValueError):
            sw_stream_striped_pass(stripes[0][None], streams, fs, go, ge, bnd_out=bnd, **kw)
    elif bad == "no_boundary":
        with pytest.raises(ValueError, match="sw_stream"):
            sw_stream_striped_pass(stripes[0], streams, fs, go, ge, **kw)
    else:
        with pytest.raises(ValueError):
            sw_stream_striped_pass(stripes[0], streams, fs, go, ge, bnd_in=bnd, **kw)


def test_supported_scoring_holds_at_lq_35000():
    """G is bounded by Lq * max(P): at 35,000 rows of PAM250 (max 17) that
    is far below 2**31, so the guard admits it and int32 stays exact."""
    sc = make_scoring("PAM250")
    q = sc.query_indices(random_protein(np.random.default_rng(2), 35_000))
    assert swa_cuda.supported_scoring(make_profile(sc.table, q),
                                      sc.gap_open_total, sc.gap_extend)


# The pipeline with the limits shrunk: K1 up to 16 rows, stripes of 8.


@pytest.fixture
def shrunk(monkeypatch):
    monkeypatch.setattr(swa_cuda, "MAX_QUERY_ROWS", 16)
    monkeypatch.setattr(swa_cuda, "STRIPE_ROWS", SR)


def _db(rng, n, lo=1, hi=24):
    return pipeline._db_from_encoded(random_records(rng, n, lo, hi))


@pytest.mark.parametrize(
    "scoring,lq", [("BLOSUM62", 17), ("PAM250", 40), ("match_mismatch", 29)]
)
def test_long_query_search_matches_jax(scoring, lq, shrunk):
    sc = make_scoring(scoring)
    rng = np.random.default_rng(97 + lq)
    q = sc.query_indices(random_protein(rng, lq))
    db = _db(rng, 900)
    calls = sw_stream_striped_pass_reference.calls
    got, dt = pipeline.search_database(q, db, sc)
    assert sw_stream_striped_pass_reference.calls == calls + -(-lq // SR)
    want, _ = jax_pipeline.search_database(q, db, sc, engine="wavefront")
    assert got.dtype == np.int32 and dt > 0
    np.testing.assert_array_equal(got, want)
    pick = rng.choice(db.n, 16, replace=False)
    oracle = sw_score_batch(
        q, [db.record(int(r)) for r in pick], sc.table, sc.gap_open, sc.gap_extend
    )
    np.testing.assert_array_equal(got[pick], oracle)


@pytest.mark.parametrize("lq,route", [(16, "K1"), (17, "K2")])
def test_route_threshold(lq, route, shrunk):
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(99)
    q = sc.query_indices(random_protein(rng, lq))
    db = _db(rng, 300)
    k1, k2 = sw_stream_reference.calls, sw_stream_striped_pass_reference.calls
    got, _ = pipeline.search_database(q, db, sc)
    ran = (sw_stream_reference.calls - k1, sw_stream_striped_pass_reference.calls - k2)
    assert ran == ((1, 0) if route == "K1" else (0, 3))
    want, _ = jax_pipeline.search_database(q, db, sc, engine="wavefront")
    np.testing.assert_array_equal(got, want)


def test_long_query_chunks_by_boundary_budget(shrunk, monkeypatch):
    """A boundary budget of about 2,000 residues a chunk cuts 1500 records
    into several chunks; each runs every stripe."""
    monkeypatch.setattr(
        pipeline, "STRIPED_SCRATCH_BYTES", 2 * 2000 * 16)
    sc = make_scoring("PAM250")
    rng = np.random.default_rng(100)
    q = sc.query_indices(random_protein(rng, 20))
    db = _db(rng, 1500)
    chunks = list(pipeline.stream_chunks(
        db, np.argsort(-db.lengths, kind="stable"), None, torch.device("cpu"),
        pipeline.striped_chunk_residues()))
    assert len(chunks) > 2
    assert all(len(c) % pipeline.WINDOW_LANES == 0 for c, _ in chunks[:-1])
    assert sum(len(c) for c, _ in chunks) == db.n
    calls = sw_stream_striped_pass_reference.calls
    got, _ = pipeline.search_database(q, db, sc)
    assert sw_stream_striped_pass_reference.calls == calls + 3 * len(chunks)
    want, _ = jax_pipeline.search_database(q, db, sc, engine="wavefront")
    np.testing.assert_array_equal(got, want)


def test_long_query_empty_database_gives_zeros(shrunk):
    sc = make_scoring("BLOSUM62")
    q = sc.query_indices(random_protein(np.random.default_rng(101), 30))
    db = EncodedDatabase(np.zeros(0, np.int8), np.zeros(1, np.int64), [])
    got, dt = pipeline.search_database(q, db, sc)
    assert dt == 0.0 and got.shape == (0,)


@pytest.mark.parametrize("lengths", [(10, 30, 5), (17, 25)])
def test_mixed_batch_matches_jax(lengths, shrunk, capsys):
    """Short queries go through K3 as one batch, each long one through K2;
    the scores land in their rows and the search says so."""
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(102 + len(lengths))
    queries = [sc.query_indices(random_protein(rng, lq)) for lq in lengths]
    db = _db(rng, 700)
    long = sum(lq > 16 for lq in lengths)
    k2 = sw_stream_striped_pass_reference.calls
    k3 = swa_cuda.sw_stream_multi_reference.calls
    got, _ = pipeline.search_database_multi(queries, db, sc)
    assert sw_stream_striped_pass_reference.calls - k2 == sum(
        -(-lq // SR) for lq in lengths if lq > 16)
    assert swa_cuda.sw_stream_multi_reference.calls - k3 == (long < len(lengths))
    err = capsys.readouterr().err
    assert f"Note: {long} of {len(lengths)} queries exceed" in err
    want, _ = jax_pipeline.search_database_multi(queries, db, sc, engine="wavefront")
    assert got.shape == (len(lengths), db.n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gap_open", [-2, 2])
def test_mixed_batch_pads_no_profile_to_a_long_query(gap_open, shrunk, monkeypatch):
    """Only the short queries form the padded batch profile: a long record
    in the batch never pads every query to its length. With --gapopen 2
    (outside the stream kernel's envelope) every query goes to the
    wavefront engine, as before."""
    sc = make_scoring("BLOSUM62")
    sc.gap_open = gap_open
    rng = np.random.default_rng(110)
    queries = [sc.query_indices(random_protein(rng, lq)) for lq in (9, 40, 3)]
    db = _db(rng, 300)
    built = []
    real = pipeline.multi_profile

    def spy(table, query_idxs):
        out = real(table, query_idxs)
        built.append(out.shape[1])
        return out

    monkeypatch.setattr(pipeline, "multi_profile", spy)
    got, _ = pipeline.search_database_multi(queries, db, sc)
    assert built and max(built) <= swa_cuda.MAX_QUERY_ROWS
    want, _ = jax_pipeline.search_database_multi(queries, db, sc, engine="wavefront")
    np.testing.assert_array_equal(got, want)

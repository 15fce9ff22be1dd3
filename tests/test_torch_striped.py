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
    n = swa_cuda.MAX_QUERY_ROWS + 1
    long = np.zeros((n, 32), np.int32)
    rows = [s.shape[0] for s in profile_stripes(long, go, swa_cuda.STRIPE_ROWS, "cpu")]
    rest = n % swa_cuda.STRIPE_ROWS
    assert rest and rows == [swa_cuda.STRIPE_ROWS] * (n // swa_cuda.STRIPE_ROWS) + [
        -(-rest // ROW_ALIGN) * ROW_ALIGN]
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
        db, None, torch.device("cpu"), pipeline.striped_chunk_residues()))
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


# The warp-per-lane kernel: its rows per pass, and the inputs chip_smoke
# runs on the card (segments of 16 positions, a partial last pass).


@pytest.mark.parametrize("rows,r", [(1, 8), (256, 8), (257, 16), (600, 24), (1024, 32)])
def test_stripe_rows_is_a_team_of_rows_per_thread(rows, r):
    """STRIPE_ROWS is 32 threads x the rows per thread of a full pass, a
    multiple of ROW_ALIGN; a pass runs the smallest instance that holds it."""
    assert swa_cuda.STRIPE_TEAM == 32
    assert swa_cuda.STRIPE_ROWS == swa_cuda.STRIPE_TEAM * swa_cuda.STRIPE_ROWS_PER_THREAD
    assert swa_cuda.STRIPE_ROWS % ROW_ALIGN == 0
    assert swa_cuda.STRIPE_ROWS_PER_THREAD in swa_cuda.STRIPE_ROWS_PER_THREAD_BUILT
    assert all(k % ROW_ALIGN == 0 for k in swa_cuda.STRIPE_ROWS_PER_THREAD_BUILT)
    assert swa_cuda.stripe_rows_per_thread(rows) == r
    assert swa_cuda.stripe_rows_per_thread(swa_cuda.STRIPE_ROWS) == swa_cuda.STRIPE_ROWS_PER_THREAD
    with pytest.raises(ValueError, match="1025 rows"):
        swa_cuda.stripe_rows_per_thread(1025)


@pytest.mark.parametrize("rows,bnd_in,bnd_out,r,key", [
    (1024, False, True, None, "<32, false, true, false>"),
    (976, True, False, None, "<32, true, false, false>"),
    (976, True, True, None, "<32, true, true, true>"),
    (300, False, True, None, "<16, false, true, true>"),
    (576, True, False, 32, "<32, true, false, false>"),
    (580, True, True, 32, "<32, true, true, true>"),
])
def test_stripe_kernel_instance(rows, bnd_in, bnd_out, r, key):
    """The instance a pass launches, keyed as sass.kernel_key keys it: R
    the smallest that holds the rows unless given, kPartial only where the
    pass writes a last row that sits inside a thread."""
    got = swa_cuda.stripe_kernel_instance(rows, bnd_in, bnd_out, r)
    assert got == "sw_stream_striped_kernel" + key


def test_striped_pass_refuses_slots_the_segment_word_cannot_hold():
    """The kernel packs a slot from bit kSlotShift of a signed int32 word
    (the team step K2 shares with K1 and K3, csrc/sw_team.cuh):
    TEAM_MAX_SLOTS is the first slot that would set bit 31, and the pass
    refuses nslots from there on, on any device."""
    import re
    from pathlib import Path

    src = (Path(swa_cuda.__file__).resolve().parent.parent / "csrc" / "sw_team.cuh").read_text()
    shift = int(re.search(r"kSlotShift = (\d+);", src).group(1))
    assert (swa_cuda.TEAM_MAX_SLOTS - 1) << shift < 2**31 <= swa_cuda.TEAM_MAX_SLOTS << shift
    stripes, streams, fs, go, ge, kw = _small_case(96)
    bnd = torch.zeros((2, *streams.shape), dtype=torch.int32)
    for nslots in (swa_cuda.TEAM_MAX_SLOTS, swa_cuda.TEAM_MAX_SLOTS + 1):
        with pytest.raises(ValueError, match="segment word"):
            sw_stream_striped_pass(stripes[0], streams, fs, go, ge, bnd_out=bnd,
                                   nslots=nslots, jb=kw["jb"])


@pytest.mark.parametrize("r,ok", [(8, False), (12, False), (32, True), (None, True)])
def test_striped_pass_rows_per_thread(r, ok):
    """A pass takes the R of a built instance whose team holds its rows; on
    a CPU tensor the plain version runs whatever R is asked."""
    _, streams, fs, go, ge, kw = _small_case(400)
    q = make_scoring("BLOSUM45").query_indices(random_protein(np.random.default_rng(4), 300))
    st = profile_stripes(make_profile(make_scoring("BLOSUM45").table, q), go, 300, "cpu")[0]
    bnd = torch.zeros((2, *streams.shape), dtype=torch.int32)
    if not ok:
        with pytest.raises(ValueError, match="rows_per_thread"):
            sw_stream_striped_pass(st, streams, fs, go, ge, bnd_out=bnd,
                                   rows_per_thread=r, **kw)
        return
    out, _ = sw_stream_striped_pass(st, streams, fs, go, ge, bnd_out=bnd,
                                    rows_per_thread=r, **kw)
    ref, _ = sw_stream_striped_pass_reference(st, streams, fs, go, ge,
                                              bnd_out=bnd.clone(), **kw)
    assert torch.equal(out, ref)


def _short_records(rng, n):
    """Records of 1..16 residues: with blocks and grain of 16 every segment
    is one block, 16 positions, shorter than the kernel's 32-thread skew."""
    return random_records(rng, n, 1, 17)


@pytest.mark.parametrize("scoring,lq", [("BLOSUM62", SR + 5), ("PAM250", 2 * SR - 4)])
def test_sixteen_position_segments_match_jax_striped(scoring, lq):
    """The plain driver against sw_pallas_stream_striped in interpret mode
    on streams whose segments are all 16 positions long, a query length
    that is not a multiple of the stripe, and 128 x 3 + 37 records (empty
    lanes in the last lane group)."""
    sc = make_scoring(scoring)
    rng = np.random.default_rng(120 + lq)
    q = sc.query_indices(random_protein(rng, lq))
    nw, jb = 2, 16
    db = pipeline._db_from_encoded(_short_records(rng, WIN * 3 + 37))
    pack = pack_streams(db, np.argsort(-db.lengths, kind="stable"), nw, win=WIN,
                        jb=jb, grain=16)
    starts = (pack.fs[:, :, 0] > 0).sum(axis=0)
    assert pack.streams.shape[1] == jb * (starts.max() + 1)  # one block a segment
    nslots = len(pack.slot_ids)
    prof = make_profile(sc.table, q)
    go, ge = sc.gap_open_total, sc.gap_extend
    want = np.asarray(sw_pallas_stream_striped(
        prof, pack.streams, pack.fs, go, ge, nslots=nslots, sl=1, nw=nw,
        jb=jb, ui=4, stripe_rows=SR, interpret=True,
    ))
    streams, fs = stream_pack_to_torch(pack, "cpu")
    stripes = profile_stripes(prof, go, SR, "cpu")
    assert lq % SR and len(stripes) == -(-lq // SR)
    got = sw_stream_striped_reference(stripes, streams, fs, go, ge, nslots=nslots, jb=jb)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sixteen_position_segments_long_query_search(shrunk):
    """The same inputs through the long-query search (16-position segments,
    lq not a multiple of STRIPE_ROWS): equal to the JAX package's search."""
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(130)
    lq = 3 * SR + 5
    q = sc.query_indices(random_protein(rng, lq))
    db = pipeline._db_from_encoded(_short_records(rng, 3 * pipeline.WINDOW_LANES + 77))
    calls = sw_stream_striped_pass_reference.calls
    got, _ = pipeline.search_database(q, db, sc)
    assert sw_stream_striped_pass_reference.calls == calls + -(-lq // SR)
    want, _ = jax_pipeline.search_database(q, db, sc, engine="wavefront")
    np.testing.assert_array_equal(got, want)


def test_sass_keys_and_cells_of_the_striped_kernel():
    """K2's instances are keyed by R and their flags; the cells of its step
    loop are R, one LDS a row; cuobjdump's resource report parses."""
    from seqalign_tpu_torch import sass

    name = "_ZN12_GLOBAL__N_124sw_stream_striped_kernelILi32ELb1ELb1ELb0EEEvPKiPKaS3_Pi"
    key = sass.kernel_key(name)
    assert key == "sw_stream_striped_kernel<32, true, true, false>"
    assert sass.expected_cells(key) == 32 * sass.STRIPED_POSITIONS_PER_STEP
    with pytest.raises(ValueError, match="no team kernel instance"):
        sass.expected_cells("sw_stream_kernel")  # no R
    text = "\n".join([
        "Resource usage:",
        " Common:",
        "  GLOBAL:0",
        f" Function {name}:",
        "  REG:96 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:600 TEXTURE:0 SURFACE:0 SAMPLER:0",
        " Function _Z3foov:",
        "  REG:8 STACK:16 SHARED:0 LOCAL:24 CONSTANT[0]:352",
    ])
    usage = sass.resource_usage(None, text)
    assert usage[name]["REG"] == 96 and usage[name]["LOCAL"] == 0
    assert usage["_Z3foov"] == {"REG": 8, "STACK": 16, "SHARED": 0, "LOCAL": 24,
                                "CONSTANT[0]": 352}


def test_sass_counts_the_busier_integer_pipe():
    """IMAD issues on the FMA pipe beside the ALU pipe: a loop's bound
    counts the busier one, and the probe's factor compares the measured
    rates with the data sheet's on the same two pipes."""
    from seqalign_tpu_torch import probe, sass

    text = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_116sw_stream_kernelEv",
        "        /*0000*/                   LDS R4, [R3] ;",
        "        /*0010*/                   IMAD.IADD R7, R4, 0x1, R6 ;",
        "        /*0020*/                   VIADDMNMX R5, R5, R3, R4, !PT ;",
        "        /*0030*/                   LDS R6, [R3+0x80] ;",
        "        /*0040*/                   IMAD.MOV.U32 R8, RZ, RZ, R6 ;",
        "        /*0050*/                   VIMNMX3.RELU R6, R5, R4, R6 ;",
        "        /*0060*/                   VIADD R9, R6, 0x1 ;",
        "        /*0070*/               @P0 BRA 0x0 ;",
    ])
    loop = sass.inner_loop(sass.sass_functions(None, text)["_ZN12_GLOBAL__N_116sw_stream_kernelEv"])
    assert loop["cells"] == 2 and loop["alu_per_cell"] == 2.5
    assert loop["imad_per_cell"] == 1.0 and loop["pipe_per_cell"] == 1.5
    rate = probe.INT32_PER_S
    measured = {name: {"per_s": rate, "opcode": op} for name, op in (
        ("VIADDMNMX", "VIADDMNMX"), ("VIMNMX3", "VIMNMX3"), ("IADD3", "IADD3"),
        ("IMNMX", "VIMNMX"), ("LDS", "LDS"), ("IMAD", "IMAD"))}
    measured["IMAD+VIADDMNMX"] = {"per_s": 2 * rate, "opcode": "IMAD"}
    assert probe.bound_factor(loop["opcodes"], measured) == pytest.approx(1.0)
    measured["VIADDMNMX"]["per_s"] = rate / 4  # one of 3 ALU-pipe ops 4x slower
    assert probe.bound_factor(loop["opcodes"], measured) == pytest.approx(2.0)


def test_sass_counts_shuffles_off_the_alu_pipe():
    """K2's SHFLs take the shared-memory path with LDS (the probe runs SHFL
    beside VIADDMNMX at twice the rate of either): a loop's ALU count and
    its busier pipe leave them out, and so does the probe's factor, however
    slow SHFL is measured."""
    from seqalign_tpu_torch import probe, sass

    text = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_124sw_stream_striped_kernelILi1ELb1ELb0ELb0EEEvv",
        "        /*0000*/                   SHFL.UP PT, R2, R9, 0x1, RZ ;",
        "        /*0010*/                   LDS R4, [R3] ;",
        "        /*0020*/                   VIADDMNMX R5, R5, R3, R4, !PT ;",
        "        /*0030*/                   SHFL.IDX PT, R6, R8, R7, 0x1f ;",
        "        /*0040*/                   LDS R6, [R3+0x80] ;",
        "        /*0050*/                   VIMNMX3.RELU R6, R5, R4, R6 ;",
        "        /*0060*/               @P0 BRA 0x0 ;",
    ])
    loop = sass.inner_loop(sass.sass_functions(None, text)[
        "_ZN12_GLOBAL__N_124sw_stream_striped_kernelILi1ELb1ELb0ELb0EEEvv"])
    assert loop["cells"] == 2 and loop["opcodes"]["SHFL"] == 2
    assert loop["alu_per_cell"] == 1.0 and loop["pipe_per_cell"] == 1.0
    rate = probe.INT32_PER_S
    measured = {name: {"per_s": rate, "opcode": op} for name, op in (
        ("VIADDMNMX", "VIADDMNMX"), ("VIMNMX3", "VIMNMX3"), ("IADD3", "IADD3"),
        ("IMNMX", "VIMNMX"), ("LDS", "LDS"), ("IMAD", "IMAD"), ("SHFL", "SHFL"))}
    measured["SHFL"]["per_s"] = rate / 100
    assert probe.bound_factor(loop["opcodes"], measured) == pytest.approx(1.0)

"""The port's multi-query search (the K3 kernel's plain version, the
multi-query pipeline) against the JAX package on the CPU: identical int32
scores on the same numpy inputs."""

import numpy as np
import pytest
import torch

from seqalign_tpu import pipeline as jax_pipeline
from seqalign_tpu.ops.oracle import sw_score_batch
from seqalign_tpu.ops.swa_pallas import sw_pallas_stream
from seqalign_tpu.utils.native_io import EncodedDatabase
from seqalign_tpu.utils.packing import pack_streams
from seqalign_tpu_torch import pipeline
from seqalign_tpu_torch.convert import profile_to_torch, stream_pack_to_torch
from seqalign_tpu_torch.ops.swa_cuda import (
    MAX_QUERY_ROWS, sw_stream, sw_stream_multi, sw_stream_multi_reference,
)

from _torch_cases import make_scoring, random_records
from conftest import random_protein

WIN, JB = 128, 4  # one 128-lane TPU window (sl=1), the smallest stream shape


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")


# name: (scoring, query lengths, records, lo, hi, nw, grain, keep order)
STREAM_CASES = {
    "BLOSUM62": ("BLOSUM62", (10, 6), 700, 1, 14, 2, 8, False),
    "PAM250": ("PAM250", (7, 11), 700, 1, 14, 2, 8, False),
    "match_mismatch": ("match_mismatch", (9, 4), 700, 1, 14, 2, 8, False),
    "go_eq_ge": ("go_eq_ge", (5, 10), 700, 1, 14, 2, 8, False),
    "three_queries": ("BLOSUM45", (3, 9, 6), 500, 1, 12, 2, 8, False),
    "tail_segment": ("BLOSUM62", (8, 5), None, 0, 0, 1, JB, True),
    "empty_window": ("PAM250", (7, 4), 200, 1, 12, 3, 8, False),
    "empty_query": ("random", (6, 0, 9), 400, 1, 12, 2, 8, False),
    # Queries of unequal lengths up to 24 rows, one empty: on the card one
    # thread a lane scores Q of them (the solo kernel), and 3, 5 and 9 leave
    # the last z slice of Q = 2 or 4 partial.
    "unequal_nq3_BLOSUM62": ("BLOSUM62", (24, 0, 13), 700, 1, 14, 2, 8, False),
    "unequal_nq3_PAM250": ("PAM250", (7, 24, 0), 700, 1, 14, 2, 8, False),
    "unequal_nq5_BLOSUM62": ("BLOSUM62", (17, 9, 0, 24, 5), 700, 1, 14, 2, 8, False),
    "unequal_nq5_PAM250": ("PAM250", (0, 22, 17, 3, 12), 700, 1, 14, 2, 8, False),
    "unequal_nq9_BLOSUM62": ("BLOSUM62", (24, 3, 0, 17, 11, 20, 6, 24, 1), 700, 1, 14, 2, 8,
                             False),
    "unequal_nq9_PAM250": ("PAM250", (9, 17, 24, 2, 13, 0, 21, 5, 17), 700, 1, 14, 2, 8, False),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_multi_reference_matches_pallas_stream(case):
    """K3's plain version against ``sw_pallas_stream`` with a 3-D profile
    (interpret mode), slot by slot, on the same ``pack_streams`` output;
    for the ``unequal`` groupings the wrapper too, at its chooser's Q and
    at every Q built (on the CPU, the plain version)."""
    name, lqs, n, lo, hi, nw, grain, keep = STREAM_CASES[case]
    sc = make_scoring(name)
    rng = np.random.default_rng(sorted(STREAM_CASES).index(case) + 40)
    queries = [sc.query_indices(random_protein(rng, lq)) for lq in lqs]
    if case == "tail_segment":
        # Segments of 20 and 4 positions: the second starts on the final
        # block, so its start flush and the window's end flush coincide.
        encoded = random_records(rng, WIN, 20, 21) + random_records(rng, WIN, 3, 4)
    else:
        encoded = random_records(rng, n, lo, hi)
    db = pipeline._db_from_encoded(encoded)
    order = np.arange(db.n) if keep else np.argsort(-db.lengths, kind="stable")
    pack = pack_streams(db, order, nw, win=WIN, jb=JB, grain=grain)
    nslots = len(pack.slot_ids)
    if case == "tail_segment":
        starts = np.nonzero(pack.fs[:, 0, 0])[0]
        assert len(starts) == 1 and starts[0] == pack.fs.shape[0] - 1
    elif case == "empty_window":
        assert not pack.fs[:, nw - 1].any()
    else:
        assert (pack.fs[:, :, 0] > 0).sum() >= 2  # flush + reset mid-stream
    profs = pipeline.multi_profile(sc.table, queries)
    go, ge = sc.gap_open_total, sc.gap_extend
    want = np.asarray(
        sw_pallas_stream(
            profs, pack.streams, pack.fs, go, ge,
            nslots=nslots, sl=1, nw=nw, jb=JB, ui=4, interpret=True,
        )
    )
    streams, fs = stream_pack_to_torch(pack, "cpu")
    got = sw_stream_multi_reference(
        profile_to_torch(profs, go, "cpu"), streams, fs, go, ge,
        nslots=nslots, jb=JB,
    ).numpy()
    assert got.shape == want.shape == (nslots, len(lqs), WIN)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case == "empty_query":
        assert not got[:, 1].any() and got[:, 0].any()
    if case.startswith("unequal"):
        from seqalign_tpu_torch.ops.swa_cuda import STREAM_SOLO_QUERIES, stream_team

        prof = profile_to_torch(profs, go, "cpu")
        team = stream_team(max(lqs))
        assert team[0] == 1 and not got[:, lqs.index(0)].any()
        for q in (None, *STREAM_SOLO_QUERIES[team[1]]):
            np.testing.assert_array_equal(sw_stream_multi(
                prof, streams, fs, go, ge, nslots=nslots, jb=JB, rows=max(lqs),
                queries=q).numpy(), want)


def _pack_case(seed=50, nq=2):
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(seed)
    queries = [sc.query_indices(random_protein(rng, 4 + 3 * k)) for k in range(nq)]
    db = pipeline._db_from_encoded(random_records(rng, 300, 1, 10))
    pack = pack_streams(db, np.argsort(-db.lengths, kind="stable"), 2,
                        win=WIN, jb=JB, grain=8)
    go, ge = sc.gap_open_total, sc.gap_extend
    prof = profile_to_torch(pipeline.multi_profile(sc.table, queries), go, "cpu")
    streams, fs = stream_pack_to_torch(pack, "cpu")
    return prof, streams, fs, go, ge, dict(nslots=len(pack.slot_ids), jb=JB)


def test_multi_wrapper_on_cpu_is_the_plain_version():
    prof, streams, fs, go, ge, kw = _pack_case()
    launches, calls = sw_stream_multi.launches, sw_stream_multi_reference.calls
    got = sw_stream_multi(prof, streams, fs, go, ge, **kw)
    assert sw_stream_multi.launches == launches  # no kernel on a CPU tensor
    assert sw_stream_multi_reference.calls == calls + 1
    assert torch.equal(got, sw_stream_multi_reference(prof, streams, fs, go, ge, **kw))


def test_multi_query_equals_single_query_kernel():
    """Each query's column of K3's output is K1's output for that query."""
    prof, streams, fs, go, ge, kw = _pack_case(seed=51, nq=3)
    got = sw_stream_multi(prof, streams, fs, go, ge, **kw)
    for k in range(prof.shape[0]):
        assert torch.equal(got[:, k], sw_stream(prof[k].contiguous(), streams, fs, go, ge, **kw))


@pytest.mark.parametrize("bad", ["two_d", "rows", "too_long"])
def test_multi_wrapper_rejects_malformed_profile(bad):
    prof, streams, fs, go, ge, kw = _pack_case(seed=52)
    err = ValueError
    if bad == "two_d":
        prof = prof[0]
    elif bad == "rows":
        prof = prof[:, :3].contiguous()
    else:
        prof = torch.zeros((2, MAX_QUERY_ROWS + 4, 32), dtype=torch.int32)
        err = NotImplementedError
    with pytest.raises(err):
        sw_stream_multi(prof, streams, fs, go, ge, **kw)


def test_profile_to_torch_three_d():
    sc = make_scoring("PAM250")
    profs = pipeline.multi_profile(sc.table, [sc.query_indices("MKVLA"), sc.query_indices("HEA")])
    go = sc.gap_open_total
    t = profile_to_torch(profs, go, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (2, 8, 32)
    np.testing.assert_array_equal(t[:, :5].numpy(), profs - go)
    assert not t[:, 5:].any()
    with pytest.raises(ValueError):
        profile_to_torch(np.zeros(32, np.int32), go, "cpu")


def _db(rng, n, lo=1, hi=24):
    return pipeline._db_from_encoded(random_records(rng, n, lo, hi))


def _queries(sc, rng, lengths):
    return [sc.query_indices(random_protein(rng, lq)) for lq in lengths]


@pytest.mark.parametrize(
    "scoring,lengths,budget_queries",
    [
        ("BLOSUM62", (12, 5, 9), None),  # one block of three
        ("PAM250", (7, 13, 4), 2),  # blocks of 2: the last one zero-padded
        ("match_mismatch", (6, 0, 10, 3, 8), 2),  # an empty query, 3 blocks
    ],
)
def test_search_database_multi_matches_jax(scoring, lengths, budget_queries, monkeypatch):
    """1500 records, several segments per window, scattered back from length
    order; against JAX's ``search_database_multi`` (wavefront) and, on a few
    records, the oracle."""
    sc = make_scoring(scoring)
    rng = np.random.default_rng(60 + len(lengths))
    queries = _queries(sc, rng, lengths)
    db = _db(rng, 1500)
    nq = len(queries)
    if budget_queries is not None:
        # Room for budget_queries queries' output (the database's slots).
        per_query = 4 * pipeline.WINDOW_LANES * -(-db.n // pipeline.WINDOW_LANES)
        monkeypatch.setattr(pipeline, "MULTI_SCRATCH_BYTES", budget_queries * per_query)
    nq_b = budget_queries or nq
    calls = sw_stream_multi_reference.calls
    got, dt = pipeline.search_database_multi(queries, db, sc)
    assert sw_stream_multi_reference.calls == calls + -(-nq // nq_b)  # one chunk
    want, _ = jax_pipeline.search_database_multi(queries, db, sc, engine="wavefront")
    assert got.shape == (nq, db.n) and got.dtype == np.int32 and dt > 0
    np.testing.assert_array_equal(got, want)
    pick = rng.choice(db.n, 12, replace=False)
    for k, q in enumerate(queries):
        oracle = sw_score_batch(
            q, [db.record(int(r)) for r in pick], sc.table, sc.gap_open, sc.gap_extend
        )
        np.testing.assert_array_equal(got[k, pick], oracle)
        if len(q) == 0:
            assert not got[k].any()


def test_choose_query_block():
    # A query's output at Swiss-Prot scale (2,208 slots of 256 lanes) is
    # 2.26 MB: 64 queries take one block of 8 GiB.
    assert pipeline.choose_query_block(64, 2208, 256) == 64
    assert pipeline.choose_query_block(8, 2208, 256) == 8
    # 4,096 slots take 4 MiB a query: 2,048 fit, and 5,000 queries are
    # three blocks of 1,667 (one query padded), not 2,048 + 2,048 + 904.
    assert pipeline.choose_query_block(5000, pipeline.MAX_STREAM_SLOTS, 256) == 1667
    assert pipeline.choose_query_block(1, 0, 256) == 1


@pytest.mark.parametrize("budget_queries,blocks", [(None, 1), (22, 3), (30, 3), (1, 64)])
def test_query_blocks_at_swissprot_scale(budget_queries, blocks, monkeypatch):
    """64 queries of 144 residues over 565,247 records: the launch holds
    only its output (2,208 slots of 256 lanes a query), so the 8 GiB budget
    takes them in one block; a budget of fewer queries still cuts even
    blocks, the last one filled up with zero profiles."""
    n = 565_247
    if budget_queries is not None:
        per_query = 4 * pipeline.WINDOW_LANES * -(-n // pipeline.WINDOW_LANES)
        monkeypatch.setattr(pipeline, "MULTI_SCRATCH_BYTES", budget_queries * per_query)
    profile = np.ones((64, 144, 32), np.int32)
    got = pipeline.query_blocks(profile, -3, n, torch.device("cpu"))
    assert len(got) == blocks
    assert {tuple(b.shape) for b in got} == {(-(-64 // blocks), 144, 32)}
    stacked = torch.cat(got)
    assert torch.equal(stacked[:64], torch.full((64, 144, 32), 4, dtype=torch.int32))
    assert not stacked[64:].any()


@pytest.mark.parametrize("engine", ["wavefront", "scan"])
def test_multi_lane_batch_engines_search_each_query(engine):
    sc = make_scoring("BLOSUM45")
    rng = np.random.default_rng(70)
    queries = _queries(sc, rng, (5, 8))
    db = _db(rng, 40 if engine == "scan" else 300, 1, 16)
    calls = sw_stream_multi_reference.calls
    got, _ = pipeline.search_database_multi(queries, db, sc, engine=engine)
    assert sw_stream_multi_reference.calls == calls
    want, _ = jax_pipeline.search_database_multi(queries, db, sc, engine="wavefront")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lanes,sort", [(256, True), (None, False), (1024, True)])
def test_multi_lane_override_and_unsorted(lanes, sort):
    sc = make_scoring("random")
    rng = np.random.default_rng(71)
    queries = _queries(sc, rng, (9, 4))
    db = _db(rng, 900)
    got, _ = pipeline.search_database_multi(queries, db, sc, lanes=lanes, sort=sort)
    want, _ = jax_pipeline.search_database_multi(queries, db, sc, engine="wavefront")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("empty", ["queries", "database"])
def test_multi_empty_inputs(empty):
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(72)
    if empty == "queries":
        queries, db = [], _db(rng, 10)
    else:
        queries = _queries(sc, rng, (3, 5))
        db = EncodedDatabase(np.zeros(0, np.int8), np.zeros(1, np.int64), [])
    got, dt = pipeline.search_database_multi(queries, db, sc)
    want, _ = jax_pipeline.search_database_multi(queries, db, sc, engine="wavefront")
    assert dt == 0.0 and got.shape == want.shape == (len(queries), db.n)


def test_multi_positive_gap_open_searches_each_query_with_wavefront(capsys):
    """--gapopen 2 is outside the G-form: every query goes to the wavefront
    engine, and the search says so."""
    sc = make_scoring("BLOSUM62")
    sc.gap_open = 2
    rng = np.random.default_rng(73)
    queries = _queries(sc, rng, (8, 5))
    db = _db(rng, 60)
    calls = sw_stream_multi_reference.calls
    got, _ = pipeline.search_database_multi(queries, db, sc)
    assert sw_stream_multi_reference.calls == calls
    assert "Note:" in capsys.readouterr().err
    want, _ = jax_pipeline.search_database_multi(queries, db, sc, engine="wavefront")
    np.testing.assert_array_equal(got, want)


def test_multi_query_above_row_limit_raises_naming_k2(capsys, monkeypatch):
    """A batch holding a query one row over MAX_QUERY_ROWS is no longer
    refused: the short query runs through K3, the long one through K2, and
    the search says so; the scores equal the JAX package's. The limits are
    shrunk (16 rows, stripes of 8) to keep the plain versions cheap."""
    from seqalign_tpu_torch.ops import swa_cuda

    monkeypatch.setattr(swa_cuda, "MAX_QUERY_ROWS", 16)
    monkeypatch.setattr(swa_cuda, "STRIPE_ROWS", 8)
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(74)
    queries = _queries(sc, rng, (10, swa_cuda.MAX_QUERY_ROWS + 1))
    db = _db(rng, 5)
    calls = sw_stream_multi_reference.calls
    got, _ = pipeline.search_database_multi(queries, db, sc)
    assert sw_stream_multi_reference.calls == calls + 1
    assert "Note: 1 of 2 queries exceed MAX_QUERY_ROWS" in capsys.readouterr().err
    want, _ = jax_pipeline.search_database_multi(queries, db, sc, engine="wavefront")
    np.testing.assert_array_equal(got, want)


def test_multi_cpu_search_launches_no_kernel():
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(75)
    launches = sw_stream_multi.launches
    pipeline.search_database_multi(_queries(sc, rng, (4, 6)), _db(rng, 30), sc)
    assert sw_stream_multi.launches == launches


def test_search_files_multi_matches_jax(tmp_path):
    sc = make_scoring("PAM250")
    rng = np.random.default_rng(76)
    qp = tmp_path / "q.fa"
    qp.write_text("".join(
        f">q{k} query {k}\n{random_protein(rng, 6 + 5 * k)}\n" for k in range(3)
    ))
    dp = tmp_path / "db.fa"
    dp.write_text("".join(
        f">r{k}\n{random_protein(rng, int(rng.integers(1, 40)))}\n"
        for k in range(300)
    ))
    got = pipeline.search_files_multi(str(qp), str(dp), sc)
    want = jax_pipeline.search_files_multi(str(qp), str(dp), sc, engine="wavefront")
    assert got.query_names == want.query_names == ["q0 query 0", "q1 query 1", "q2 query 2"]
    assert got.query_seqs == want.query_seqs
    assert got.names == want.names and got.total_entries == 300
    np.testing.assert_array_equal(got.scores, want.scores)
    empty = tmp_path / "empty.fa"
    empty.write_text("")
    with pytest.raises(ValueError):
        pipeline.search_files_multi(str(empty), str(dp), sc)

"""The port's search pipeline against the JAX package's, on the CPU
(``SEQALIGN_PLATFORM=cpu``): identical int32 scores in database order."""

import gzip

import numpy as np
import pytest
import torch

from seqalign_tpu import pipeline as jax_pipeline
from seqalign_tpu.utils.native_io import EncodedDatabase
from seqalign_tpu_torch import pipeline
from seqalign_tpu_torch.ops import swa_cuda
from seqalign_tpu_torch.ops.swa_cuda import (
    sw_stream, sw_stream_reference, sw_stream_striped_pass_reference,
)

from _torch_cases import make_scoring, random_records
from conftest import random_protein


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")


def _db(rng, n, lo=1, hi=24):
    return pipeline._db_from_encoded(random_records(rng, n, lo, hi))


@pytest.mark.parametrize("scoring", ["BLOSUM62", "PAM250", "match_mismatch"])
def test_stream_search_matches_oracle(scoring):
    """1500 records: six 256-lane segments, several per window, a partial
    final lane group, scattered back from length order."""
    sc = make_scoring(scoring)
    rng = np.random.default_rng(21)
    q = sc.query_indices(random_protein(rng, 12))
    db = _db(rng, 1500)
    calls = sw_stream_reference.calls
    got, dt = pipeline.search_database(q, db, sc)
    assert sw_stream_reference.calls == calls + 1  # one launch for one chunk
    want, _ = jax_pipeline.search_database(q, db, sc, engine="oracle")
    assert got.dtype == np.int32 and dt > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("engine", ["stream", "wavefront", "scan"])
def test_engines_match_jax_wavefront(engine):
    sc = make_scoring("BLOSUM45")
    rng = np.random.default_rng(22)
    q = sc.query_indices(random_protein(rng, 7))
    db = _db(rng, 600 if engine != "scan" else 40, 1, 16)
    got, _ = pipeline.search_database(q, db, sc, engine=engine)
    want, _ = jax_pipeline.search_database(q, db, sc, engine="wavefront")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lanes", [None, 256, 1024])
def test_unsorted_and_lane_overrides_agree(lanes):
    sc = make_scoring("random")
    rng = np.random.default_rng(23)
    q = sc.query_indices(random_protein(rng, 9))
    db = _db(rng, 900)
    a, _ = pipeline.search_database(q, db, sc, lanes=lanes)
    b, _ = pipeline.search_database(q, db, sc, lanes=lanes, sort=False)
    want, _ = jax_pipeline.search_database(q, db, sc, engine="wavefront")
    np.testing.assert_array_equal(a, want)
    np.testing.assert_array_equal(b, want)


@pytest.mark.parametrize("empty", ["query", "database"])
def test_empty_inputs_give_zeros(empty):
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(24)
    if empty == "query":
        q, db = np.zeros(0, np.int32), _db(rng, 10)
    else:
        q = sc.query_indices("MKV")
        db = EncodedDatabase(np.zeros(0, np.int8), np.zeros(1, np.int64), [])
    got, dt = pipeline.search_database(q, db, sc)
    assert dt == 0.0
    np.testing.assert_array_equal(got, np.zeros(db.n, np.int32))


def test_positive_gap_open_routes_to_wavefront(capsys):
    """--gapopen 2 gives ge < go: outside the G-form, so the wavefront
    engine scores it, and says so. A positive gap makes '*' padding score,
    so the reference is the JAX package's own route for this system (its
    wavefront engine over the same lane batches), not the unpadded oracle."""
    sc = make_scoring("BLOSUM62")
    sc.gap_open = 2
    rng = np.random.default_rng(25)
    q = sc.query_indices(random_protein(rng, 8))
    db = _db(rng, 60)
    calls = sw_stream_reference.calls
    got, _ = pipeline.search_database(q, db, sc)
    assert sw_stream_reference.calls == calls
    assert "Note:" in capsys.readouterr().err
    want, _ = jax_pipeline.search_database(q, db, sc, engine="wavefront")
    np.testing.assert_array_equal(got, want)


def test_query_above_row_limit_raises_naming_k2(monkeypatch):
    """A query one row over MAX_QUERY_ROWS is no longer refused: the
    row-striped kernel (K2; its plain version here) scores it, in stripes
    of STRIPE_ROWS, equal to the JAX package's scores. The limits are
    shrunk (16 rows, stripes of 8) to keep the plain version cheap."""
    monkeypatch.setattr(swa_cuda, "MAX_QUERY_ROWS", 16)
    monkeypatch.setattr(swa_cuda, "STRIPE_ROWS", 8)
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(26)
    q = sc.query_indices(random_protein(rng, swa_cuda.MAX_QUERY_ROWS + 1))
    db = _db(rng, 5)
    calls = sw_stream_striped_pass_reference.calls
    got, dt = pipeline.search_database(q, db, sc)
    assert sw_stream_striped_pass_reference.calls == calls + -(-len(q) // swa_cuda.STRIPE_ROWS)
    want, _ = jax_pipeline.search_database(q, db, sc, engine="wavefront")
    assert got.dtype == np.int32 and dt > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scoring", ["BLOSUM62", "PAM250", "match_mismatch", "gapopen_2"])
def test_oracle_engine_matches_jax_oracle(scoring):
    """``engine="oracle"`` scores every record with the port's copy of the
    NumPy oracle, as the JAX package's ``oracle`` engine does, including
    --gapopen 2 (outside the kernels' G-form: the oracle takes any system)."""
    sc = make_scoring("BLOSUM62" if scoring == "gapopen_2" else scoring)
    if scoring == "gapopen_2":
        sc.gap_open = 2
    rng = np.random.default_rng(29)
    q = sc.query_indices(random_protein(rng, 11))
    db = _db(rng, 80)
    calls = sw_stream_reference.calls
    got, dt = pipeline.search_database(q, db, sc, engine="oracle")
    assert sw_stream_reference.calls == calls  # no kernel, no plain version
    want, _ = jax_pipeline.search_database(q, db, sc, engine="oracle")
    assert got.dtype == np.int32 and got.shape == (db.n,) and dt > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("multi", [False, True])
def test_pallas_engine_is_the_stream_route(multi):
    """``engine="pallas"``, the JAX package's name for its kernel route, runs
    the port's stream kernels (their plain versions on the CPU): the same
    scores as the default engine and as the JAX oracle."""
    sc = make_scoring("PAM250")
    rng = np.random.default_rng(30)
    qs = [sc.query_indices(random_protein(rng, k)) for k in (9, 14)]
    db = _db(rng, 700)
    ref = swa_cuda.sw_stream_multi_reference if multi else sw_stream_reference
    calls = ref.calls
    if multi:
        got, _ = pipeline.search_database_multi(qs, db, sc, engine="pallas")
        want, _ = jax_pipeline.search_database_multi(qs, db, sc, engine="oracle")
    else:
        got, _ = pipeline.search_database(qs[0], db, sc, engine="pallas")
        want, _ = jax_pipeline.search_database(qs[0], db, sc, engine="oracle")
    assert ref.calls == calls + 1
    np.testing.assert_array_equal(got, want)


def test_oracle_engine_searches_each_query_of_a_batch():
    sc = make_scoring("BLOSUM45")
    rng = np.random.default_rng(31)
    qs = [sc.query_indices(random_protein(rng, k)) for k in (6, 0, 10)]
    db = _db(rng, 50)
    calls = swa_cuda.sw_stream_multi_reference.calls
    got, dt = pipeline.search_database_multi(qs, db, sc, engine="oracle")
    assert swa_cuda.sw_stream_multi_reference.calls == calls and dt > 0
    want, _ = jax_pipeline.search_database_multi(qs, db, sc, engine="oracle")
    np.testing.assert_array_equal(got, want)
    assert not got[1].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_copy_matches_jax_oracle(seed):
    """The port's ``ops/oracle.py`` is a copy of the JAX package's: the same
    scores on random queries, records and gap penalties."""
    from seqalign_tpu.ops import oracle as jax_oracle
    from seqalign_tpu_torch.ops import oracle

    rng = np.random.default_rng(40 + seed)
    sc = make_scoring(["BLOSUM62", "random", "match_mismatch"][seed])
    go, ge = int(rng.integers(-6, 1)), int(rng.integers(-3, 0))
    q = sc.query_indices(random_protein(rng, int(rng.integers(1, 30))))
    recs = random_records(rng, 25, 0, 40)
    got = oracle.sw_score_batch(q, recs, sc.table, go, ge)
    want = jax_oracle.sw_score_batch(q, recs, sc.table, go, ge)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert oracle.sw_score_single(q, recs[0], sc.table, go, ge) == want[0]


@pytest.mark.parametrize("multi", [False, True])
def test_stream_search_scores_only_the_query_rows(multi, monkeypatch):
    """The pipeline launches K1 and K3 on the ROW_ALIGN-padded profile with
    ``rows`` = the query's length (a batch's longest), so the one-pass
    kernel skips the padding rows."""
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(33)
    qs = [sc.query_indices(random_protein(rng, k)) for k in (17, 9)]
    db = _db(rng, 300)
    name = "sw_stream_multi" if multi else "sw_stream"
    fn, seen = getattr(pipeline, name), []

    def spy(prof, *a, **kw):
        seen.append((prof.shape[-2], kw["rows"]))
        return fn(prof, *a, **kw)

    monkeypatch.setattr(pipeline, name, spy)
    if multi:
        got, _ = pipeline.search_database_multi(qs, db, sc)
        want, _ = jax_pipeline.search_database_multi(qs, db, sc, engine="wavefront")
    else:
        got, _ = pipeline.search_database(qs[0], db, sc)
        want, _ = jax_pipeline.search_database(qs[0], db, sc, engine="wavefront")
    assert seen == [(20, 17)]
    np.testing.assert_array_equal(got, want)


def test_unknown_engine_raises():
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(32)
    with pytest.raises(KeyError, match="unknown engine"):
        pipeline.search_database(sc.query_indices("MKV"), _db(rng, 5), sc, engine="tpu")


def test_no_gpu_is_an_error(monkeypatch):
    monkeypatch.delenv("SEQALIGN_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.resolve_device()
    with pytest.raises(ValueError):
        pipeline.resolve_device("tpu")


def test_cpu_search_launches_no_kernel():
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(27)
    launches = sw_stream.launches
    pipeline.search_database(sc.query_indices("MKVL"), _db(rng, 30), sc)
    assert sw_stream.launches == launches


def test_choose_windows():
    lengths = np.array([64] * 256 + [16] * 1024)  # segments 64,16,16,16,16
    assert pipeline.choose_windows(lengths, 256, None) == 2  # 128 // 64
    assert pipeline.choose_windows(lengths, 256, 768) == 3
    assert pipeline.choose_windows(lengths, 256, 10**6) == 5  # <= segments
    assert pipeline.choose_windows(lengths[:5], 256, None) == 1
    assert pipeline.choose_windows(lengths, 256, None, max_lanes=256) == 1
    assert pipeline.resident_lanes(torch.device("cpu")) is None


def test_search_files_gzip_matches_jax(tmp_path):
    sc = make_scoring("PAM250")
    rng = np.random.default_rng(28)
    qp = tmp_path / "q.fa"
    qp.write_text(">q1 query\n" + random_protein(rng, 20) + "\n")
    dp = tmp_path / "db.fa.gz"
    recs = "".join(
        f">r{k}\n{random_protein(rng, int(rng.integers(1, 40)))}\n"
        for k in range(300)
    )
    with gzip.open(dp, "wt") as f:
        f.write(recs)
    got = pipeline.search_files(str(qp), str(dp), sc)
    want = jax_pipeline.search_files(str(qp), str(dp), sc, engine="oracle")
    assert got.names == want.names and got.total_entries == 300
    assert got.query_name == want.query_name
    np.testing.assert_array_equal(got.scores, want.scores)


def test_swissprot_fasta_round_trip(tmp_path):
    """The Swiss-Prot generator's FASTA writer parses back to the same
    encoded database (here at a few records)."""
    from seqalign_tpu_torch.host import parse_file_cached
    from seqalign_tpu_torch.swissprot import random_query, write_fasta

    rng = np.random.default_rng(5)
    db = _db(rng, 40, lo=2, hi=90)
    path = tmp_path / "db.fa"
    write_fasta(db, path)
    parsed = parse_file_cached(str(path), None)
    np.testing.assert_array_equal(parsed.offsets, db.offsets)
    np.testing.assert_array_equal(parsed.seq, db.seq)
    q = random_query(17, 3)
    assert q.shape == (17,) and q.dtype == np.int32 and q.max() < 31

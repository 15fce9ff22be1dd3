"""The port's traceback (``ops.traceback``) and wavefront ends engine
(``ops.swa_torch.sw_wavefront_ends``) against the JAX package's, on the
CPU: identical scores, end cells, coordinates, gapped strings and CIGARs,
through the native fill and through NumPy, direct and localized."""

import dataclasses

import numpy as np
import pytest
import torch

from seqalign_tpu.ops import swa_xla
from seqalign_tpu.ops import traceback as jax_tb
from seqalign_tpu.utils.native_io import EncodedDatabase
from seqalign_tpu_torch.ops import swa_torch
from seqalign_tpu_torch.ops import traceback as tb

from _torch_cases import SCORINGS, make_scoring, random_records
from conftest import random_protein


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")


def _ends(mod_fn, prof, dbm, go, ge):
    return tuple(np.asarray(x) for x in mod_fn(prof, dbm, go, ge))


def _tie_batch(rng, q):
    """Lanes made to tie: the query twice, a repeated motif, a lane of
    '*', an empty lane and random records."""
    lanes = [np.concatenate([q, q]), np.tile(q[:3], 9), q[::-1].copy(),
             np.zeros(0, np.int8)]
    lanes += random_records(rng, 12, 1, 40)
    lb = max(len(x) for x in lanes) + 5
    dbm = np.full((lb, len(lanes) + 1), 31, np.int32)
    for k, s in enumerate(lanes):
        dbm[: len(s), k] = s
    return dbm


@pytest.mark.parametrize("scoring", SCORINGS)
def test_wavefront_ends_matches_jax(scoring):
    sc = make_scoring(scoring)
    rng = np.random.default_rng(61)
    q = sc.query_indices(random_protein(rng, 9) + "W")
    dbm = _tie_batch(rng, q.astype(np.int8))
    prof = swa_torch.make_profile(sc.table, q)
    go, ge = sc.gap_open_total, sc.gap_extend
    calls = swa_torch.sw_wavefront_ends.calls
    got = _ends(swa_torch.sw_wavefront_ends, torch.from_numpy(prof),
                torch.from_numpy(dbm), go, ge)
    assert swa_torch.sw_wavefront_ends.calls == calls + 1
    want = _ends(swa_xla.sw_wavefront_ends, prof, dbm, go, ge)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        got[0], swa_torch.sw_wavefront(torch.from_numpy(prof), torch.from_numpy(dbm),
                                       go, ge).numpy())
    assert (got[1][got[0] == 0] == 0).all() and (got[2][got[0] == 0] == 0).all()


def test_wavefront_ends_tie_rule():
    """Match/mismatch over a lane holding the query twice: two maximal
    cells on different diagonals, the earlier diagonal kept; and a lane
    where one diagonal holds two maximal cells, the smaller i kept."""
    sc = make_scoring("match_mismatch")
    q = sc.query_indices("ACAC")
    dbm = np.array([[1, 1], [3, 2], [1, 1], [3, 2], [1, 31], [3, 31], [1, 31],
                    [3, 31]], np.int32)
    prof = swa_torch.make_profile(sc.table, q)
    got = _ends(swa_torch.sw_wavefront_ends, torch.from_numpy(prof),
                torch.from_numpy(dbm), sc.gap_open_total, sc.gap_extend)
    want = _ends(swa_xla.sw_wavefront_ends, prof, dbm, sc.gap_open_total, sc.gap_extend)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0][0] == 8 and (got[1][0], got[2][0]) == (4, 4)


@pytest.mark.parametrize("shape", [(0, 3), (5, 0)])
def test_wavefront_ends_empty(shape):
    lq, lb = shape
    prof = torch.zeros((lq, 32), dtype=torch.int32)
    best, bj, bi = swa_torch.sw_wavefront_ends(prof, torch.zeros((lb, 4), dtype=torch.int32),
                                               -3, -1)
    assert best.tolist() == bj.tolist() == bi.tolist() == [0] * 4


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _patch(monkeypatch, **consts):
    for mod in (tb, jax_tb):
        for k, v in consts.items():
            monkeypatch.setattr(mod, k, v)


PATHS = {
    "direct": {},
    "localized": {"_DIRECT_CELLS": 0},
    "myers_miller": {"_DIRECT_CELLS": 1 << 10, "MAX_CELLS": 1 << 12,
                     "_MM_BASE_CELLS": 1 << 8},
}


@pytest.mark.parametrize("native_lib", [True, False])
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("scoring", ["BLOSUM62", "PAM250", "match_mismatch", "go_eq_ge"])
def test_sw_traceback_matches_jax(scoring, path, native_lib, monkeypatch):
    sc = make_scoring(scoring)
    rng = np.random.default_rng(62)
    if not native_lib:
        monkeypatch.setattr(tb, "_load_native", lambda: None)
    else:
        assert tb.native_available()
    _patch(monkeypatch, **PATHS[path])
    for trial in range(4):
        q = sc.query_indices(random_protein(rng, int(rng.integers(20, 120))))
        d = random_records(rng, 1, 20, 300)[0]
        if trial == 3:  # the query inside the record: a long exact run
            d = np.concatenate([d[:30], q.astype(np.int8), d[30:]])
        got = tb.sw_traceback(q, d, sc.table, sc.gap_open, sc.gap_extend)
        want = jax_tb.sw_traceback(q, d, sc.table, sc.gap_open, sc.gap_extend)
        _same(got, want)


@pytest.mark.parametrize("native_lib", [True, False])
def test_sw_traceback_given_end_matches_jax(native_lib, monkeypatch):
    """The localized path from an end cell the wavefront ends engine
    found, as topk_alignments hands it over."""
    sc = make_scoring("BLOSUM45")
    if not native_lib:
        monkeypatch.setattr(tb, "_load_native", lambda: None)
    _patch(monkeypatch, _DIRECT_CELLS=0)
    rng = np.random.default_rng(63)
    q = sc.query_indices(random_protein(rng, 50))
    recs = random_records(rng, 5, 30, 200)
    dbm = np.full((200, 5), 31, np.int32)
    for k, s in enumerate(recs):
        dbm[: len(s), k] = s
    _, bj, bi = swa_torch.sw_wavefront_ends(
        torch.from_numpy(swa_torch.make_profile(sc.table, q)), torch.from_numpy(dbm),
        sc.gap_open_total, sc.gap_extend)
    for k, d in enumerate(recs):
        end = (int(bj[k]), int(bi[k]))
        got = tb.sw_traceback(q, d, sc.table, sc.gap_open, sc.gap_extend, end=end)
        want = jax_tb.sw_traceback(q, d, sc.table, sc.gap_open, sc.gap_extend, end=end)
        _same(got, want)


@pytest.mark.parametrize("pair", [("HEAGAWGHEE", "PAWHEAE"), ("MKVLAW", "mkvlaw"),
                                  ("ACDE", "WWWW"), ("", "ACD")])
def test_align_pair_matches_jax(pair, blosum62):
    _same(tb.align_pair(*pair, blosum62), jax_tb.align_pair(*pair, blosum62))


def _topk_db(rng, n=60):
    recs = random_records(rng, n, 5, 260)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(r) for r in recs], out=offsets[1:])
    return EncodedDatabase(seq=np.concatenate(recs), offsets=offsets,
                           names=[f"r{k}" for k in range(n)])


def _star_negative(name):
    """A scoring system whose '*' row and column score -4 (the builtin
    matrices score ('*', '*') +1, which leaves the ends to the host)."""
    sc = make_scoring(name)
    sc.table = sc.table.copy()
    sc.table[31, :] = sc.table[:, 31] = -4
    return sc


@pytest.mark.parametrize("engine_ends", [None, False])
@pytest.mark.parametrize("scoring", ["BLOSUM62", "random"])
def test_topk_alignments_matches_jax(scoring, engine_ends, monkeypatch):
    """The 8 best hits, every pair above the shrunk direct-fill threshold:
    with engine ends on, one call of the wavefront ends engine localizes
    them all, and the alignments equal the JAX package's (whose ends come
    from its XLA wavefront)."""
    sc = _star_negative(scoring)
    rng = np.random.default_rng(64)
    q = sc.query_indices(random_protein(rng, 40))
    db = _topk_db(rng)
    scores = np.array([jax_tb.sw_traceback(q, db.record(k), sc.table, sc.gap_open,
                                           sc.gap_extend).score for k in range(db.n)])
    _patch(monkeypatch, _DIRECT_CELLS=1 << 11)
    calls = swa_torch.sw_wavefront_ends.calls
    got = tb.topk_alignments(q, db, scores, 8, sc.table, sc.gap_open, sc.gap_extend,
                             engine_ends=engine_ends)
    assert swa_torch.sw_wavefront_ends.calls - calls == (engine_ends is None)
    want = jax_tb.topk_alignments(q, db, scores, 8, sc.table, sc.gap_open,
                                  sc.gap_extend, engine_ends=engine_ends)
    assert [r for r, _ in got] == [r for r, _ in want]
    for (_, a), (_, b) in zip(got, want):
        _same(a, b)
    assert [a.score for _, a in got] == sorted(scores, reverse=True)[:8]


def test_topk_engine_ends_unavailable_for_a_scoring_star():
    """A '*' column that could outscore real residues leaves the ends to
    the host, as in the JAX package; no engine call is made."""
    sc = make_scoring("BLOSUM62")  # ('*', '*') scores +1
    rng = np.random.default_rng(65)
    q = sc.query_indices(random_protein(rng, 30))
    db = _topk_db(rng, 10)
    scores = np.arange(db.n)
    calls = swa_torch.sw_wavefront_ends.calls
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, _DIRECT_CELLS=1 << 10)
        got = tb.topk_alignments(q, db, scores, 3, sc.table, sc.gap_open, sc.gap_extend)
        want = jax_tb.topk_alignments(q, db, scores, 3, sc.table, sc.gap_open,
                                      sc.gap_extend)
    assert swa_torch.sw_wavefront_ends.calls == calls
    for (_, a), (_, b) in zip(got, want):
        _same(a, b)


def test_topk_engine_failure_is_not_hidden(monkeypatch):
    """A failure of the ends engine reaches the caller (JAX's package
    swallows it and localizes on the host)."""
    sc = _star_negative("BLOSUM62")
    rng = np.random.default_rng(66)
    q = sc.query_indices(random_protein(rng, 40))
    db = _topk_db(rng, 10)

    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(swa_torch, "sw_wavefront_ends", boom)
    monkeypatch.setattr(tb, "_DIRECT_CELLS", 1 << 10)
    with pytest.raises(RuntimeError, match="device fault"):
        tb.topk_alignments(q, db, np.arange(db.n), 3, sc.table, sc.gap_open,
                           sc.gap_extend)

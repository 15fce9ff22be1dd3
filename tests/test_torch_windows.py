"""The port's fixed-batch kernel (K4), its constant-S timing mode (K5) and
the engine interface over them: the plain version and the CPU path of the
wrappers against the JAX package's ``sw_pallas_windows``,
``sw_pallas_multi`` and ``sw_pallas`` in interpret mode, bit for bit, on the
same numpy inputs."""

import functools

import numpy as np
import pytest
import torch

from seqalign_tpu.models import PAD_INDEX
from seqalign_tpu.ops.swa_pallas import sw_pallas, sw_pallas_multi, sw_pallas_windows
from seqalign_tpu_torch import pipeline
from seqalign_tpu_torch.convert import batch_windows, profile_to_torch
from seqalign_tpu_torch.host import lattice_round_up, pack_batch
from seqalign_tpu_torch.ops import swa_cuda
from seqalign_tpu_torch.ops.swa_cuda import (
    CONST_S, FIXED_WINDOW_LANES, MAX_QUERY_ROWS, STREAM_JB, sw_window, sw_windows,
    sw_windows_engine, sw_windows_reference,
)
from seqalign_tpu_torch.ops.swa_torch import make_profile

from _torch_cases import make_scoring, pack_db, random_records
from conftest import random_protein

WIN, JB = 128, 4  # one 128-lane TPU window (sl=1); the JAX kernel's j-block


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")


def _windows(rng, nw, lb, win=WIN, lo=1):
    """``(NW, lb, win)`` int32 windows of random records, '*'-padded, plus
    one empty lane in the first window."""
    recs = random_records(rng, nw * win, lo, lb + 1)
    recs[0] = np.zeros(0, np.int8)
    db = pack_db(recs, pad_to=lb)
    return np.ascontiguousarray(db.reshape(lb, nw, win).transpose(1, 0, 2))


def _jax_windows(profile, dbw, go, ge, const_s=False):
    return np.asarray(sw_pallas_windows(
        profile, dbw, go, ge, sl=1, nw=dbw.shape[0], jb=JB, ui=4,
        const_s=const_s, interpret=True,
    ))


def _port_windows(profile, dbw, go, ge, const_s=False):
    got = sw_windows_reference(
        profile_to_torch(profile, go, "cpu"), torch.from_numpy(dbw.astype(np.int8)),
        go, ge, const_s=const_s,
    )
    assert got.dtype == torch.int32
    return got.numpy()


def _queries(sc, rng, lengths):
    return [sc.query_indices(random_protein(rng, k)) for k in lengths]


@pytest.mark.parametrize("scoring,nw,lq,lb", [
    ("BLOSUM62", 1, 9, 16),
    ("PAM250", 2, 13, 32),
    ("match_mismatch", 3, 4, 16),
    ("go_eq_ge", 2, 1, 16),
])
def test_reference_matches_pallas_windows(scoring, nw, lq, lb):
    """One query against 1-3 windows, window-major lane order."""
    sc = make_scoring(scoring)
    rng = np.random.default_rng(lq * 10 + nw)
    prof = make_profile(sc.table, _queries(sc, rng, [lq])[0])
    dbw = _windows(rng, nw, lb)
    go, ge = sc.gap_open_total, sc.gap_extend
    want = _jax_windows(prof, dbw, go, ge)
    got = _port_windows(prof, dbw, go, ge)
    assert got.shape == (nw * WIN,) and got[0] == 0
    np.testing.assert_array_equal(got, want)


def test_reference_matches_pallas_windows_multi():
    """A 3-D profile of unequal lengths, an empty query among them."""
    sc = make_scoring("BLOSUM45")
    rng = np.random.default_rng(21)
    qs = _queries(sc, rng, [7, 0, 12, 3])
    prof = pipeline.multi_profile(sc.table, qs)
    dbw = _windows(rng, 2, 16)
    go, ge = sc.gap_open_total, sc.gap_extend
    want = _jax_windows(prof, dbw, go, ge)
    got = _port_windows(prof, dbw, go, ge)
    assert got.shape == (4, 2 * WIN) and not got[1].any()
    np.testing.assert_array_equal(got, want)
    # Each query's row equals its own 2-D run.
    for k, q in enumerate(qs):
        if len(q):
            np.testing.assert_array_equal(
                got[k], _port_windows(make_profile(sc.table, q), dbw, go, ge))


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("lq", [8, 6])
def test_const_s_matches_pallas_windows(lq, multi):
    """K5: S = 7 on every row the kernel runs, the rows padded to the row
    lattice included, so lq=6 scores as lq=8 (8 rows x (7 + go) = 32)."""
    sc = make_scoring("random")  # go = -3
    go, ge = sc.gap_open_total, sc.gap_extend
    rng = np.random.default_rng(30 + lq)
    qs = _queries(sc, rng, [lq, 3] if multi else [lq])
    prof = pipeline.multi_profile(sc.table, qs) if multi else make_profile(sc.table, qs[0])
    dbw = _windows(rng, 2, 16, lo=16)
    want = _jax_windows(prof, dbw, go, ge, const_s=True)
    got = _port_windows(prof, dbw, go, ge, const_s=True)
    np.testing.assert_array_equal(got, want)
    assert (got == 8 * (CONST_S + go)).all()
    # K4 on a constant unbiased profile of 7 + go counts only the real rows.
    flat = np.full((lq, 32), CONST_S + go, np.int32)
    assert (_port_windows(flat, dbw, go, ge) == lq * (CONST_S + go)).all()


def test_const_s_equals_k4_on_a_profile_of_sevens():
    """At lq a multiple of the row lattice, K5 is K4 on a biased profile of
    7s; its scores do not depend on the database's characters."""
    rng = np.random.default_rng(40)
    dbw = torch.from_numpy(_windows(rng, 2, 32).astype(np.int8))
    sevens = torch.full((12, 32), CONST_S, dtype=torch.int32)
    k5 = sw_windows_reference(torch.zeros_like(sevens), dbw, -3, -1, const_s=True)
    assert torch.equal(k5, sw_windows_reference(sevens, dbw, -3, -1))
    other = torch.from_numpy(_windows(rng, 2, 32).astype(np.int8))
    other[0, :, 0] = PAD_INDEX
    assert torch.equal(k5, sw_windows_reference(sevens, other, -3, -1, const_s=True))


def test_engine_matches_pallas_multi_on_a_numpy_batch():
    """An (Lb, B) batch with Lb not a multiple of 16: '*'-padded to 32 here,
    to JAX's jb there; two 1024-lane windows split on the host."""
    sc = make_scoring("PAM250")
    rng = np.random.default_rng(50)
    prof = make_profile(sc.table, _queries(sc, rng, [11])[0])
    db = pack_db(random_records(rng, 2 * FIXED_WINDOW_LANES - 5, 1, 22), pad_to=21)
    db = np.concatenate([db, np.full((21, 5), PAD_INDEX, np.int32)], axis=1)
    go, ge = sc.gap_open_total, sc.gap_extend
    want = np.asarray(sw_pallas_multi(prof, db, go, ge, interpret=True))
    got = sw_windows_engine(prof, db, go, ge)
    assert got.device.type == "cpu" and got.shape == (2 * FIXED_WINDOW_LANES,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_matches_pallas_multi_on_stacked_windows():
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(51)
    prof = make_profile(sc.table, _queries(sc, rng, [6])[0])
    dbw = _windows(rng, 1, 24, win=FIXED_WINDOW_LANES)
    go, ge = sc.gap_open_total, sc.gap_extend
    want = np.asarray(sw_pallas_multi(prof, dbw, go, ge, interpret=True))
    got = sw_windows_engine(torch.from_numpy(prof), torch.from_numpy(dbw), go, ge)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sw_window_matches_sw_pallas():
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(52)
    prof = make_profile(sc.table, _queries(sc, rng, [8])[0])
    db = _windows(rng, 1, 24, win=FIXED_WINDOW_LANES)[0]
    go, ge = sc.gap_open_total, sc.gap_extend
    want = np.asarray(sw_pallas(prof, db, go, ge, interpret=True))
    np.testing.assert_array_equal(sw_window(prof, db, go, ge).numpy(), want)


def test_sw_window_pads_where_sw_pallas_raises():
    """JAX's sw_pallas does not pad the window to the block size it picks:
    at Lb=20 it raises, while sw_pallas_multi scores the same batch. The
    port pads, and agrees with sw_pallas_multi."""
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(53)
    prof = make_profile(sc.table, _queries(sc, rng, [8])[0])
    db = _windows(rng, 1, 20, win=FIXED_WINDOW_LANES)[0]
    go, ge = sc.gap_open_total, sc.gap_extend
    with pytest.raises(ValueError, match="not a multiple of jb"):
        sw_pallas(prof, db, go, ge, interpret=True)
    want = np.asarray(sw_pallas_multi(prof, db, go, ge, interpret=True))
    np.testing.assert_array_equal(sw_window(prof, db, go, ge).numpy(), want)


def test_get_engine_windows_matches_wavefront():
    sc = make_scoring("random")
    rng = np.random.default_rng(54)
    prof = rng.integers(-6, 7, size=(13, 32)).astype(np.int32)
    prof[:, PAD_INDEX] = np.minimum(prof[:, PAD_INDEX], 0)  # '*' stays neutral
    db = torch.from_numpy(pack_db(random_records(rng, FIXED_WINDOW_LANES, 1, 30)))
    go, ge = sc.gap_open_total, sc.gap_extend
    got = pipeline.get_engine("windows")(torch.from_numpy(prof), db, go, ge)
    want = pipeline.get_engine("wavefront")(torch.from_numpy(prof), db, go, ge)
    assert torch.equal(got, want)


def test_windows_engine_over_sorted_lane_batches():
    """The slice as a whole: a length-sorted database cut into pack_batch
    lane batches padded to lattice_round_up, one engine call each, scores
    scattered back; against JAX's lane-batch engine (sw_pallas_multi) and
    the port's stream search."""
    sc = make_scoring("PAM250")
    rng = np.random.default_rng(55)
    q = _queries(sc, rng, [10])[0]
    db = pipeline._db_from_encoded(random_records(rng, 1500, 1, 40))
    prof = make_profile(sc.table, q)
    go, ge = sc.gap_open_total, sc.gap_extend
    engines = {
        "port": pipeline.get_engine("windows"),
        "jax": functools.partial(sw_pallas_multi, interpret=True),
    }
    order = np.argsort(-db.lengths, kind="stable")
    scores = {k: np.zeros(db.n, np.int32) for k in engines}
    batches = list(pipeline.lane_batches(db, order, FIXED_WINDOW_LANES))
    assert len(batches) == 2
    for ids, batch in batches:
        assert batch.shape == (lattice_round_up(int(db.lengths[ids].max())),
                               FIXED_WINDOW_LANES)
        np.testing.assert_array_equal(batch, pack_batch(db, ids, *batch.shape[::-1]))
        for k, fn in engines.items():
            scores[k][ids] = np.asarray(fn(prof, batch, go, ge))[: len(ids)]
    np.testing.assert_array_equal(scores["port"], scores["jax"])
    stream, _ = pipeline.search_database(q, db, sc, device="cpu")
    np.testing.assert_array_equal(scores["port"], stream)


@pytest.mark.parametrize("bad", ["3d_profile", "long_query", "ge_lt_go", "envelope", "lanes"])
def test_engine_refusals(bad):
    sc = make_scoring("BLOSUM62")
    prof = make_profile(sc.table, sc.query_indices("MKVLAW"))
    db = np.full((16, FIXED_WINDOW_LANES), PAD_INDEX, np.int8)
    go, ge = sc.gap_open_total, sc.gap_extend
    err, match = ValueError, "wavefront"
    if bad == "3d_profile":
        prof, match = prof[None], "sw_windows"
    elif bad == "long_query":
        prof, err = np.zeros((MAX_QUERY_ROWS + 1, 32), np.int32), NotImplementedError
    elif bad == "ge_lt_go":
        go, ge = -1, -3
    elif bad == "envelope":
        ge = 1  # a positive extend: E grows with the database
    else:
        db, match = db[:, :-128], "multiple of the window"
    with pytest.raises(err, match=match):
        sw_windows_engine(prof, db, go, ge)


@pytest.mark.parametrize("bad", ["rows", "length", "dtype", "ge_lt_go", "no_window", "profile_dims"])
def test_sw_windows_rejects_malformed_input(bad):
    prof = torch.zeros((4, 32), dtype=torch.int32)
    dbw = torch.full((1, STREAM_JB, WIN), PAD_INDEX, dtype=torch.int8)
    go, ge = -3, -1
    if bad == "rows":
        prof = prof[:3]
    elif bad == "length":
        dbw = dbw[:, :12].contiguous()
    elif bad == "dtype":
        dbw = dbw.to(torch.int32)
    elif bad == "ge_lt_go":
        go, ge = -1, -3
    elif bad == "no_window":
        dbw = dbw[:0]
    else:
        prof = prof[None, None]
    with pytest.raises(ValueError):
        sw_windows(prof, dbw, go, ge)


def test_cpu_wrapper_takes_the_plain_version():
    rng = np.random.default_rng(60)
    sc = make_scoring("BLOSUM62")
    prof = profile_to_torch(make_profile(sc.table, sc.query_indices("MKVLA")),
                            sc.gap_open_total, "cpu")
    dbw = torch.from_numpy(_windows(rng, 2, 16).astype(np.int8))
    go, ge = sc.gap_open_total, sc.gap_extend
    k4, k5 = sw_windows.launches, sw_windows.launches_const_s
    calls = sw_windows_reference.calls
    for const_s in (False, True):
        got = sw_windows(prof, dbw, go, ge, const_s=const_s)
        assert torch.equal(got, sw_windows_reference(prof, dbw, go, ge, const_s=const_s))
    sw_windows_engine(prof, dbw, go, ge)  # a tensor profile, stacked windows
    assert (sw_windows.launches, sw_windows.launches_const_s) == (k4, k5)
    assert sw_windows_reference.calls == calls + 5


@pytest.mark.parametrize("kind", ["numpy", "tensor", "stacked"])
def test_batch_windows_splits_and_pads(kind):
    rng = np.random.default_rng(61)
    batch = rng.integers(0, 20, size=(21, 3 * WIN)).astype(np.int32)
    want = np.full((3, 32, WIN), PAD_INDEX, np.int8)
    want[:, :21] = batch.reshape(21, 3, WIN).transpose(1, 0, 2)
    arg = {"numpy": batch, "tensor": torch.from_numpy(batch),
           "stacked": np.ascontiguousarray(want[:, :21])}[kind]
    got = batch_windows(arg, WIN, STREAM_JB, "cpu")
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    empty = batch_windows(np.zeros((0, WIN), np.int8), WIN, STREAM_JB, "cpu")
    assert tuple(empty.shape) == (1, STREAM_JB, WIN) and (empty == PAD_INDEX).all()


@pytest.mark.parametrize("platform", ["cpu", "unset_without_gpu"])
def test_engine_puts_a_numpy_batch_on_the_platform_device(platform, monkeypatch):
    """A numpy batch runs on ``SEQALIGN_PLATFORM``'s device; unset, that is
    the card, and without one the engine raises instead of running on the
    CPU."""
    sc = make_scoring("BLOSUM62")
    prof = make_profile(sc.table, sc.query_indices("MKVLAW"))
    db = np.full((16, FIXED_WINDOW_LANES), PAD_INDEX, np.int8)
    if platform == "cpu":
        got = sw_windows_engine(prof, db, sc.gap_open_total, sc.gap_extend)
        assert got.device.type == "cpu" and tuple(got.shape) == (FIXED_WINDOW_LANES,)
        return
    monkeypatch.delenv("SEQALIGN_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sw_windows_engine(prof, db, sc.gap_open_total, sc.gap_extend)


def test_search_routes_offer_no_windows_engine():
    """K4 is reached through get_engine alone, as in the JAX package."""
    assert "windows" not in pipeline.ENGINES
    assert swa_cuda.sw_windows_engine is pipeline.get_engine("windows")


# --- The team design (K4 and K5 on K1's team kernel) -----------------------

from seqalign_tpu_torch import sass  # noqa: E402
from seqalign_tpu_torch.ops.oracle import sw_score_batch  # noqa: E402
from seqalign_tpu_torch.ops.swa_cuda import (  # noqa: E402
    FILL_SHARE, H100_SMS, STREAM_TEAMS, WINDOWS_ROWS_PER_THREAD_BUILT,
    WINDOWS_SOLO_ROWS, lane_ends, team_threads,
    warp_ends, windows_cells, windows_kernel_instance, windows_team,
)

FIXED_B = (4096, 16384, 67584)  # swissprot.FIXED_LANES


def _fills(t, r, lanes):
    return lanes * t >= FILL_SHARE * H100_SMS * team_threads(r)


@pytest.mark.parametrize("lanes", [1, 256, 1024, *FIXED_B, 4 * 67584])
@pytest.mark.parametrize("rows", [0, 4, 20, 144, 512, 1000, MAX_QUERY_ROWS])
def test_windows_team_holds_the_rows_and_fills_where_the_lanes_allow(rows, lanes):
    """A built (T, R) that holds the rows; where some built team's grid
    fills the card the chosen one does, with the fewest padded rows of
    those; where none does, the fewest rows a thread (those of the largest
    team) with the fewest padded rows."""
    t, r = windows_team(rows, lanes)
    assert t in STREAM_TEAMS and r in WINDOWS_ROWS_PER_THREAD_BUILT and t * r >= rows
    fits = [(tt, rr) for tt in STREAM_TEAMS for rr in WINDOWS_ROWS_PER_THREAD_BUILT
            if tt * rr >= rows]
    full = [(tt, rr) for tt, rr in fits if _fills(tt, rr, lanes)]
    if full:
        assert _fills(t, r, lanes)
        assert t * r == min(tt * rr for tt, rr in full)
    else:
        largest = max(tt for tt, _ in fits)
        assert r == min(rr for tt, rr in fits if tt == largest)
        assert t * r == min(tt * rr for tt, rr in fits if rr == r)


# The fastest team measured on an H100 at each width and query length
# (PERF.md: swissprot --fixed --teams, the team sweep).
MEASURED_FASTEST = {
    (4096, 17): (16, 10), (4096, 144): (16, 10), (4096, 512): (16, 32),
    (4096, 1536): (32, 48), (16384, 17): (4, 10), (16384, 144): (4, 36),
    (16384, 512): (16, 32), (67584, 17): (1, 20), (67584, 144): (4, 36),
    (67584, 512): (16, 32),
}


@pytest.mark.parametrize("lanes,lq", sorted(MEASURED_FASTEST))
def test_windows_team_takes_the_measured_fastest(lanes, lq):
    rows = -(-lq // 4) * 4
    assert windows_team(rows, lanes) == MEASURED_FASTEST[lanes, lq]


def test_windows_team_at_full_width_is_k1s_team():
    """A wide batch fills the card with K1's own team at every length."""
    for rows in (20, 144, 512, 1536):
        assert windows_team(rows, 67584) == swa_cuda.stream_team(rows)


@pytest.mark.parametrize("const_s", [False, True])
@pytest.mark.parametrize("team", [(1, 20), (1, 28), (4, 36), (16, 10)])
def test_windows_kernel_instance_names_the_sass_key(team, const_s):
    t, r = team
    solo = t == 1 and r in WINDOWS_SOLO_ROWS
    mangled = (f"_ZN12_GLOBAL__N_117sw_windows_kernelILi{r}ELb{int(solo)}ELb{int(const_s)}"
               "EEEvPKiPKaPiiiiiiiii")
    key = windows_kernel_instance(r * t, 4096, const_s, team)
    assert sass.kernel_key(mangled) == key
    assert key.startswith(sass.TEAM_KERNELS)
    assert sass.expected_cells(key) == 2 * r * (sass.SOLO_WINDOWS_STEPS if solo else 1)
    assert windows_kernel_instance(144, 67584) == "sw_windows_kernel<36, false, false>"


def test_sw_windows_team_argument():
    """``team=`` forces a (T, R) that holds the rows; the CPU path scores
    with the plain version whatever the team."""
    rng = np.random.default_rng(80)
    prof = profile_to_torch(rng.integers(-4, 5, size=(20, 32)), -3, "cpu")
    dbw = torch.from_numpy(_windows(rng, 1, 16).astype(np.int8))
    want = sw_windows_reference(prof, dbw, -3, -1)
    assert torch.equal(sw_windows(prof, dbw, -3, -1, team=(2, 10)), want)
    for bad in [(1, 10), (3, 10), (2, 11)]:
        with pytest.raises(ValueError, match="team"):
            sw_windows(prof, dbw, -3, -1, team=bad)


@pytest.mark.parametrize("const_s", [False, True])
@pytest.mark.parametrize("go,ge", [(-3, 1), (1, 2), (0, 1), (-3, -1)])
def test_kernel_path_refuses_a_positive_gap_extend(go, ge, const_s):
    """Off the CPU, ``sw_windows`` refuses ``ge > 0`` (and so ``go > 0``)
    before any launch: each of a team's rows past the query's would add
    ``ge`` to K4's best. Meta tensors reach that path without a card; a
    scoring with ``ge <= 0`` passes it and meets the device check."""
    rng = np.random.default_rng(85)
    prof = profile_to_torch(rng.integers(-4, 5, size=(20, 32)), go, "meta")
    dbw = torch.zeros((1, 16, 32), dtype=torch.int8, device="meta")
    match = "ge <= 0" if ge > 0 else "no fixed-batch kernel for device meta"
    with pytest.raises(ValueError, match=match):
        sw_windows(prof, dbw, go, ge, const_s=const_s)


def test_windows_cells_and_ends():
    """Lane ends, warp ends and the cells a launch runs, on a hand-made
    batch: two windows of 40 lanes, warps of 8 lanes at T = 4."""
    db = torch.full((2, 32, 40), PAD_INDEX, dtype=torch.int8)
    db[0, :5, 0] = 3
    db[0, :20, 3] = 2
    db[0, 19, 3] = PAD_INDEX  # a record ending in '*': its end is 19
    db[1, :7, 39] = 1
    db[1, 10, 5] = 0
    ends = lane_ends(db)
    assert ends[0, 0] == 5 and ends[0, 3] == 19 and ends[1, 5] == 11 and ends[1, 39] == 7
    assert int(ends.sum()) == 5 + 19 + 11 + 7
    w = warp_ends(db, (4, 36))
    assert (w[0, :8] == 20).all() and (w[0, 8:] == 0).all()
    assert (w[1, :8] == 12).all() and (w[1, 32:] == 8).all()
    cells = windows_cells(db, 4, (4, 36))
    assert cells == {"real": 4 * 42, "run": 4 * (8 * 20 + 8 * 12 + 8 * 8),
                     "batch": 4 * 2 * 32 * 40}
    # Solo teams: warps of 32 lanes (the second warp of a window holds 8).
    assert windows_cells(db, 4, (1, 20))["run"] == 4 * (32 * 20 + 32 * 12 + 8 * 8)
    assert windows_cells(db, 4, (4, 36), skip=False)["run"] == 4 * 2 * 32 * 40


def _star_clamped_random():
    rng = np.random.default_rng(81)
    t = rng.integers(-6, 7, size=(32, 32)).astype(np.int32)
    t = np.triu(t) + np.triu(t, 1).T
    t[:, PAD_INDEX] = t[PAD_INDEX, :] = np.minimum(t[:, PAD_INDEX], 0)
    sc = make_scoring("random")
    sc.table = t
    return sc


def _ragged_records(rng, n, hi, stars):
    """Random records of 1..hi residues; with ``stars``, '*' inside some and
    at the end of others, and a few empty ones."""
    recs = random_records(rng, n, 1, hi + 1)
    if stars:
        for k, rec in enumerate(recs):
            if len(rec) > 2 and k % 3 == 0:
                rec[rng.integers(0, len(rec) - 1)] = PAD_INDEX
            if k % 5 == 1:
                rec[-1] = PAD_INDEX
        for k in rng.choice(n, 3, replace=False):
            recs[k] = np.zeros(0, np.int8)
    return recs


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("scoring", ["BLOSUM45", "BLOSUM62", "PAM250", "match_mismatch",
                                     "random_star_clamped"])
def test_tail_skip_is_exact_where_star_scores_are_not_positive(scoring, sort):
    """The argument behind K4's skip, on the plain version: a query without
    '*' (every '*' score at most 0, gaps at most 0) gets the same best from
    a padded batch as from each record alone at its own length (the NumPy
    oracle), so a warp may stop at its lanes' last residue."""
    sc = _star_clamped_random() if scoring == "random_star_clamped" else make_scoring(scoring)
    rng = np.random.default_rng(82 + sort)
    q = sc.query_indices(random_protein(rng, 10))
    assert sc.padding_safe_for_query(q)
    recs = _ragged_records(rng, 2 * WIN, 40, stars=True)
    if sort:
        recs.sort(key=len, reverse=True)
    go, ge = sc.gap_open_total, sc.gap_extend
    prof = profile_to_torch(make_profile(sc.table, q), go, "cpu")
    dbw = batch_windows(pack_db(recs, pad_to=48), WIN, STREAM_JB, "cpu")
    full = sw_windows_reference(prof, dbw, go, ge)
    alone = sw_score_batch(q, recs, sc.table, sc.gap_open, sc.gap_extend)
    np.testing.assert_array_equal(full.numpy(), alone)


def test_tail_skip_changes_a_best_for_a_query_holding_star():
    """BLOSUM62 scores ('*', '*') +1: a query ending in '*' gains from the
    padding after a record that matches its prefix, so the padded batch
    (the kernel runs it to its length) and the records alone differ."""
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(83)
    q = np.concatenate([sc.query_indices(random_protein(rng, 9)), [PAD_INDEX]])
    assert not sc.padding_safe_for_query(q)
    recs = _ragged_records(rng, WIN, 30, stars=False)
    recs[7] = q[:9].astype(np.int8)  # the query's prefix, then padding
    go, ge = sc.gap_open_total, sc.gap_extend
    prof = profile_to_torch(make_profile(sc.table, q), go, "cpu")
    dbw = batch_windows(pack_db(recs, pad_to=32), WIN, STREAM_JB, "cpu")
    full = sw_windows_reference(prof, dbw, go, ge).numpy()
    alone = sw_score_batch(q, recs, sc.table, sc.gap_open, sc.gap_extend)
    assert full[7] == alone[7] + 1
    assert (full >= alone).all()


def test_tail_skip_three_d_profile_with_star_in_one_query():
    """A 3-D profile whose second query holds '*': the other queries'
    bests from the padded batch equal their records' alone, so their warps
    may stop at their ends."""
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(84)
    qs = _queries(sc, rng, [7, 12, 5])
    qs[1] = np.concatenate([qs[1], [PAD_INDEX]])
    go, ge = sc.gap_open_total, sc.gap_extend
    prof = profile_to_torch(pipeline.multi_profile(sc.table, qs), go, "cpu")
    recs = _ragged_records(rng, WIN, 30, stars=True)
    dbw = batch_windows(pack_db(recs, pad_to=32), WIN, STREAM_JB, "cpu")
    full = sw_windows_reference(prof, dbw, go, ge)
    for k in (0, 2):
        alone = sw_score_batch(qs[k], recs, sc.table, sc.gap_open, sc.gap_extend)
        np.testing.assert_array_equal(full[k].numpy(), alone)


def test_sass_report_of_another_checkout_keeps_its_old_fixed_batch_kernel(monkeypatch):
    """``sass --against`` an older checkout: its K5 instance, keyed without
    R, has a loop this module cannot count; the other checkout's report
    names no loop for it instead of failing, and this checkout's is
    strict."""
    from pathlib import Path

    text = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_117sw_windows_kernelILb0ELb1EEEvPKi",
        "        /*0000*/                   S2R R0, SR_TID.X ;",
        "        /*0010*/                   VIADDMNMX R5, R5, R3, R4, !PT ;",
        "        /*0020*/               @P0 BRA 0x10 ;",
    ])
    funcs = sass.sass_functions(None, text)
    monkeypatch.setattr(sass, "sass_functions", lambda lib, text=None: funcs)
    got = sass.report(Path("lib.so"), "", strict=False)
    assert got["sw_windows_kernel<false, true>"]["inner_loop"] is None
    with pytest.raises(ValueError, match="no team kernel instance"):
        sass.report(Path("lib.so"), "")

"""The host side of the alignment step's passes on the card
(``ops.traceback._run_on_card``, ``ops.traceback_cuda``), on the CPU: the
launches' workspace, and the passes each launch takes, with the kernel
replaced by the native host functions (:func:`native_run`) over the same
workspace bytes. Every hit's alignment equals the per-pair
``sw_traceback``'s, through the direct, localized and transposed routes,
and each launch takes the passes the per-pair route makes, in turn: the
forward ends of every localized hit, their reverse passes, then every
fill. The card's own run is ``tests/test_torch_traceback_cuda.py``.

The file imports neither JAX nor the JAX package.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from seqalign_tpu_torch import pipeline
from seqalign_tpu_torch.host import ScoringModel, encode, load_builtin
from seqalign_tpu_torch.ops import traceback as tb
from seqalign_tpu_torch.ops import traceback_cuda as tbc

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"


def scoring(name):
    gaps = {"BLOSUM62": (-11, -1), "PAM250": (-2, -1)}[name]
    return load_builtin(name, ScoringModel(gap_open=gaps[0], gap_extend=gaps[1],
                                           use_match_mismatch=False))


def protein(rng, n):
    return encode("".join(AMINO_ACIDS[i] for i in rng.integers(0, 20, n)))


def homolog(rng, q, n):
    """``q`` with a fifth of its residues redrawn, a few cut out and a few
    put in, flanked or cut to ``n``."""
    h = q.copy()
    redraw = rng.random(len(h)) < 0.2
    h[redraw] = protein(rng, int(redraw.sum()))
    for _ in range(3):
        at = int(rng.integers(1, len(h) - 1))
        h = np.concatenate([h[:at], protein(rng, int(rng.integers(1, 6))), h[at + 3:]])
    h = h[:n]
    left = int(rng.integers(n - len(h) + 1))
    return np.concatenate([protein(rng, left), h, protein(rng, n - len(h) - left)])


def native_run(launch, prepared, go, ge):
    """``traceback_cuda.run``'s contract on the host: each pair of the
    workspace's head (its descriptor, sequences and table, as the kernel
    reads them) through ``sw_tb_ends`` or ``sw_tb_fill``, its best and
    states written where the kernel writes them in the download."""
    lib = tb._load_native()
    head, n = launch.head, len(launch.passes)
    rows = head[: 8 * len(tbc.PAIR_FIELDS) * n].view(np.int64).reshape(n, -1)
    down = np.zeros(launch.total - launch.out_off, np.uint8)
    for k, (qo, do, so, _, _, lq, lb, pitch, flip) in enumerate(rows.tolist()):
        q = np.ascontiguousarray(head[qo: qo + lq]).view(np.int8)
        d = np.ascontiguousarray(head[do: do + lb]).view(np.int8)
        t0 = launch.tables_off + 1024 * flip
        t = np.ascontiguousarray(head[t0: t0 + 1024]).view(np.int8)
        bj, bi = ctypes.c_int64(), ctypes.c_int64()
        if launch.states:
            st = np.zeros((lb + 1, lq + 1), np.uint8)
            best = lib.sw_tb_fill(q.ctypes.data, lq, d.ctypes.data, lb, t.ctypes.data, go, ge,
                                  st.ctypes.data, ctypes.byref(bj), ctypes.byref(bi))
            base = so - launch.out_off + 15
            for j in range(lb + 1):
                down[base + j * pitch: base + j * pitch + lq + 1] = st[j]
        else:
            best = lib.sw_tb_ends(q.ctypes.data, lq, d.ctypes.data, lb, t.ctypes.data, go, ge,
                                  ctypes.byref(bj), ctypes.byref(bi))
        down[12 * k: 12 * k + 12] = np.array([best, bj.value, bi.value], np.int32).view(np.uint8)
    native_run.passes.append([(p.states, bytes(np.asarray(p.q, np.int8)),
                               bytes(np.asarray(p.d, np.int8)), p.flip) for p in launch.passes])
    return launch.views(down)


native_run.passes = []


@pytest.fixture
def on_card(monkeypatch):
    """``topk_alignments`` down its card route on the CPU, the kernel's run
    replaced by :func:`native_run`; the passes of each launch."""
    native_run.passes = []
    monkeypatch.setattr(tb, "_card", lambda device: torch.device("cpu"))
    monkeypatch.setattr(tbc, "prepare", lambda launch, device: None)
    monkeypatch.setattr(tbc, "run", native_run)
    return native_run.passes


def host_passes(monkeypatch):
    """The passes the per-pair host route makes, one list a pair."""
    made, run = [], tb._run_on_host

    def spy(steps, table, gap_open, gap_extend):
        made.append([])
        real = tb._host_pass

        def one(p, table, go, ge):
            made[-1].append((p.states, bytes(np.asarray(p.q, np.int8)),
                             bytes(np.asarray(p.d, np.int8)), p.flip))
            return real(p, table, go, ge)

        monkeypatch.setattr(tb, "_host_pass", one)
        try:
            return run(steps, table, gap_open, gap_extend)
        finally:
            monkeypatch.setattr(tb, "_host_pass", real)

    monkeypatch.setattr(tb, "_run_on_host", spy)
    return made


def case(rng, lq=120):
    """A query, its homologs of 40-300 residues (either side the longer),
    itself, and random records."""
    query = protein(rng, lq)
    records = [homolog(rng, query, n) for n in (40, 90, 150, 210, 300)] + [query.copy()]
    records += [protein(rng, int(n)) for n in rng.integers(1, 260, 30)]
    return query, pipeline._db_from_encoded(records)


@pytest.mark.parametrize("name", ["BLOSUM62", "PAM250"])
@pytest.mark.parametrize("direct", [1 << 22, 121 * 91], ids=["direct", "localized"])
def test_card_route_takes_the_host_routes_passes(name, direct, monkeypatch, on_card):
    sc = scoring(name)
    monkeypatch.setattr(tb, "_DIRECT_CELLS", direct)
    query, db = case(np.random.default_rng(81))
    scores, _ = pipeline.search_database(query, db, sc, device="cpu")
    k = 12
    got = tb.topk_alignments(query, db, scores, k, sc.table, sc.gap_open, sc.gap_extend)
    made = host_passes(monkeypatch)
    want = tb.topk_alignments(query, db, scores, k, sc.table, sc.gap_open, sc.gap_extend,
                              engine_ends=False)
    assert [r for r, _ in got] == [r for r, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert len(made) == k
    # Launch by launch: the first pass of every localized hit, then its
    # second, then every hit's fill, each in the hits' order.
    localized = [m for m in made if len(m) == 3]
    want_launches = [[m[0] for m in localized], [m[1] for m in localized],
                     [m[-1] for m in made]]
    want_launches = [w for w in want_launches if w]
    assert on_card == want_launches
    assert [len(m) for m in made].count(1) == k - len(localized)
    if direct < 1 << 22:
        assert 0 < len(localized) < k
        assert {m[0][3] for m in localized} == {False, True}  # both orientations
    assert any(a.cigar.strip("0123456789M") for _, a in got)  # gaps in some hit


def test_card_route_keeps_what_the_kernel_cannot_take_on_the_host(monkeypatch, on_card):
    """A table outside int8 runs every pass on the host (NumPy), counted
    as ``cells_host``; the alignments are the host route's."""
    sc = scoring("BLOSUM62")
    table = sc.table.astype(np.int32) * 40
    rng = np.random.default_rng(82)
    query, db = case(rng, 60)
    scores = np.arange(db.n)
    got = tb.topk_alignments(query, db, scores, 4, table, sc.gap_open, sc.gap_extend)
    want = tb.topk_alignments(query, db, scores, 4, table, sc.gap_open, sc.gap_extend,
                              engine_ends=False)
    assert [dataclasses.asdict(a) for _, a in got] == [dataclasses.asdict(a) for _, a in want]
    assert on_card == []


@pytest.mark.parametrize("ok,change", [
    (True, {}),
    (False, {"table": 128}),
    (False, {"ge": 1}),
    (False, {"go": 1}),
    (False, {"q": 0}),
    (False, {"d": 0}),
    (False, {"score": True}),
])
def test_fits(ok, change):
    t = scoring("BLOSUM62").table.copy()
    if "table" in change:
        t[3, 4] = change["table"]
    q = np.zeros(change.get("q", 50), np.int8)
    d = np.zeros(change.get("d", 70), np.int8)
    if change.get("score"):
        t[0, 0] = 127
        q = d = np.zeros(tbc.SCORE_LIMIT // 127 + 1, np.int8)
    p = tbc.Pass(True, q, d, False)
    assert tbc.fits(p, t, change.get("go", -12), change.get("ge", -1)) is ok


@pytest.mark.parametrize("states", [False, True])
def test_plan_lays_out_the_workspace(states):
    rng = np.random.default_rng(83)
    shapes = [(1, 1), (31, 33), (33, 31), (512, 7), (513, 40), (9000, 3)]
    passes = [tbc.Pass(states, protein(rng, a), protein(rng, b), bool(k % 2))
              for k, (a, b) in enumerate(shapes)]
    table = scoring("PAM250").table
    launch = tbc.plan(passes, table, states)
    n = len(passes)
    rows = launch.head[: 72 * n].view(np.int64).reshape(n, 9)
    stripes = [-(-a // tbc.STRIPE) for a, _ in shapes]
    assert launch.warps == min(tbc.MAX_WARPS, max(stripes)) == 16
    t = launch.head[launch.tables_off: launch.tables_off + 2048].view(np.int8).reshape(2, 32, 32)
    np.testing.assert_array_equal(t[0], table)
    np.testing.assert_array_equal(t[1], table.T)
    regions = []
    for k, ((qo, do, so, bo, fo, lq, lb, pitch, flip), p) in enumerate(zip(rows, passes)):
        assert (lq, lb, flip) == (len(p.q), len(p.d), int(p.flip))
        assert bytes(launch.head[qo: qo + lq]) == bytes(p.q.astype(np.uint8))
        assert bytes(launch.head[do: do + lb]) == bytes(p.d.astype(np.uint8))
        regions += [(qo, lq), (do, lb), (fo, 4 * stripes[k]), (bo, 12 * lb * (stripes[k] - 1))]
        assert qo % 16 == do % 16 == bo % 16 == 0
        assert launch.flags_off <= fo < launch.flags_off + launch.flags_bytes
        if states:
            assert pitch == 16 + -(-lq // 16) * 16 and so % 16 == 0
            assert so - launch.out_off == launch.states_off[k]
            regions.append((so, (lb + 1) * pitch))
        else:
            assert so == pitch == 0
    regions.append((launch.out_off, 12 * n))
    regions.sort()
    for (a, na), (b, _) in zip(regions, regions[1:]):
        assert a + na <= b  # no two overlap
    assert regions[-1][0] + regions[-1][1] <= launch.total
    assert launch.flags_bytes == 4 * sum(stripes)
    assert len(launch.head) <= launch.flags_off
    down = np.arange(launch.total - launch.out_off, dtype=np.int64).astype(np.uint8)
    views = launch.views(down)
    if states:
        for k, (st, _, _) in enumerate(views):
            lq, lb, pitch = rows[k, 5], rows[k, 6], rows[k, 7]
            assert st.shape == (lb + 1, lq + 1)
            at = launch.states_off[k] + 15 + lb * pitch + lq
            assert st[lb, lq] == down[at]


def test_batches_split_the_states_at_the_cap(monkeypatch):
    monkeypatch.setattr(tbc, "MAX_STATES_BYTES", 5_000)
    passes = [tbc.Pass(True, np.zeros(a, np.int8), np.zeros(b, np.int8), False)
              for a, b in [(40, 50), (40, 60), (100, 100), (10, 10), (10, 10)]]
    sizes = [(b + 1) * (16 + -(-a // 16) * 16) for a, b in [(40, 50), (40, 60), (100, 100),
                                                            (10, 10), (10, 10)]]
    assert sizes[0] + sizes[1] > 5_000 > sizes[0] and sizes[2] > 5_000
    groups = tbc.batches(passes, True)
    assert [len(g) for g in groups] == [1, 1, 1, 2]  # one pair past the cap alone
    assert [p for g in groups for p in g] == passes
    assert tbc.batches(passes, False) == [passes]
    assert tbc.batches([], True) == tbc.batches([], False) == []

"""The alignment step's passes on the card (``csrc/tb_fill.cu`` through
``ops.traceback_cuda``) against the native host functions they replace,
``sw_tb_ends`` and ``sw_tb_fill``: the same best score, end cell and state
bytes, on seeded pairs under BLOSUM62 11/1 and PAM250 2/1; and
``topk_alignments`` on ``cuda`` against its host route
(``engine_ends=False``), hit for hit.

Needs an NVIDIA GPU; on the card:
``python -m pytest tests/test_torch_traceback_cuda.py -m cuda --noconftest``.
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
GAPS = {"BLOSUM62": (-11, -1), "PAM250": (-2, -1)}
# (lq, lb): lengths 1, 31, 32, 33 (a warp's rows and one past), either side
# the longer, pairs over several stripes, one over more stripes than a CTA
# has warps (9,000 rows: 18 stripes of 512), and the longest query of the
# CUDASW++ set against a 3,222-residue record.
SHAPES = [(1, 1), (1, 31), (31, 1), (31, 32), (32, 31), (32, 33), (33, 32), (33, 33),
          (1, 300), (300, 1), (144, 513), (513, 144), (1025, 700), (700, 1025),
          (9000, 60), (5478, 3222), (3222, 5478)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA traceback kernel)")
    return torch.device("cuda")


def scoring(name):
    go, ge = GAPS[name]
    return load_builtin(name, ScoringModel(gap_open=go, gap_extend=ge,
                                           use_match_mismatch=False))


def protein(rng, n):
    return encode("".join(AMINO_ACIDS[i] for i in rng.integers(0, 20, n)))


def related(rng, q, n):
    """``n`` residues of ``q`` with a fifth redrawn and a few cut out or
    put in (random residues past ``q``'s end)."""
    h = q.copy()
    redraw = rng.random(len(h)) < 0.2
    h[redraw] = protein(rng, int(redraw.sum()))
    for _ in range(min(4, len(h) // 8)):
        at = int(rng.integers(1, len(h) - 1))
        h = np.concatenate([h[:at], protein(rng, int(rng.integers(1, 6))), h[at + 3:]])
    return np.concatenate([h, protein(rng, max(0, n - len(h)))])[:n]


def pairs(rng):
    out = [(protein(rng, a), protein(rng, b)) for a, b in SHAPES]
    out += [(q, related(rng, q, b)) for q, b in
            ((protein(rng, a), b) for a, b in SHAPES if min(a, b) > 8)]
    motif = protein(rng, 7)
    out.append((np.tile(motif, 40), np.tile(motif, 30)))  # many equal maxima
    return out


def native(p, table, go, ge):
    lib = tb._load_native()
    t = np.ascontiguousarray(table.T if p.flip else table, dtype=np.int8)
    q = np.ascontiguousarray(p.q, dtype=np.int8)
    d = np.ascontiguousarray(p.d, dtype=np.int8)
    bj, bi = ctypes.c_int64(), ctypes.c_int64()
    if p.states:
        st = np.zeros((len(d) + 1, len(q) + 1), np.uint8)
        best = lib.sw_tb_fill(q.ctypes.data, len(q), d.ctypes.data, len(d), t.ctypes.data,
                              go, ge, st.ctypes.data, ctypes.byref(bj), ctypes.byref(bi))
        return st, best, (bj.value, bi.value)
    best = lib.sw_tb_ends(q.ctypes.data, len(q), d.ctypes.data, len(d), t.ctypes.data,
                          go, ge, ctypes.byref(bj), ctypes.byref(bi))
    return best, (bj.value, bi.value)


def on_card(passes, table, go, ge, device):
    launch = tbc.plan(passes, table, passes[0].states)
    launches = tbc.run.launches
    found = tbc.run(launch, tbc.prepare(launch, device), go, ge)
    assert tbc.run.launches == launches + 1
    return found


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GAPS))
def test_kernel_matches_the_native_passes(name, card):
    sc = scoring(name)
    go, ge = sc.gap_open + sc.gap_extend, sc.gap_extend
    rng = np.random.default_rng(91 if name == "BLOSUM62" else 92)
    made = pairs(rng)
    for states in (False, True):
        passes = [tbc.Pass(states, q, d, bool(k % 3 == 1)) for k, (q, d) in enumerate(made)]
        assert all(tbc.fits(p, sc.table, go, ge) for p in passes)
        got = on_card(passes, sc.table, go, ge, card)
        for p, g in zip(passes, got):
            want = native(p, sc.table, go, ge)
            what = (name, states, len(p.q), len(p.d), p.flip)
            if not states:
                assert g == want, what
                continue
            assert g[1:] == want[1:], what
            # Row 0 and column 0 are never written, nor read by the walk.
            np.testing.assert_array_equal(g[0][1:, 1:], want[0][1:, 1:], err_msg=str(what))
    # The score of every related pair is a real alignment's, far from 0.
    assert max(g[1] for g in got) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["direct", "localized", "split"])
@pytest.mark.parametrize("name", sorted(GAPS))
def test_topk_alignments_on_the_card_equal_the_host_route(name, route, card, monkeypatch):
    """Every hit bit for bit: the top 10 of a query of 600 against its
    related records (either side the longer) and random ones. ``localized``
    shrinks the direct-fill threshold so that most hits are localized (three
    launches); ``split`` also caps a launch's states, so the fill takes
    several launches."""
    sc = scoring(name)
    rng = np.random.default_rng(93)
    query = protein(rng, 600)
    records = [related(rng, query, n) for n in (200, 450, 600, 800, 1500)] + [query.copy()]
    records += [protein(rng, int(n)) for n in rng.integers(1, 900, 60)]
    db = pipeline._db_from_encoded(records)
    scores, _ = pipeline.search_database(query, db, sc, device="cuda")
    if route != "direct":
        monkeypatch.setattr(tb, "_DIRECT_CELLS", 601 * 301)
    if route == "split":
        monkeypatch.setattr(tbc, "MAX_STATES_BYTES", 1 << 19)
    launches = tbc.run.launches
    got = tb.topk_alignments(query, db, scores, 10, sc.table, sc.gap_open, sc.gap_extend,
                             device=card)
    n = tbc.run.launches - launches
    want = tb.topk_alignments(query, db, scores, 10, sc.table, sc.gap_open, sc.gap_extend,
                              engine_ends=False)
    assert [r for r, _ in got] == [r for r, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert any(set(a.cigar) & {"I", "D"} for _, a in got)
    assert n == {"direct": 1, "localized": 3}.get(route, n)
    if route == "split":
        assert n > 3

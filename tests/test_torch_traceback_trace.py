"""The alignment step's spans (``ops.traceback.topk_alignments`` under
``torch.profiler``), on a database of a few hundred records under BLOSUM62
11/1: one ``seqalign.align`` root a call with the top-k choice, the ends,
the fills and the walks inside it, and the cells each counts, worked out
from the pairs' shapes and the alignments' spans. On a CUDA device the
passes run on the card and count ``cells_device``: that route is run here
with the kernel replaced by the native host functions.

The file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
from seqalign_tpu_torch import pipeline, trace
from seqalign_tpu_torch.host import ScoringModel, encode, load_builtin
from seqalign_tpu_torch.ops import traceback as tb
from swbench.metrics import align_host_cell_pct

from test_torch_trace import inside, traced
from test_torch_traceback_plan import on_card  # noqa: F401 (a fixture)

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"
K = 12
STEPS = {"seqalign.select", "seqalign.ends", "seqalign.fill", "seqalign.walk"}
# Pairs above this many cells are localized: the query (300) against its
# homologs of 250-600 residues below, and no record of at most 199.
DIRECT_CELLS = 301 * 201


@pytest.fixture
def scoring():
    return load_builtin("BLOSUM62", ScoringModel(gap_open=-11, gap_extend=-1,
                                                 use_match_mismatch=False))


def star_negative(scoring):
    """``scoring`` with a '*' row and column that score -4: the long pairs'
    ends then come from the engine on the device."""
    t = scoring.table.copy()
    t[31, :] = t[:, 31] = -4
    return t


def protein(rng, n):
    return encode("".join(AMINO_ACIDS[i] for i in rng.integers(0, 20, n)))


def homolog(rng, q, n):
    """``q`` with a fifth of its residues redrawn, cut or flanked with random
    residues to ``n``."""
    h = q.copy()
    redraw = rng.random(len(h)) < 0.2
    h[redraw] = protein(rng, int(redraw.sum()))
    h = h[:n]
    left = int(rng.integers(n - len(h) + 1))
    return np.concatenate([protein(rng, left), h, protein(rng, n - len(h) - left)])


def case(seed=71):
    """A 300-residue query, and 300 records: random ones of 1-199 residues
    and, among them, homologs of the query of 150-600."""
    rng = np.random.default_rng(seed)
    query = protein(rng, 300)
    records = [protein(rng, int(n)) for n in rng.integers(1, 200, 290)]
    records += [homolog(rng, query, int(n)) for n in (150, 180, 250, 290, 300, 400, 450,
                                                         500, 550, 600)]
    order = rng.permutation(len(records))
    return query, pipeline._db_from_encoded([records[k] for k in order])


def align(query, db, table, scoring):
    scores, _ = pipeline.search_database(query, db, scoring, device="cpu")
    return lambda: tb.topk_alignments(query, db, scores, K, table, scoring.gap_open,
                                      scoring.gap_extend, device="cpu")


def reverse_window(aln, table, gap_extend):
    """The reverse pass's rows x columns: the windowed, reversed prefixes
    that end at the alignment's end cell."""
    ei, ej = aln.query_end, aln.db_end
    smax, gabs = max(1, int(np.max(table))), max(1, -gap_extend)
    wq = min(ei, ej + (ej * smax) // gabs + 2)
    wd = min(ej, ei + (ei * smax) // gabs + 2)
    return wq * wd


def by_hand(query, db, found, table, gap_extend, engine):
    """The counted spans of one call, worked out from the hits: for a pair
    at most ``DIRECT_CELLS``, one fill of lq x lb; for a longer one, a
    forward ends pass of lq x lb on the host (or, with the engine, one
    device pass over every long pair first), the reverse pass over its
    window, and the fill of the alignment's rectangle."""
    lq, n = len(query), db.n
    long = [len(db.record(r)) for r, _ in found
            if (len(db.record(r)) + 1) * (lq + 1) > DIRECT_CELLS]
    out = [("seqalign.align", {"hits": min(K, n)}), ("seqalign.select", {"records": n})]
    if engine:
        out.append(("seqalign.ends", {"cells_device": lq * sum(long)}))
    for rec, aln in found:
        lb = len(db.record(rec))
        if (lb + 1) * (lq + 1) <= DIRECT_CELLS:
            out.append(("seqalign.fill", {"cells_host": lq * lb}))
            continue
        if not engine:
            out.append(("seqalign.ends", {"cells_host": lq * lb}))
        out.append(("seqalign.ends", {"cells_host": reverse_window(aln, table, gap_extend)}))
        out.append(("seqalign.fill", {"cells_host": (aln.query_end - aln.query_start)
                                      * (aln.db_end - aln.db_start)}))
    return out


@pytest.mark.parametrize("engine", [False, True], ids=["host-ends", "device-ends"])
def test_one_align_root_a_call_and_every_step_inside_it(scoring, monkeypatch, engine):
    monkeypatch.setattr(tb, "_DIRECT_CELLS", DIRECT_CELLS)
    query, db = case()
    table = star_negative(scoring) if engine else scoring.table
    run = align(query, db, table, scoring)
    (found, again), spans, _, _, _ = traced(lambda: (run(), run()))
    assert found == again
    roots = [ev for ev in spans if not any(inside(ev, o) for o in spans if o is not ev)]
    assert [ev[0] for ev in roots] == ["seqalign.align"] * 2
    for root in roots:
        assert {ev[0] for ev in spans if ev is not root and inside(ev, root)} == STEPS
    walks = [ev for ev in spans if ev[0] == "seqalign.walk"]
    assert len(walks) == 2 * K


@pytest.mark.parametrize("engine", [False, True], ids=["host-ends", "device-ends"])
def test_cells_counted_are_the_passes_and_rectangles(scoring, monkeypatch, engine):
    """Host ends under BLOSUM62 as published ('*' against '*' scores +1);
    with a '*' that scores -4 the long pairs' forward passes are one pass of
    the engine, counted as ``cells_device``."""
    monkeypatch.setattr(tb, "_DIRECT_CELLS", DIRECT_CELLS)
    query, db = case()
    table = star_negative(scoring) if engine else scoring.table
    found, _, records, _, _ = traced(align(query, db, table, scoring))
    assert [a.score for _, a in found] == sorted((a.score for _, a in found), reverse=True)
    long = sum((len(db.record(r)) + 1) * (len(query) + 1) > DIRECT_CELLS for r, _ in found)
    assert 0 < long < K  # both routes are counted
    assert [(r["name"], r["counts"]) for r in records] == by_hand(
        query, db, found, table, scoring.gap_extend, engine)


def test_no_profiler_records_nothing(scoring):
    query, db = case()
    trace.clear()
    found = align(query, db, scoring.table, scoring)()
    assert len(found) == K
    assert trace.recorded() == []
    assert trace.span("align", hits=K) is trace.span("walk") is trace._OFF


def test_hits_are_capped_at_the_records(scoring):
    rng = np.random.default_rng(72)
    query = protein(rng, 40)
    db = pipeline._db_from_encoded([protein(rng, n) for n in (30, 50, 70)])
    scores, _ = pipeline.search_database(query, db, scoring, device="cpu")
    found, _, records, _, _ = traced(lambda: tb.topk_alignments(
        query, db, scores, 10, scoring.table, scoring.gap_open, scoring.gap_extend))
    assert len(found) == 3
    assert records[:2] == [{"name": "seqalign.align", "counts": {"hits": 3}},
                           {"name": "seqalign.select", "counts": {"records": 3}}]
    assert [r["counts"] for r in records[2:]] == [
        {"cells_host": 40 * len(db.record(r))} for r, _ in found]


def test_myers_miller_counts_its_rectangle_once(scoring, monkeypatch):
    """A localized pair whose rectangle passes ``MAX_CELLS`` is aligned by
    ``_myers_miller`` under one ``fill`` of the rectangle's cells."""
    monkeypatch.setattr(tb, "_DIRECT_CELLS", 1 << 10)
    monkeypatch.setattr(tb, "MAX_CELLS", 1 << 12)
    monkeypatch.setattr(tb, "_MM_BASE_CELLS", 1 << 8)
    rng = np.random.default_rng(73)
    query = protein(rng, 100)
    db = pipeline._db_from_encoded([homolog(rng, query, n) for n in (100, 110, 120)]
                                   + [protein(rng, 10) for _ in range(5)])
    scores, _ = pipeline.search_database(query, db, scoring, device="cpu")
    found, _, records, _, _ = traced(lambda: tb.topk_alignments(
        query, db, scores, 3, scoring.table, scoring.gap_open, scoring.gap_extend,
        device="cpu"))
    rects = [(a.query_end - a.query_start) * (a.db_end - a.db_start) for _, a in found]
    assert min(rects) > 1 << 12
    assert [r["counts"]["cells_host"] for r in records if r["name"] == "seqalign.fill"] == rects


def test_card_route_counts_its_passes_as_device_cells(scoring, monkeypatch, on_card):
    """One ``ends`` of every long pair's forward pass, one of their reverse
    passes, one ``fill`` of every hit's states, each counted as
    ``cells_device`` (rows x columns, as the host counts them); the walks
    inside the root as before; ``align_host_cell_pct`` reads 0."""
    monkeypatch.setattr(tb, "_DIRECT_CELLS", DIRECT_CELLS)
    query, db = case()
    scores, _ = pipeline.search_database(query, db, scoring, device="cpu")
    run = lambda: tb.topk_alignments(query, db, scores, K, scoring.table, scoring.gap_open,
                                     scoring.gap_extend)
    found, spans, records, _, _ = traced(run)
    want = tb.topk_alignments(query, db, scores, K, scoring.table, scoring.gap_open,
                              scoring.gap_extend, engine_ends=False)
    assert found == want
    lq = len(query)
    long = [(r, a) for r, a in found if (len(db.record(r)) + 1) * (lq + 1) > DIRECT_CELLS]
    assert 0 < len(long) < K
    fills = [(a.query_end - a.query_start) * (a.db_end - a.db_start)
             if (len(db.record(r)) + 1) * (lq + 1) > DIRECT_CELLS else lq * len(db.record(r))
             for r, a in found]
    assert [(r["name"], r["counts"]) for r in records] == [
        ("seqalign.align", {"hits": K}), ("seqalign.select", {"records": db.n}),
        ("seqalign.ends", {"cells_device": lq * sum(len(db.record(r)) for r, _ in long)}),
        ("seqalign.ends", {"cells_device": sum(reverse_window(a, scoring.table,
                                                              scoring.gap_extend)
                                               for _, a in long)}),
        ("seqalign.fill", {"cells_device": sum(fills)})]
    assert [len(launch) for launch in on_card] == [len(long), len(long), K]
    root = [ev for ev in spans if ev[0] == "seqalign.align"]
    assert len(root) == 1
    assert {ev[0] for ev in spans if ev is not root[0] and inside(ev, root[0])} == STEPS
    assert sum(ev[0] == "seqalign.walk" for ev in spans) == K
    assert align_host_cell_pct.read(None) == 0


def test_host_route_reads_every_cell_on_the_host(scoring, monkeypatch):
    """On a CPU device the step stays on the host: ``align_host_cell_pct``
    reads 100."""
    monkeypatch.setattr(tb, "_DIRECT_CELLS", DIRECT_CELLS)
    query, db = case()
    traced(align(query, db, scoring.table, scoring))
    assert align_host_cell_pct.read(None) == 100

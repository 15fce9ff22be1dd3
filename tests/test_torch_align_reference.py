"""The port's alignment step against the benchmark's plain reference, on the
CPU: seeded queries searched over a seeded small database (``pipeline.
search_database``, then ``ops.traceback.topk_alignments`` of the best
hits) under BLOSUM62 11/1 and PAM250 2/1, through the direct fill, the
localized one and Myers-Miller. The search's scores must equal
``swbench/reference.py``'s for every record, and every hit must pass
``swbench.alignments.compare`` against them with no mismatch.

The file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest

from seqalign_tpu_torch import pipeline
from seqalign_tpu_torch.host import EncodedDatabase, ScoringModel
from seqalign_tpu_torch.ops import traceback as tb
from swbench import alignments
from swbench.data import Database
from swbench.reference import sw_scores
from swbench.scoring import AMINO_ACIDS, code, load_table

AA = np.array([code(a) for a in AMINO_ACIDS])
K = 6
SCORINGS = {"blosum62": ("BLOSUM62", -11, -1), "pam250": ("PAM250", -2, -1)}
# The constants each path takes; the pairs here hold at most 121 x 260 cells.
PATHS = {
    "direct": {},
    "localized": {"_DIRECT_CELLS": 0},
    "myers_miller": {"_DIRECT_CELLS": 1 << 10, "MAX_CELLS": 1 << 12, "_MM_BASE_CELLS": 1 << 8},
}


def homolog(rng, q, n):
    """``q`` with a quarter of its residues redrawn and short insertions
    and deletions, cut or flanked with random residues to ``n``."""
    out, i = [], 0
    while i < len(q):
        u = rng.random()
        if u < 0.03:
            i += int(rng.integers(1, 4))
            continue
        if u < 0.06:
            out.extend(AA[rng.integers(0, 20, int(rng.integers(1, 4)))])
        out.append(q[i] if rng.random() > 0.25 else AA[rng.integers(20)])
        i += 1
    out = np.array(out)[:n]
    left = int(rng.integers(n - len(out) + 1))
    return np.concatenate([AA[rng.integers(0, 20, left)], out,
                           AA[rng.integers(0, 20, n - len(out) - left)]])


def database(rng, queries):
    """40 random records of 5-199 residues and two homologs of each query."""
    records = [AA[rng.integers(0, 20, int(n))] for n in rng.integers(5, 200, 40)]
    for q in queries:
        records += [homolog(rng, q, int(n)) for n in rng.integers(len(q) - 20, 260, 2)]
    records = [records[k].astype(np.int8) for k in rng.permutation(len(records))]
    offsets = np.concatenate(([0], np.cumsum([len(r) for r in records])))
    return np.concatenate(records), offsets


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_hits_hold_to_the_reference(scoring, path, monkeypatch):
    matrix, go, ge = SCORINGS[scoring]
    table = load_table(matrix)
    model = ScoringModel(gap_open=go, gap_extend=ge, use_match_mismatch=False, table=table.copy())
    rng = np.random.default_rng(sum(map(ord, scoring + path)))
    queries = [AA[rng.integers(0, 20, n)].astype(np.int32) for n in (60, 120)]
    seq, offsets = database(rng, queries)
    db = EncodedDatabase(seq=seq, offsets=offsets, names=[""] * (len(offsets) - 1))
    for name, value in PATHS[path].items():
        monkeypatch.setattr(tb, name, value)
    taken = {"_localized_traceback": 0, "_myers_miller": 0}
    for name in taken:
        def spy(*args, _name=name, _real=getattr(tb, name), **kwargs):
            taken[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(tb, name, spy)

    answers, hits = [], []
    for q in queries:
        scores, _ = pipeline.search_database(q, db, model, device="cpu")
        want = sw_scores([q], seq, np.diff(offsets), table, go, ge)[0]
        np.testing.assert_array_equal(scores, want)
        found = tb.topk_alignments(q, db, scores, K, model.table, go, ge, device="cpu")
        answers.append((np.arange(db.n), want[None]))
        hits.append([[alignments.Hit(rec, a.score, a.query_start, a.query_end, a.db_start,
                                     a.db_end, a.query_aligned, a.db_aligned, a.cigar)
                      for rec, a in found]])
    got = alignments.compare(Database(seq=seq, offsets=offsets), [[q] for q in queries],
                             answers, hits, [0, 1], K, table, go, ge)
    assert got["examples"] == []
    assert (got["mismatches"], got["compared"]) == (0, K * len(queries))
    assert any(set(h.cigar) & {"I", "D"} for qh in hits for h in qh[0])
    localized = 0 if path == "direct" else K * len(queries)
    assert taken["_localized_traceback"] == localized
    assert (taken["_myers_miller"] > 0) == (path == "myers_miller")

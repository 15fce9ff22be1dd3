"""The alignment check against the port's ``topk_alignments`` on seeded
pairs: every alignment the port makes passes, every tampered one fails.
Scores come from the reference; the pairs are homologs of the query with
substitutions, insertions and deletions, and random records."""

import functools

import numpy as np
import pytest
import torch

from swbench.alignments import Hit, expand_cigar, hit_faults, judge_query, rescore
from swbench.data import Database
from swbench.reference import sw_scores
from swbench.scoring import AMINO_ACIDS, code, load_table
from swbench.tests.tamper import TAMPERS, from_port

AA = np.array([code(a) for a in AMINO_ACIDS])
K = 5


def homolog(rng, q, length):
    """``q`` with a quarter of its residues redrawn and short indels, cut
    or flanked with random residues to ``length``."""
    out, i = [], 0
    while i < len(q):
        u = rng.random()
        if u < 0.03:
            i += int(rng.integers(1, 5))
            continue
        if u < 0.06:
            out.extend(AA[rng.integers(0, 20, int(rng.integers(1, 5)))])
        out.append(q[i] if rng.random() > 0.25 else AA[rng.integers(20)])
        i += 1
    out = np.array(out)[:length]
    left = int(rng.integers(length - len(out) + 1))
    return np.concatenate([AA[rng.integers(0, 20, left)], out,
                           AA[rng.integers(0, 20, length - len(out) - left)]])


def no_star(table):
    """A table with no ``*`` row or column, as a matrix file without one
    loads: the port then takes the big pairs' ends from its wavefront."""
    t = table.copy()
    t[31, :] = 0
    t[:, 31] = 0
    return t


# name: (matrix, gap_open, gap_extend, query length, homolog lengths, table change)
CASES = {
    "blosum62": ("BLOSUM62", -11, -1, 150, (150, 230, 90, 160), None),
    "pam250": ("PAM250", -2, -1, 150, (150, 230, 90, 160), None),
    "go-equals-ge": ("BLOSUM62", 0, -1, 120, (120, 200, 70, 140), None),
    "long-host-ends": ("BLOSUM62", -11, -1, 2100, (2100, 1500), None),
    "long-wavefront-ends": ("BLOSUM62", -11, -1, 2100, (2100, 1500), no_star),
}


def table_of(name):
    matrix, _, _, _, _, change = CASES[name]
    table = load_table(matrix)
    return change(table) if change else table


@functools.lru_cache(maxsize=None)
def searched(name):
    """``(query, db, scores, the port's K + 1 best hits, traceback paths
    taken)`` of case ``name``."""
    from seqalign_tpu_torch.host import EncodedDatabase
    from seqalign_tpu_torch.ops import swa_torch, traceback

    _, go, ge, lq, lengths, _ = CASES[name]
    table = table_of(name)
    rng = np.random.default_rng(sum(map(ord, name)))
    query = AA[rng.integers(0, 20, lq)]
    records = [homolog(rng, query, n) for n in lengths]
    records += [AA[rng.integers(0, 20, int(n))] for n in rng.integers(20, 300, 8)]
    order = rng.permutation(len(records))
    records = [records[i] for i in order]
    offsets = np.concatenate(([0], np.cumsum([len(r) for r in records])))
    seq = np.concatenate(records).astype(np.int8)
    scores = sw_scores([query], seq, np.diff(offsets), table, go, ge)[0]
    db = EncodedDatabase(seq=seq, offsets=offsets, names=[""] * len(records))
    localized, ends = traceback._localized_traceback, swa_torch.sw_wavefront_ends.calls
    taken = {"localized": 0}

    def spy(*args, **kwargs):
        taken["localized"] += 1
        return localized(*args, **kwargs)

    traceback._localized_traceback = spy
    try:
        found = traceback.topk_alignments(query.astype(np.int32), db, scores, K + 1, table, go,
                                          ge, device=torch.device("cpu"))
    finally:
        traceback._localized_traceback = localized
    taken["wavefront"] = swa_torch.sw_wavefront_ends.calls - ends
    return query, Database(seq=seq, offsets=offsets), scores, from_port(found), taken


def judge(name, hits):
    _, go, ge, _, _, _ = CASES[name]
    query, db, scores, _, _ = searched(name)
    return judge_query(hits, query, db, np.arange(len(scores)), scores, K, table_of(name), go,
                       ge)


@pytest.mark.parametrize("name", CASES)
def test_port_alignments_pass(name):
    query, db, scores, hits, _ = searched(name)
    _, go, ge, _, _, _ = CASES[name]
    for h in hits:
        seq, _ = db.records(np.array([h.record]))
        assert hit_faults(h, query, seq, table_of(name), go, ge) == []
        assert h.score == scores[h.record]
    assert judge(name, hits[:K]) == (0, [])
    assert any(set(h.cigar) & {"I", "D"} for h in hits)  # gapped alignments were judged


def test_long_pairs_take_the_localized_paths():
    assert searched("long-host-ends")[4] == {"localized": 1, "wavefront": 0}
    assert searched("long-wavefront-ends")[4] == {"localized": 1, "wavefront": 1}
    for name in ("long-host-ends", "long-wavefront-ends"):
        best = searched(name)[3][0]
        assert best.query_end - best.query_start > 1500


@pytest.mark.parametrize("tamper", TAMPERS, ids=lambda t: t.__name__)
@pytest.mark.parametrize("name", CASES)
def test_tampered_alignments_fail(name, tamper):
    _, go, ge, _, _, _ = CASES[name]
    mismatches, bad = judge(name, tamper(list(searched(name)[3]), table_of(name), go, ge))
    assert mismatches > 0 and bad


def test_cigar_and_rescoring_by_hand():
    table = load_table("BLOSUM62")
    assert expand_cigar("2M1I1D") == "MMID"
    for bad in ("0M", "2X", "M2", "2M 1I", ""):
        assert expand_cigar(bad) in (None, "")
    # A run of I beside a run of D is two gaps: 11 + 1 each.
    hit = Hit(0, 0, 0, 3, 0, 3, "WW-W", "W-WW", "1M1I1D1M")
    assert rescore(hit, table, -11, -1) == 11 + 11 - 12 - 12
    assert rescore(Hit(0, 0, 0, 2, 0, 2, "W--W", "WAAW", "1M2D1M"), table, -11, -1) == 22 - 13
    assert rescore(Hit(0, 0, 0, 1, 0, 1, "-", "-", "1M"), table, -11, -1) is None

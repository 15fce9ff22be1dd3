"""The frozen reference: hand-worked cases, and the program's NumPy oracle
on small random inputs (a test may import both; the reference may not)."""

import numpy as np
import pytest

from swbench.reference import sw_scores
from swbench.scoring import AMINO_ACIDS, code, load_table

AA = np.array([code(a) for a in AMINO_ACIDS])


def enc(s):
    return np.array([code(c) for c in s])


def score(query, record, matrix, gap_open, gap_extend):
    return int(sw_scores([enc(query)], enc(record), [len(record)], load_table(matrix),
                         gap_open, gap_extend)[0, 0])


@pytest.mark.parametrize("query, record, matrix, gaps, want", [
    # Identity: the diagonal's sum (BLOSUM62 W/W 11, C/C 9).
    ("WCW", "WCW", "BLOSUM62", (-11, -1), 31),
    # No positive pair: the empty alignment, 0.
    ("WW", "GG", "BLOSUM62", (-11, -1), 0),
    # WWWW against WWGWW: ungapped WWGW scores 11 + 11 - 2 + 11 = 31; one
    # gap of one residue costs 11 + 1, so 44 - 12 = 32 wins.
    ("WWWW", "WWGWW", "BLOSUM62", (-11, -1), 32),
    # PAM250 (W/W 17, W/G -7), gaps 2 + k: 68 - 3 = 65 against 44.
    ("WWWW", "WWGWW", "PAM250", (-2, -1), 65),
    # A gap of two: 44 - (11 + 2) = 31 against WWGG's 18.
    ("WWWW", "WWGGWW", "BLOSUM62", (-11, -1), 31),
    # Local: the best part of a longer record.
    ("CWC", "AAAACWCAAAA", "BLOSUM62", (-11, -1), 29),
])
def test_hand_worked(query, record, matrix, gaps, want):
    assert score(query, record, matrix, *gaps) == want


@pytest.mark.parametrize("matrix, gap_open, gap_extend, max_len", [
    ("BLOSUM62", -11, -1, 60),
    ("PAM250", -2, -1, 700),  # records across the scan's pieces of 512
    ("BLOSUM62", -5, -2, 300),
    ("PAM250", 0, 0, 40),
    ("BLOSUM62", -1, -1, 90),
])
def test_matches_the_programs_oracle(matrix, gap_open, gap_extend, max_len):
    from seqalign_tpu_torch.ops.oracle import sw_score_batch

    rng = np.random.default_rng(max_len)
    table = load_table(matrix)
    queries = [AA[rng.integers(0, 20, rng.integers(1, 40))] for _ in range(3)]
    lengths = rng.integers(1, max_len, 30)
    seq = AA[rng.integers(0, 20, lengths.sum())]
    records = np.split(seq, np.cumsum(lengths)[:-1])
    got = sw_scores(queries, seq, lengths, table, gap_open, gap_extend)
    want = np.stack([sw_score_batch(q, records, table, gap_open, gap_extend) for q in queries])
    assert np.array_equal(got, want)


def test_queries_of_different_lengths_score_as_alone():
    rng = np.random.default_rng(5)
    table = load_table("BLOSUM62")
    queries = [AA[rng.integers(0, 20, n)] for n in (3, 50, 17)]
    lengths = rng.integers(1, 80, 20)
    seq = AA[rng.integers(0, 20, lengths.sum())]
    together = sw_scores(queries, seq, lengths, table, -11, -1)
    alone = np.concatenate([sw_scores([q], seq, lengths, table, -11, -1) for q in queries])
    assert np.array_equal(together, alone)


def test_refuses_gap_costs_it_cannot_scan():
    with pytest.raises(ValueError):
        sw_scores([enc("AA")], enc("AA"), [2], load_table("BLOSUM62"), 1, -1)


@pytest.mark.parametrize("matrix, gap_open, gap_extend", [
    ("BLOSUM62", -11, -1), ("PAM250", -2, -1)])
def test_saturating_widths_stop_at_their_top(matrix, gap_open, gap_extend):
    """In ``bits``-bit saturating integers a score is the exact one, or the
    top where the exact one passes it."""
    rng = np.random.default_rng(17)
    table = load_table(matrix)
    lengths = rng.integers(1, 120, 40)
    seq = AA[rng.integers(0, 20, lengths.sum())]
    records = np.split(seq, np.cumsum(lengths)[:-1])
    # Copies of records score far past 127; random queries stay below it.
    queries = [records[int(np.argmax(lengths))], records[3][:25],
               AA[rng.integers(0, 20, 30)]]
    exact = sw_scores(queries, seq, lengths, table, gap_open, gap_extend)
    assert exact.max() > 127 and (exact < 127).any()
    for bits in (8, 16):
        top = 2 ** (bits - 1) - 1
        got = sw_scores(queries, seq, lengths, table, gap_open, gap_extend, bits=bits)
        assert np.array_equal(got, np.minimum(exact, top))

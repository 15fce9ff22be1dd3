"""The benchmark's inputs: the database and query generators, and its own
substitution tables held to the program's."""

import json

import numpy as np
import pytest
import torch

from swbench.data import (
    HOMOLOG_POOL, Homologs, make_database, random_queries, record_lengths, residue_freqs,
    residue_table, seeded_lengths,
)
from swbench.scoring import AMINO_ACIDS, code, load_table
from swbench.tests.tiny import SWBENCH, tiny_config

CONFIGS = ["swissprot-blosum62", "swissprot-pam250"]
BIG_SEED = 2**31 + 12345


def config(name):
    return json.loads((SWBENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_full_scale_counts(name):
    cfg = config(name)
    lengths = record_lengths(cfg["database"], residue_freqs(cfg)[1])
    assert len(lengths) == cfg["database"]["records"] == 565_247
    assert int(lengths.sum()) == cfg["database"]["residues"] == 205_232_251
    assert lengths.min() >= 2 and lengths.max() <= 35_000


def test_full_scale_order_is_shuffled_from_the_seed():
    cfg = config("swissprot-blosum62")
    a, b = seeded_lengths(cfg, BIG_SEED), seeded_lengths(cfg, BIG_SEED + 1)
    assert np.array_equal(a, seeded_lengths(cfg, BIG_SEED))
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))  # the same work for every seed
    assert (np.diff(a) > 0).any() and (np.diff(a) < 0).any()  # sorted neither way


def test_database_is_deterministic_per_seed():
    cfg = tiny_config("t", "BLOSUM62", -11, -1)
    one = make_database(cfg, BIG_SEED, torch.device("cpu"))
    two = make_database(cfg, BIG_SEED, torch.device("cpu"))
    other = make_database(cfg, BIG_SEED + 1, torch.device("cpu"))
    assert np.array_equal(one.seq, two.seq) and np.array_equal(one.offsets, two.offsets)
    assert not np.array_equal(one.seq[: len(other.seq)], other.seq[: len(one.seq)])
    assert len(one.seq) == len(other.seq) == one.offsets[-1]


def test_residues_follow_the_configured_frequencies():
    cfg = tiny_config("t", "BLOSUM62", -11, -1)
    cfg["database"] = dict(cfg["database"], records=4000,
                           lengths=dict(cfg["database"]["lengths"], gamma_scale=60.0, max=400))
    db = make_database(cfg, 7, torch.device("cpu"))
    codes, p = residue_freqs(cfg)
    counts = np.array([(db.seq == c).sum() for c in codes])
    assert counts.sum() == len(db.seq)
    share = counts / counts.sum()
    assert np.abs(share - p).max() < 4 * np.sqrt(p.max() / len(db.seq)) + 2**-16


def test_residue_table_rounds_each_share():
    _, p = residue_freqs(config("swissprot-pam250"))
    table = residue_table(p)
    assert len(table) == 2**16
    assert np.abs(np.bincount(table, minlength=len(p)) / 2**16 - p).max() <= 2**-16


def test_queries_are_fresh_and_of_the_asked_lengths():
    cfg = config("swissprot-blosum62")
    rng = np.random.default_rng(3)
    qs = random_queries(cfg, rng, [144, 144, 5478])
    assert [len(q) for q in qs] == [144, 144, 5478]
    assert not np.array_equal(qs[0], qs[1])
    assert set(np.unique(np.concatenate(qs))) <= {code(a) for a in AMINO_ACIDS}


def tiny_db(records=300, seed=BIG_SEED):
    cfg = tiny_config("t", "BLOSUM62", -11, -1)
    cfg["database"] = dict(cfg["database"], records=records)
    return cfg, make_database(cfg, seed, torch.device("cpu"))


def test_a_query_copies_a_window_of_its_record():
    cfg, db = tiny_db()
    homologs = Homologs(cfg, db)
    rng = np.random.default_rng(5)
    for n in (5, 30, 60):
        record = homologs.record(rng, n)
        q = homologs.query(rng, record, n, 0.0)
        residues = db.records(np.array([record]))[0].astype(np.int32)
        assert len(q) == n and len(residues) >= n
        assert any(np.array_equal(q, residues[a : a + n]) for a in range(len(residues) - n + 1))


def test_a_query_longer_than_the_records_holds_one_of_the_longest():
    cfg, db = tiny_db()
    homologs = Homologs(cfg, db)
    rng = np.random.default_rng(6)
    n = int(db.lengths.max()) + 50
    longest = np.sort(db.lengths)[::-1]
    record = homologs.record(rng, n)
    assert db.lengths[record] >= longest[HOMOLOG_POOL - 1]
    q = homologs.query(rng, record, n, 0.0)
    residues = db.records(np.array([record]))[0].astype(np.int32)
    m = len(residues)
    assert len(q) == n
    assert any(np.array_equal(q[a : a + m], residues) for a in range(n - m + 1))


def test_mutate_redraws_its_share_of_residues():
    cfg, db = tiny_db()
    homologs = Homologs(cfg, db)
    rng = np.random.default_rng(7)
    n = 80
    record = int(np.argmax(db.lengths))
    kept = []
    for _ in range(200):
        q = homologs.query(rng, record, n, 0.3)
        residues = db.records(np.array([record]))[0].astype(np.int32)
        kept.append(max(np.mean(q == residues[a : a + n])
                        for a in range(len(residues) - n + 1)))
    # A redrawn residue is the same by chance about 6% of the time.
    assert 0.65 < np.mean(kept) < 0.8


@pytest.mark.parametrize("kind, params", [
    ("single", {"lengths": [40, 5, 20], "mutate": 0.0}),
    ("single", {"lengths": [40, 5, 20], "mutate": 0.1}),
    ("batch", {"queries": 5, "lengths": {"min": 10, "max": 30}, "mutate": 0.3}),
])
def test_traffic_is_deterministic_and_names_its_records(kind, params):
    from swbench.cell import load_module

    traffic = load_module(SWBENCH / "traffic" / f"{kind}.py")
    cfg, db = tiny_db()
    one = [next(s) for s in [traffic.requests(params, cfg, db, BIG_SEED)] for _ in range(9)]
    two = [next(s) for s in [traffic.requests(params, cfg, db, BIG_SEED)] for _ in range(9)]
    other = [next(s) for s in [traffic.requests(params, cfg, db, BIG_SEED + 1)] for _ in range(9)]
    flat = lambda reqs: [q for qs, _ in reqs for q in qs]  # noqa: E731
    assert all(np.array_equal(a, b) for a, b in zip(flat(one), flat(two)))
    assert not all(np.array_equal(a, b) for a, b in zip(flat(one), flat(other)))
    assert sorted(len(q) for q in flat(one)) == sorted(len(q) for q in flat(other))
    for qs, records in one:
        assert len(records) == (1 if kind == "batch" else len(qs))
        assert all(0 <= r < len(db.lengths) for r in records)
    if kind == "single":  # every pass in the order listed
        assert [len(qs[0]) for qs, _ in one] == params["lengths"] * 3


@pytest.mark.parametrize("name", ["BLOSUM62", "PAM250"])
def test_tables_equal_the_programs(name):
    from seqalign_tpu_torch.host import ScoringModel, load_builtin

    port = load_builtin(name, ScoringModel(gap_open=-1, gap_extend=-1, use_match_mismatch=False))
    assert np.array_equal(load_table(name), port.table)

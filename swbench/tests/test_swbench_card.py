"""On a card: the reference and the database generator there, against the
CPU. Skips without one (``python -m pytest swbench/tests -m cuda`` on the
chip machine)."""

import time

import numpy as np
import pytest
import torch

from swbench import cell as cells
from swbench.data import make_database
from swbench.reference import sw_scores
from swbench.scoring import AMINO_ACIDS, code, load_table
from swbench.tests.tiny import make_root, tiny_config


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_reference_on_the_card_equals_the_cpu(card):
    rng = np.random.default_rng(11)
    aa = np.array([code(a) for a in AMINO_ACIDS])
    queries = [aa[rng.integers(0, 20, n)] for n in (144, 31)]
    lengths = rng.integers(1, 1500, 300)
    seq = aa[rng.integers(0, 20, lengths.sum())]
    table = load_table("BLOSUM62")
    assert np.array_equal(sw_scores(queries, seq, lengths, table, -11, -1, card),
                          sw_scores(queries, seq, lengths, table, -11, -1, "cpu"))


@pytest.mark.cuda
def test_database_on_the_card_is_deterministic(card):
    cfg = tiny_config("t", "BLOSUM62", -11, -1)
    one, two = make_database(cfg, 2**31 + 5, card), make_database(cfg, 2**31 + 5, card)
    assert np.array_equal(one.seq, two.seq) and np.array_equal(one.offsets, two.offsets)


@pytest.mark.cuda
def test_a_run_on_the_card_reads_the_allocators_peak(card, tmp_path):
    root = make_root(tmp_path)
    cell = cells.load_cell("tiny-pam", root.parent / "BENCHMARK.json", root)
    line = cells.execute(cell, 2**31 + 7, 0.3, False, card, time.time(), log=lambda msg: None)
    peak = line["device"]["memory_peak_bytes"]
    assert line["correct"] is True and peak > 0
    assert line["metrics"]["device_peak_gib"]["value"] == peak / 2**30

"""The readers of the plan memo's counters (``plan_hit_pct`` and its
``.single`` form) on hand-made records, without them, and in a traced run
of a tiny cell on the CPU."""

import sys
import time

import pytest
import torch

from swbench import cell as cells
from swbench.tests.test_swbench_metrics import reader, run_of
from swbench.tests.tiny import make_root

SEED = 2**31 + 7

PLAN_RECORDS = [
    {"name": "seqalign.plan", "counts": {"plan_hits": 0, "plan_misses": 3}},
    {"name": "seqalign.launch", "counts": {"cells_real": 9, "cells_launched": 10}},
    {"name": "seqalign.plan", "counts": {"plan_hits": 3, "plan_misses": 0}},
    {"name": "seqalign.plan", "counts": {"plan_hits": 1, "plan_misses": 0}},
]


@pytest.fixture
def recorded(monkeypatch):
    """Stands the given records in for the program's own."""
    import seqalign_tpu_torch.trace as program_trace

    def use(records):
        monkeypatch.setattr(program_trace, "recorded", lambda: records)
    return use


@pytest.mark.parametrize("suffix", ["", ".single"])
@pytest.mark.parametrize("records,want", [
    (PLAN_RECORDS, 100 * 4 / 7),  # 4 of 7 chunks from the memo
    (PLAN_RECORDS[1:], 100.0),
    (PLAN_RECORDS[:2], 0.0),
    (PLAN_RECORDS[1:2], None),  # launches only: a program without the counters
    ([{"name": "seqalign.plan", "counts": {"plan_hits": 0, "plan_misses": 0}}], None),
    ([], None),  # an untraced run
])
def test_plan_hit_pct_is_hits_over_the_plan_spans_chunks(recorded, suffix, records, want):
    recorded(records)
    got = reader(f"plan_hit_pct{suffix}").read(run_of([1.0], [0.5], [1]))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("suffix", ["", ".single"])
def test_plan_hit_pct_is_none_without_the_trace_module(monkeypatch, suffix):
    """A program older than its spans has no trace module."""
    monkeypatch.setitem(sys.modules, "seqalign_tpu_torch.trace", None)
    assert reader(f"plan_hit_pct{suffix}").read(run_of([1.0], [0.5], [1])) is None


@pytest.mark.parametrize("name", ["tiny-single", "tiny-batch"])
def test_a_traced_tiny_cell_hits_the_memo_in_its_window(tmp_path, monkeypatch, name):
    """The warm-up planned every cut the window's searches take."""
    from seqalign_tpu_torch import trace as program_trace

    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")
    root = make_root(tmp_path)
    cell = cells.load_cell(name, root.parent / "BENCHMARK.json", root)
    program_trace.clear()
    line = cells.execute(cell, SEED, 0.3, True, torch.device("cpu"), time.time(),
                         log=lambda msg: None)
    assert line["correct"] is True
    metrics = line["metrics"]
    assert metrics["plan_hit_pct"]["value"] == metrics["plan_hit_pct.single"]["value"] == 100
    program_trace.clear()
    untraced = cells.execute(cell, SEED, 0.3, False, torch.device("cpu"), time.time(),
                             log=lambda msg: None)
    assert "plan_hit_pct" not in untraced["metrics"]
    assert not program_trace.recorded()

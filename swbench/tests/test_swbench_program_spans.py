"""The readers of the program's own spans and counters (``plan_ms``,
``cell_fill_pct`` and their ``.single`` forms) on synthetic traces and
records, without them, and in a traced run of a tiny cell on the CPU."""

import sys
import time

import pytest
import torch

from swbench import cell as cells
from swbench import trace
from swbench.tests.test_swbench_metrics import reader, run_of
from swbench.tests.tiny import make_root

SEED = 2**31 + 7


def two_searches():
    """The host timeline of two searches in a stretch of 0.01-0.40 s: sort 3
    + plan 1 + 2 ms in the first, a search inside it whose sort (1.5 ms)
    counts too, sort 4 + plan 2 ms in the second; a plan outside the
    stretch, which no reader takes, and other host events."""
    ms = 1e-3
    host = [
        ("seqalign.sort", 11 * ms, 14 * ms), ("seqalign.plan", 15 * ms, 16 * ms),
        ("seqalign.plan", 16 * ms, 18 * ms), ("aten::copy_", 18 * ms, 19 * ms),
        ("seqalign.sort", 31 * ms, 32.5 * ms), ("seqalign.wait", 33 * ms, 60 * ms),
        ("seqalign.sort", 201 * ms, 205 * ms), ("seqalign.plan", 205 * ms, 207 * ms),
        ("seqalign.plan", 450 * ms, 500 * ms),
    ]
    return trace.Trace((10 * ms, 400 * ms), [("kernel", 40 * ms, 50 * ms)], host)


def launches():
    return [{"name": "seqalign.launch", "counts": {"cells_real": 900, "cells_launched": 1000}},
            {"name": "seqalign.launch", "counts": {"cells_real": 50, "cells_launched": 1000}},
            {"name": "seqalign.launch", "counts": {"cells_real": 1600, "cells_launched": 2000}}]


@pytest.fixture
def recorded(monkeypatch):
    """Stands the given records in for the program's own."""
    import seqalign_tpu_torch.trace as program_trace

    def use(records):
        monkeypatch.setattr(program_trace, "recorded", lambda: records)
    return use


@pytest.mark.parametrize("suffix", ["", ".single"])
def test_plan_ms_is_the_mean_sort_and_plan_a_search(suffix):
    run = run_of([0.1, 0.2], [0.05, 0.05], [1, 1], tr=two_searches())
    # (3 + 1 + 2 + 1.5) ms in the first search, (4 + 2) ms in the second.
    assert reader(f"plan_ms{suffix}").read(run) == pytest.approx((7.5 + 6.0) / 2)


@pytest.mark.parametrize("suffix", ["", ".single"])
def test_cell_fill_pct_is_real_over_launched_cells(recorded, suffix):
    recorded(launches())
    got = reader(f"cell_fill_pct{suffix}").read(run_of([1.0], [0.5], [1]))
    assert got == pytest.approx(100 * (900 + 50 + 1600) / (1000 + 1000 + 2000))


@pytest.mark.parametrize("name", ["plan_ms", "cell_fill_pct", "plan_ms.single",
                                  "cell_fill_pct.single"])
@pytest.mark.parametrize("program", ["untraced", "no spans"])
def test_readers_find_nothing_without_a_record(recorded, monkeypatch, name, program):
    """An untraced run has no trace and records no span; a program older
    than its spans names no step and has no trace module."""
    recorded([])
    tr = None
    if program == "no spans":
        monkeypatch.setitem(sys.modules, "seqalign_tpu_torch.trace", None)
        tr = trace.Trace((0.0, 1.0), [("kernel", 0.2, 0.4)], [("aten::copy_", 0.1, 0.2)])
    assert reader(name).read(run_of([1.0], [0.5], [1], tr=tr)) is None


@pytest.mark.parametrize("name", ["tiny-single", "tiny-batch"])
def test_a_traced_tiny_cell_reads_them(tmp_path, monkeypatch, name):
    from seqalign_tpu_torch import trace as program_trace

    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")
    root = make_root(tmp_path)
    cell = cells.load_cell(name, root.parent / "BENCHMARK.json", root)
    program_trace.clear()
    line = cells.execute(cell, SEED, 0.3, True, torch.device("cpu"), time.time(),
                         log=lambda msg: None)
    assert line["correct"] is True
    metrics = line["metrics"]
    assert 0 < metrics["plan_ms"]["value"] < 1e3 * line["device"]["window_s"]
    assert 0 < metrics["cell_fill_pct"]["value"] <= 100
    assert metrics["plan_ms.single"] == metrics["plan_ms"]
    program_trace.clear()
    untraced = cells.execute(cell, SEED, 0.3, False, torch.device("cpu"), time.time(),
                             log=lambda msg: None)
    assert not {"plan_ms", "cell_fill_pct"} & set(untraced["metrics"])
    assert not program_trace.recorded()

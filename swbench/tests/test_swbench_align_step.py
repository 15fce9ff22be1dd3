"""The alignment step's readers (``align_ms``, ``align_host_cell_pct``) on
hand-made runs, without the program's spans, against the profiler's own
events and in a traced run of a tiny cell on the CPU; and the control of
the alignment check (``control_align``) on the tiny ``align`` cell."""

import sys
import time

import numpy as np
import pytest
import torch

from swbench import cell as cells, trace
from swbench.tests import control_align
from swbench.tests.tamper import TAMPERS
from swbench.tests.test_swbench_metrics import reader, run_of
from swbench.tests.tiny import make_root

SEED = 2**31 + 11
MS = 1e-3


def two_searches():
    """The host timeline of two searches in a stretch of 10-400 ms. The
    first search's alignment step runs 20-35 ms: its top-k choice, two
    pairs (the second localized), and torch ops between the steps, which
    count; the second's runs 390-410 ms, half of it past the window. The
    search's own steps and other host events are no part of either."""
    host = [
        ("seqalign.sort", 11 * MS, 13 * MS), ("seqalign.wait", 14 * MS, 19 * MS),
        ("seqalign.select", 20 * MS, 21 * MS), ("seqalign.fill", 21 * MS, 24 * MS),
        ("seqalign.walk", 24 * MS, 25 * MS), ("aten::copy_", 25 * MS, 26 * MS),
        ("seqalign.ends", 26 * MS, 30 * MS), ("seqalign.ends", 30 * MS, 31 * MS),
        ("seqalign.fill", 31 * MS, 34 * MS), ("seqalign.walk", 34 * MS, 35 * MS),
        ("aten::empty", 36 * MS, 37 * MS), ("seqalign.sort", 201 * MS, 205 * MS),
        ("seqalign.select", 390 * MS, 391 * MS), ("seqalign.fill", 391 * MS, 409 * MS),
        ("seqalign.walk", 409 * MS, 410 * MS),
    ]
    return trace.Trace((10 * MS, 400 * MS), [("kernel", 40 * MS, 50 * MS)], host)


def counted():
    return [
        {"name": "seqalign.align", "counts": {"hits": 10}},
        {"name": "seqalign.select", "counts": {"records": 500}},
        {"name": "seqalign.launch", "counts": {"cells_real": 7, "cells_launched": 9}},
        {"name": "seqalign.ends", "counts": {"cells_device": 600}},
        {"name": "seqalign.ends", "counts": {"cells_host": 100}},
        {"name": "seqalign.fill", "counts": {"cells_host": 300}},
    ]


@pytest.fixture
def recorded(monkeypatch):
    """Stands the given records in for the program's own."""
    import seqalign_tpu_torch.trace as program_trace

    def use(records):
        monkeypatch.setattr(program_trace, "recorded", lambda: records)
    return use


def test_align_ms_is_the_mean_alignment_step_a_search():
    run = run_of([0.1, 0.2], [0.05, 0.05], [1, 1], tr=two_searches())
    # 20-35 ms in the first search, 390-400 ms of the second's inside the window.
    assert reader("align_ms").read(run) == pytest.approx((15 + 10) / 2)


def test_align_ms_closes_a_step_at_the_next_search():
    host = [("seqalign.select", 0.0, 0.001), ("seqalign.walk", 0.001, 0.002),
            ("seqalign.make_profile", 0.003, 0.004), ("seqalign.walk", 0.005, 0.006),
            ("seqalign.select", 0.007, 0.008)]
    run = run_of([0.01], [0.0], [1], tr=trace.Trace((0.0, 0.01), [], host))
    assert reader("align_ms").read(run) == pytest.approx(2 + 1)


@pytest.mark.parametrize("records,want", [
    (counted(), 100 * 400 / 1000),
    (counted()[4:], 100.0),  # every pair on the host
    (counted()[:4], 0.0),  # the ends on the device, no fill counted
    (counted()[:3], None),  # no alignment step
    ([{"name": "seqalign.fill", "counts": {"cells_host": 0}}], None),
    ([], None),  # an untraced run
])
def test_align_host_cell_pct_is_host_over_all_counted_cells(recorded, records, want):
    recorded(records)
    got = reader("align_host_cell_pct").read(run_of([1.0], [0.5], [1]))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name", ["align_ms", "align_host_cell_pct"])
@pytest.mark.parametrize("program", ["untraced", "no spans"])
def test_readers_find_nothing_without_a_record(recorded, monkeypatch, name, program):
    """An untraced run has no trace and records no span; a program older
    than the alignment step's spans names no step and counts no cell."""
    recorded([])
    tr = None
    if program == "no spans":
        recorded([{"name": "seqalign.launch", "counts": {"cells_real": 1, "cells_launched": 1}}])
        tr = trace.Trace((0.0, 1.0), [("kernel", 0.2, 0.4)],
                         [("seqalign.sort", 0.1, 0.2), ("aten::copy_", 0.5, 0.6)])
    assert reader(name).read(run_of([1.0], [0.5], [1], tr=tr)) is None


def test_align_host_cell_pct_without_the_trace_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "seqalign_tpu_torch.trace", None)
    assert reader("align_host_cell_pct").read(run_of([1.0], [0.5], [1])) is None


def test_align_ms_spans_equal_the_profilers_own(monkeypatch):
    """Each step ``align_ms`` reads from the innermost events is the
    program's ``seqalign.align`` event, to within 0.2 ms, on the host
    path and on the engine's."""
    from torch.profiler import ProfilerActivity, profile

    from seqalign_tpu_torch.host import EncodedDatabase
    from seqalign_tpu_torch.ops import traceback

    from swbench.tests.test_swbench_alignments import CASES, searched, table_of

    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")
    names = ("long-host-ends", "long-wavefront-ends", "pam250")
    cases = [searched(name)[:3] for name in names]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.SEARCH_SPAN):
            for name, (query, db, scores) in zip(names, cases):
                db = EncodedDatabase(seq=db.seq, offsets=db.offsets, names=[""] * len(scores))
                traceback.topk_alignments(query.astype(np.int32), db, scores, 5, table_of(name),
                                          *CASES[name][1:3], device=torch.device("cpu"))
    own = sorted((ev.start_ns() / 1e9, ev.end_ns() / 1e9)
                 for ev in prof.profiler.kineto_results.events()
                 if ev.name() == "seqalign.align")
    steps = reader("align_ms").steps(trace.from_profiler(prof).host)
    assert len(steps) == len(own) == 3
    for (s, e), (a, b) in zip(steps, own):
        assert a <= s and e <= b and (s - a) + (b - e) < 0.2e-3


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")
    root = make_root(tmp_path)
    return cells.load_cell("tiny-align", root.parent / "BENCHMARK.json", root)


def test_a_traced_tiny_align_cell_reads_them(tiny):
    from seqalign_tpu_torch import trace as program_trace

    program_trace.clear()
    line = cells.execute(tiny, SEED, 0.3, True, torch.device("cpu"), time.time(),
                         log=lambda msg: None)
    assert line["correct"] is True
    metrics = line["metrics"]
    assert 0 < metrics["align_ms"]["value"] < 1e3 * line["device"]["window_s"]
    assert metrics["align_host_cell_pct"]["value"] == 100  # PAM250: '*' against '*' is +1
    program_trace.clear()
    untraced = cells.execute(tiny, SEED, 0.3, False, torch.device("cpu"), time.time(),
                             log=lambda msg: None)
    assert not {"align_ms", "align_host_cell_pct"} & set(untraced["metrics"])
    assert not program_trace.recorded()


def test_control_align_catches_every_tamper(tiny):
    lines = {r["variant"]: r for r in control_align.readings(tiny, SEED, 24, torch.device("cpu"))}
    assert set(lines) == ({"program", "banded32", "argpartition"}
                          | {t.__name__ for t in TAMPERS})
    program = lines.pop("program")
    assert program["mismatches"] == 0 and program["scores_compared"] > 0
    assert program["alignment_mismatches"] == 0
    assert program["alignments_compared"] == 3 * program["searches"]
    for name in (t.__name__ for t in TAMPERS):
        assert lines[name]["planted"] > 0, name
        assert lines[name]["alignment_mismatches"] >= lines[name]["planted"], name


@pytest.mark.parametrize("width,caught", [(200, False), (1, True)])
def test_banded_hits_follow_the_programs_recurrence(tiny, monkeypatch, width, caught):
    """A band wider than every pair gives the program's own hits; a band of
    half-width 1 loses the gapped ones' scores."""
    monkeypatch.setattr(control_align, "BAND", width)
    monkeypatch.setattr(control_align, "banded_hit", lambda *a, _f=control_align.banded_hit:
                        _f(*a, width=width))
    lines = {r["variant"]: r for r in control_align.readings(tiny, SEED, 24, torch.device("cpu"))}
    band = lines[f"banded{width}"]
    assert (band["planted"] > 0) == caught
    assert (band["alignment_mismatches"] > 0) == caught


def _json(path):
    import json

    return json.loads((cells.SWBENCH / path).read_text())


@pytest.mark.parametrize("key", ["assumed", "scoring", "database"])
def test_align_config_is_swissprot_blosum62s(key):
    """The search under the alignments is ``swissprot-blosum62``'s."""
    assert (_json("configs/swissprot-blosum62-align.json")[key]
            == _json("configs/swissprot-blosum62.json")[key])


def test_align10_sends_cudasw20s_requests():
    """``k`` is stated once, in the cell's params; the rest are cudasw20's."""
    align = _json("workloads/blosum62-align10.json")["params"]
    assert align.pop("k") == 10
    assert align == _json("workloads/blosum62-cudasw20.json")["params"]

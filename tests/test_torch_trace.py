"""The search's spans (``seqalign_tpu_torch.trace``) under ``torch.profiler``,
on a database of a few hundred records: one root span a search with every
step inside it, the launches' cell counts against the plans and the
kernels' teams, the plan span's memo hits and misses, and the kernel timer
against the spans it covers.

The file imports neither JAX nor the JAX package, so that its card case runs
on a machine without them:
``python -m pytest tests/test_torch_trace.py -m cuda --noconftest``.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from seqalign_tpu_torch import pipeline, trace
from seqalign_tpu_torch.host import ScoringModel, encode, load_builtin
from seqalign_tpu_torch.ops import swa_cuda

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"
SEARCH = "seqalign.search"
# The steps of every stream search on the CPU (a card's pack also stages).
STEPS = {SEARCH, "seqalign.make_profile", "seqalign.sort", "seqalign.profile", "seqalign.plan",
         "seqalign.h2d", "seqalign.pack", "seqalign.wait", "seqalign.launch",
         "seqalign.reorder", "seqalign.fetch"}
# The host-only steps: they hold no other event, so the device trace's idle
# time falls to them by name, and swbench's plan_ms reads sort and plan.
LEAVES = ("seqalign.make_profile", "seqalign.sort", "seqalign.plan", "seqalign.copy_out")
# Query lengths of each search, and the query rows its launches step on a
# card: K1 its team's 1 x 32 rows; K3 the block's three queries at the
# longest one's team; K2 six stripes (five of 8 rows, the last 2 padded to
# 4), each a warp of 32 x 8 rows. STRIPED cases run with MAX_QUERY_ROWS = 16
# and stripes of 8 rows.
CASES = {
    "single": ([30], 32),
    "multi": ([30, 20, 7], 3 * 32),
    "striped": ([42], 6 * 32 * 8),
}
STRIPE = 8


@pytest.fixture
def scoring():
    return load_builtin("BLOSUM62", ScoringModel(gap_open=-11, gap_extend=-1,
                                                 use_match_mismatch=False))


def protein(rng, n):
    return encode("".join(AMINO_ACIDS[i] for i in rng.integers(0, 20, n)))


def database(rng, n=300):
    return pipeline._db_from_encoded([protein(rng, int(k)) for k in rng.integers(1, 80, n)])


def shrink(monkeypatch, name):
    if name == "striped":
        monkeypatch.setattr(swa_cuda, "MAX_QUERY_ROWS", 16)
        monkeypatch.setattr(swa_cuda, "STRIPE_ROWS", STRIPE)


def search(queries, db, scoring, device="cpu"):
    if len(queries) == 1:
        return pipeline.search_database(queries[0], db, scoring, device=device)
    return pipeline.search_database_multi(queries, db, scoring, device=device)


def traced(fn, device="cpu"):
    """``(fn(), its spans, its counted spans, every host event, the
    profiler)`` of ``fn`` run under a profiler session. The spans and host
    events are ``(name, start_ns, end_ns, thread)`` in the order they
    start, the longer first."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    trace.clear()
    with profile(activities=acts) as prof:
        out = fn()
    host = sorted(((ev.name(), ev.start_ns(), ev.end_ns(), ev.start_thread_id())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.device_type() != torch.autograd.DeviceType.CUDA),
                  key=lambda ev: (ev[1], -ev[2]))
    spans = [ev for ev in host if ev[0].startswith(trace.PREFIX)]
    return out, spans, list(trace.recorded()), host, prof


def inside(ev, outer):
    return outer[3] == ev[3] and outer[1] <= ev[1] and ev[2] <= outer[2]


def launches(records):
    return [r for r in records if r["name"] == "seqalign.launch"]


def plan_record(hits, misses):
    return {"name": "seqalign.plan", "counts": {"plan_hits": hits, "plan_misses": misses}}


def plans_made(monkeypatch):
    """The plans the search makes, as ``pipeline.plan_chunk`` returns them,
    from a memo of its own that holds none yet."""
    monkeypatch.setattr(pipeline, "PLANS", pipeline.PlanMemo())
    plans, plan_chunk = [], pipeline.plan_chunk

    def spy(*args, **kwargs):
        plans.append(plan_chunk(*args, **kwargs))
        return plans[-1]

    monkeypatch.setattr(pipeline, "plan_chunk", spy)
    return plans


def timed_seconds(spans):
    """The summed spans the kernel timer covers: every launch, reorder and
    fetch, and every wait but the one before a chunk's launches (the copy
    and the pack landing), which lies outside the timer."""
    steps = [ev for ev in spans if ev[0] in ("seqalign.launch", "seqalign.reorder",
                                             "seqalign.fetch", "seqalign.wait")]
    ns = 0
    for ev, nxt in zip(steps, steps[1:] + [None]):
        if ev[0] != "seqalign.wait" or nxt is None or nxt[0] != "seqalign.launch":
            ns += ev[2] - ev[1]
    return ns / 1e9


@pytest.mark.parametrize("name", list(CASES))
def test_one_root_a_search_and_every_span_inside_it(name, scoring, monkeypatch):
    shrink(monkeypatch, name)
    rng = np.random.default_rng(41)
    lengths, _ = CASES[name]
    queries = [protein(rng, n) for n in lengths]
    db = database(rng)
    (scores, kernel_s), spans, _, host, _ = traced(lambda: search(queries, db, scoring))
    want, _ = search(queries, db, scoring)
    np.testing.assert_array_equal(scores, want)

    roots = [ev for ev in spans if not any(inside(ev, o) for o in spans if o is not ev)]
    assert [ev[0] for ev in roots] == [SEARCH]
    assert all(inside(ev, roots[0]) for ev in spans)
    assert {ev[0] for ev in spans} == STEPS | ({"seqalign.copy_out"} if len(queries) > 1
                                               else set())
    for leaf in (ev for ev in spans if ev[0] in LEAVES):
        assert not [ev for ev in host if ev is not leaf and inside(ev, leaf)], leaf
    assert timed_seconds(spans) == pytest.approx(kernel_s, abs=1e-3)


@pytest.mark.parametrize("name,chunk_residues", [("single", None), ("multi", None),
                                                 ("striped", None), ("striped", 2000)])
def test_launch_counters_match_the_wrappers_and_the_plans(name, chunk_residues, scoring,
                                                          monkeypatch):
    """Each ``seqalign.launch`` span counts ``cells_real``, the query
    residues times its chunk's database residues, and ``cells_launched``,
    the query rows the kernel wrappers' launches step on a card (their
    teams' padding included) times the chunk plan's padded cells a row."""
    shrink(monkeypatch, name)
    if chunk_residues:
        monkeypatch.setattr(pipeline, "STRIPED_SCRATCH_BYTES", 2 * chunk_residues * 16)
    plans = plans_made(monkeypatch)
    rng = np.random.default_rng(43)
    lengths, rows = CASES[name]
    queries = [protein(rng, n) for n in lengths]
    db = database(rng, 1500 if chunk_residues else 300)
    _, spans, records, _, _ = traced(lambda: search(queries, db, scoring))
    records = launches(records)
    assert len(records) == len(plans) == sum(ev[0] == "seqalign.launch" for ev in spans)
    assert (len(plans) > 2) == bool(chunk_residues)
    for r, plan in zip(records, plans):
        assert r["name"] == "seqalign.launch"
        assert r["counts"] == {
            "cells_real": sum(lengths) * int(db.lengths[plan.order].sum()),
            "cells_launched": rows * plan.padded_cells_per_query_row}
    assert sum(r["counts"]["cells_real"] for r in records) == sum(lengths) * int(db.offsets[-1])


@pytest.mark.parametrize("rows,nq,stepped", [
    (30, 1, 32),  # 1 x 32, no solo instance at R = 32
    (144, 1, 144),  # q144: 4 x 36, no padding
    (189, 1, 192),  # 4 x 48
    (375, 1, 384),  # 8 x 48
    (160, 64, 64 * 160),  # family64's batch: 4 x 40 a query
    (10, 3, 4 * 10),  # solo R = 10, Q = 2: a fourth query of zeros
    (17, 9, 12 * 18),  # solo R = 18, Q = 4: three queries of zeros
    (1536, 1, 1536),  # MAX_QUERY_ROWS: 32 x 48
])
def test_a_one_pass_launch_steps_its_teams_rows(rows, nq, stepped):
    assert swa_cuda.stream_rows_stepped(rows, nq) == stepped


@pytest.mark.parametrize("rows,stepped", [(1024, 1024), (976, 1024), (257, 512), (4, 256)])
def test_a_stripe_steps_its_warps_rows(rows, stepped):
    assert swa_cuda.stripe_rows_stepped(rows) == stepped


def test_a_search_inside_another_is_its_child(scoring, monkeypatch):
    """A batch's query over MAX_QUERY_ROWS is searched on its own inside the
    batch's search: a ``seqalign.search`` inside the root, not a second
    root."""
    shrink(monkeypatch, "striped")
    plans = plans_made(monkeypatch)
    rng = np.random.default_rng(47)
    queries = [protein(rng, 10), protein(rng, 42)]
    db = database(rng)
    (_, kernel_s), spans, records, _, _ = traced(lambda: search(queries, db, scoring))
    root, inner = [ev for ev in spans if ev[0] == SEARCH]
    assert inside(inner, root) and all(inside(ev, root) for ev in spans)
    # The batch's K3 launch (one query of 10 rows, solo at R = 10, Q = 1),
    # then the long query's six K2 stripes.
    assert [r["counts"] for r in launches(records)] == [
        {"cells_real": n * int(db.offsets[-1]), "cells_launched": rows * p.padded_cells_per_query_row}
        for n, rows, p in zip((10, 42), (10, 6 * 32 * 8), plans)]
    assert timed_seconds(spans) == pytest.approx(kernel_s, abs=1e-3)


def test_outside_a_profiler_nothing_is_recorded(scoring):
    rng = np.random.default_rng(53)
    db = database(rng, 50)
    assert trace.span("search") is trace.span("launch", cells_real=1, cells_launched=2)
    with trace.span("plan"):
        pass
    before = list(trace.recorded())
    pipeline.search_database(protein(rng, 12), db, scoring, device="cpu")
    assert trace.recorded() == before


def test_a_new_session_starts_a_new_record(scoring):
    """``clear()`` starts the record anew; a search outside the profiler
    adds nothing to it, and every profiled search adds its plan span (its
    one chunk planned now the first time, from the memo after) and its
    launches."""
    rng = np.random.default_rng(59)
    db = database(rng, 50)
    q = protein(rng, 12)
    _, _, first, _, _ = traced(lambda: pipeline.search_database(q, db, scoring, device="cpu"))
    launch = launches(first)
    assert len(launch) == 1
    assert first == [plan_record(0, 1)] + launch
    pipeline.search_database(q, db, scoring, device="cpu")
    assert trace.recorded() == first
    with profile(activities=[ProfilerActivity.CPU]):
        pipeline.search_database(q, db, scoring, device="cpu")
    again = [plan_record(1, 0)] + launch
    assert trace.recorded() == first + again
    _, _, second, _, _ = traced(lambda: [pipeline.search_database(q, db, scoring, device="cpu")
                                         for _ in range(2)])
    assert second == again * 2


@pytest.mark.parametrize("name,chunk_residues", [("single", None), ("multi", None),
                                                 ("striped", None), ("striped", 2000)])
def test_the_plan_span_counts_the_memos_hits_and_misses(name, chunk_residues, scoring,
                                                        monkeypatch):
    """Each traced search's ``seqalign.plan`` record counts its chunks:
    every one planned now on the first search of a database, every one from
    the memo after, for a batch and for a long query alike."""
    shrink(monkeypatch, name)
    if chunk_residues:
        monkeypatch.setattr(pipeline, "STRIPED_SCRATCH_BYTES", 2 * chunk_residues * 16)
    plans = plans_made(monkeypatch)
    rng = np.random.default_rng(67)
    lengths, _ = CASES[name]
    queries = [protein(rng, n) for n in lengths]
    db = database(rng, 1500 if chunk_residues else 300)
    (want, _), _, first, _, _ = traced(lambda: search(queries, db, scoring))
    chunks = len(plans)
    assert (chunks > 2) == bool(chunk_residues)
    (got, _), _, later, _, _ = traced(lambda: [search(queries, db, scoring) for _ in range(2)][-1])
    assert len(plans) == chunks
    np.testing.assert_array_equal(got, want)
    assert [r for r in first if r["name"] == "seqalign.plan"] == [plan_record(0, chunks)]
    assert [r for r in later if r["name"] == "seqalign.plan"] == [plan_record(chunks, 0)] * 2


def test_a_span_on_another_thread_records_its_counters():
    """Counters given on another thread than the profiler's join the same
    record, in the order the spans opened."""
    opened, done = threading.Event(), threading.Event()

    def other():
        opened.wait(5)
        with trace.span("launch", cells_real=1, cells_launched=2):
            pass
        done.set()

    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        worker = threading.Thread(target=other)
        worker.start()
        with trace.span("launch", cells_real=3, cells_launched=4):
            opened.set()
            assert done.wait(5)
        worker.join(5)
    assert not worker.is_alive()
    assert [r["counts"] for r in trace.recorded()] == [
        {"cells_real": 3, "cells_launched": 4}, {"cells_real": 1, "cells_launched": 2}]


# The card's timestamps reach the profiler's clock through CUPTI's
# conversion, which is off by up to some tenths of a millisecond: on an H100
# a kernel read 0.13 ms before the launch span that issued it began, and a
# copy 0.02 ms after the host call that waited for it ended.
CLOCK_SKEW_NS = 500_000


@pytest.mark.cuda
def test_spans_hold_the_device_work_on_the_card(scoring, monkeypatch):
    """On a card, the spans hold the device work they name. On the host's
    clock: the Smith-Waterman kernel's launch call lies inside the launch
    span, a synchronize call inside each wait span and the fetch copy's call
    inside the fetch span. On the device's, to within the clocks' skew: the
    kernel starts after its launch span starts and ends before the last wait
    ends, and the copy ends before the fetch span ends. The launch counts
    q144's 4 x 36 rows, none padded."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")
    rng = np.random.default_rng(61)
    db = database(rng, 3000)
    q = protein(rng, 144)
    search([q], db, scoring, device="cuda")  # builds and loads the kernels
    want, _ = search([q], db, scoring, device="cpu")
    k1 = swa_cuda.sw_stream.launches
    plans = plans_made(monkeypatch)
    (scores, _), spans, records, _, prof = traced(lambda: search([q], db, scoring,
                                                                 device="cuda"), "cuda")
    np.testing.assert_array_equal(scores, want)
    records = launches(records)
    assert swa_cuda.sw_stream.launches - k1 == len(records) == 1
    (plan,) = plans
    assert records[0]["counts"] == {"cells_real": 144 * int(db.offsets[-1]),
                                    "cells_launched": 144 * plan.padded_cells_per_query_row}
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    calls = {ev.correlation_id(): (ev.start_ns(), ev.end_ns()) for ev in events
             if ev.device_type() != cuda and ev.name().startswith("cu")}
    syncs = [(None, ev.start_ns(), ev.end_ns()) for ev in events
             if ev.device_type() != cuda and ev.name().startswith("cu")
             and "Synchronize" in ev.name()]
    device = [(ev.name(), ev.start_ns(), ev.end_ns(), ev.correlation_id()) for ev in events
              if ev.device_type() == cuda and not ev.is_user_annotation()]
    kernels = [d for d in device if "sw_stream" in d[0]]
    copy = max((d for d in device if "DtoH" in d[0]), key=lambda d: d[2])
    (launch,) = [ev for ev in spans if ev[0] == "seqalign.launch"]
    (fetch,) = [ev for ev in spans if ev[0] == "seqalign.fetch"]
    waits = [ev for ev in spans if ev[0] == "seqalign.wait"]
    last_wait = max(ev[2] for ev in waits)

    def issued_in(d, span):
        start, end = calls[d[3]]
        return span[1] <= start and end <= span[2]

    assert kernels and all(issued_in(k, launch) for k in kernels)
    assert issued_in(copy, fetch)
    assert all(any(w[1] <= c[1] and c[2] <= w[2] for c in syncs) for w in waits)
    assert min(k[1] for k in kernels) > launch[1] - CLOCK_SKEW_NS
    assert max(k[2] for k in kernels) < last_wait + CLOCK_SKEW_NS
    assert copy[2] < fetch[2] + CLOCK_SKEW_NS

"""The metrics' arithmetic on synthetic timings and traces."""

import statistics

import numpy as np
import pytest

from swbench import peaks, trace
from swbench.cell import Run, Search, load_module
from swbench.stats import percentile, spread
from swbench.tests.tiny import SWBENCH


def reader(name):
    return load_module(SWBENCH / "metrics" / f"{name}.py")


def run_of(walls, kernels, cells, window_s=None, tr=None, sms=132, clock=1.98e9, ok=None):
    t, searches = 0.0, []
    for k, (w, ks, c) in enumerate(zip(walls, kernels, cells)):
        searches.append(Search(t, t + w, ks, c, True if ok is None else ok[k]))
        t += w
    return Run(setup_s=12.5, window_s=window_s or t, searches=searches, trace=tr, sms=sms,
               sm_clock_hz=clock)


def test_gcups_counts_finished_searches_over_the_window():
    run = run_of([0.5, 0.25, 0.25], [0.1] * 3, [10**9, 2 * 10**9, 10**9],
                 ok=[True, True, False])
    assert reader("gcups").read(run) == pytest.approx(3.0)  # 3e9 cells in 1 s


def test_p95_interpolates_every_search():
    walls = [i / 1000 for i in range(1, 101)]
    run = run_of(walls, [0] * 100, [1] * 100)
    assert reader("search_p95_ms").read(run) == pytest.approx(np.percentile(np.arange(1, 101), 95))


def test_percentile_and_spread():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0, 9.0]
    for q in (0, 25, 50, 95, 100):
        assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert spread(xs) == pytest.approx((q3 - q1) / statistics.median(xs))


def test_host_ms_is_the_wall_less_the_kernel_timer():
    run = run_of([0.040, 0.060], [0.010, 0.020], [1, 1])
    assert reader("host_ms").read(run) == pytest.approx(35.0)


def synthetic_trace():
    # Stretch 0..10 s; kernels 1-3 and 2-4 overlap (busy 1-4), a copy 6-7.
    return trace.Trace(
        stretch=(0.0, 10.0),
        device=[("void (anonymous namespace)::sw_stream_kernel<36, false>(int const*)", 1.0, 3.0),
                ("void (anonymous namespace)::sw_stream_striped_kernel<32, true, true, false>"
                 "(int const*)", 2.0, 4.0),
                ("Memcpy HtoD (Pinned -> Device)", 6.0, 7.0),
                ("void (anonymous namespace)::stream_pack_kernel<true>()", 9.5, 11.0)],
        host=[("aten::copy_", 4.5, 5.0), ("cudaMemcpyAsync", 7.5, 8.0)])


def test_idle_share_is_one_less_the_union_over_the_stretch():
    run = run_of([5.0, 5.0], [0, 0], [1, 1], tr=synthetic_trace())
    # Busy: 1-4, 6-7 and 9.5-10 (clipped): 4.5 s of 10.
    assert reader("device_idle_pct").read(run) == pytest.approx(55.0)
    assert trace.window_seconds(run.trace) == 10.0


def test_idle_gaps_by_host_op():
    gaps = dict(trace.idle_by_host(synthetic_trace()))
    assert gaps["aten::copy_"] == pytest.approx(0.5)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(0.5)
    assert gaps[trace.NO_OP] == pytest.approx(5.5 - 1.0)


def test_h2d_per_search():
    run = run_of([5.0, 5.0], [0, 0], [1, 1], tr=synthetic_trace())
    assert reader("h2d_ms").read(run) == pytest.approx(500.0)


def test_roofline_counts_three_operations_a_cell_over_the_dpx_peak():
    cells = 10**12
    run = run_of([5.0, 5.0], [0, 0], [cells // 2, cells // 2], tr=synthetic_trace())
    peak = 2 * 132 * 64 * 1.98e9  # 33.45 T cell-operations/s
    assert peaks.cell_ops_per_s(132, 1.98e9) == pytest.approx(peak)
    # The sw_ kernels ran 2 + 2 s (the pack is not one of them).
    assert reader("sw_roofline").read(run) == pytest.approx(100 * 3 * cells / peak / 4.0)


def test_readers_find_nothing_without_a_trace():
    run = run_of([1.0], [0.5], [1])
    for name in ("h2d_ms", "sw_roofline", "device_idle_pct"):
        assert reader(name).read(run) is None


def test_innermost_host_ops():
    evs = [("outer", 0.0, 10.0), ("inner", 1.0, 2.0), ("leaf", 1.2, 1.5), ("next", 3.0, 4.0)]
    assert trace.innermost(evs) == [("leaf", 1.2, 1.5), ("next", 3.0, 4.0)]


@pytest.mark.parametrize("name, single", [("gcups", "window_gcups.single"),
                                          ("host_ms", "host_ms.single"),
                                          ("h2d_ms", "h2d_ms.single"),
                                          ("sw_roofline", "sw_roofline.single"),
                                          ("device_idle_pct", "device_idle_pct.single")])
def test_single_cell_readers_read_as_their_originals(name, single):
    run = run_of([5.0, 5.0], [1.0, 2.0], [10**12 // 2] * 2, tr=synthetic_trace())
    assert reader(single).read(run) == reader(name).read(run) is not None


def test_device_peak_is_the_allocators_peak_in_gib():
    run = run_of([1.0], [0.5], [1])
    run.memory_peak_bytes = 439_502_848
    assert reader("device_peak_gib").read(run) == pytest.approx(439_502_848 / 2**30)


@pytest.mark.parametrize("peak", [None, 0])
def test_device_peak_reads_nothing_without_a_card(peak):
    run = run_of([1.0], [0.5], [1])
    run.memory_peak_bytes = peak
    assert reader("device_peak_gib").read(run) is None

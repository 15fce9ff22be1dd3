"""The Smith-Waterman kernels' share of their roofline, in %: the bound of
the traced window's real cells (``swbench.peaks``: 3 max-plus operations a
cell over 2 x SMs x 64 DPX lanes x the maximum SM clock) over the device
time of every kernel whose name begins ``sw_``."""

import re

from swbench.peaks import ops_bound_s
from swbench.trace import device_seconds


def _is_sw(name: str) -> bool:
    """Whether a device event is a kernel whose own name begins ``sw_``:
    ``void (anonymous namespace)::sw_stream_kernel<36, false>(...)`` as the
    profiler names the port's kernels, without its namespaces."""
    name = re.sub(r"^(\(anonymous namespace\)::|\w+::)+", "", name.removeprefix("void "))
    return name.startswith("sw_")


def read(run):
    if run.trace is None or not run.sms or not run.sm_clock_hz:
        return None
    kernel_s = device_seconds(run.trace, _is_sw)
    cells = sum(s.cells for s in run.searches if s.ok)
    if not kernel_s or not cells:
        return None
    return 100 * ops_bound_s(cells, run.sms, run.sm_clock_hz) / kernel_s

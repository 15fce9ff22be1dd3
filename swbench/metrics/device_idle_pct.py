"""The device's idle share of the traced window, in %: 100 x (1 - the
union of every device event's interval over the stretch from the first
search's start to the last one's end)."""

from swbench.trace import busy_seconds, window_seconds


def read(run):
    if run.trace is None or not busy_seconds(run.trace):
        return None
    return 100 * (1 - busy_seconds(run.trace) / window_seconds(run.trace))

"""The 95th percentile of every search's time in the window, on the host
clock, from the call to the scores on the host in database order."""

from swbench.stats import percentile


def read(run):
    if not run.searches:
        return None
    return percentile([(s.end - s.start) * 1e3 for s in run.searches], 95)

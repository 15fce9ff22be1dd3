"""Host-to-device copies' device time (profiler "Memcpy HtoD" events) per
search in the traced window, in ms: the database's copy and the pack's
inputs."""

from swbench.trace import device_seconds


def read(run):
    if run.trace is None or not run.searches:
        return None
    seconds = device_seconds(run.trace, lambda name: "Memcpy HtoD" in name)
    return seconds / len(run.searches) * 1e3 if seconds else None

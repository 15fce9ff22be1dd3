"""The most card memory the program held at once, from the set-up through
the window (the card allocator's peak, read before the reference runs),
in GiB: what a deployment leaves of the card for anything beside it. None
where the run had no card."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2**30

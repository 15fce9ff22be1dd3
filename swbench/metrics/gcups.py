"""Real cells of every search finished in the window (query residues x the
database's residues, no padding), over the window's seconds on the host
clock, in billions a second. The window closes when the search in flight
at ``--seconds`` ends; its work and its time both count."""


def read(run):
    if not run.window_s or not any(s.ok for s in run.searches):
        return None
    return sum(s.cells for s in run.searches if s.ok) / run.window_s / 1e9

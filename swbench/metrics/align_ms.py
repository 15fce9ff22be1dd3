"""The alignment step after each search, per search: the summed durations
of the program's ``seqalign.align`` spans (``ops.traceback.topk_alignments``:
the top-k choice, then the ends, fills and walks of the hits) on the traced
window's host timeline, clipped to the window, over the window's searches,
in ms. None where the program named no such step (an untraced run, or a
program without the spans).

The trace keeps only the innermost host events (``swbench.trace``), and a
``seqalign.align`` span holds its steps, so each one is read from them: it
runs from the start of its first step, ``seqalign.select``, to the end of
the last ``seqalign.ends``, ``seqalign.fill`` or ``seqalign.walk`` before
any other ``seqalign.*`` step (the next search's). The span opens just
before its first step and closes just after its last."""

from swbench import trace as tracing

FIRST = "seqalign.select"
STEPS = (FIRST, "seqalign.ends", "seqalign.fill", "seqalign.walk")


def steps(host):
    """``(start, end)`` of each alignment step that ``host``'s innermost
    events show, in order."""
    out, open_ = [], None
    for name, s, e in sorted(host, key=lambda ev: ev[1]):
        if name == FIRST:
            if open_:
                out.append(tuple(open_))
            open_ = [s, e]
        elif open_ and name in STEPS:
            open_[1] = max(open_[1], e)
        elif open_ and name.startswith("seqalign."):
            out.append(tuple(open_))
            open_ = None
    if open_:
        out.append(tuple(open_))
    return out


def read(run):
    if run.trace is None or not run.searches:
        return None
    found = tracing.clip([("align", s, e) for s, e in steps(run.trace.host)], run.trace.stretch)
    if not found:
        return None
    return 1e3 * sum(e - s for _, s, e in found) / len(run.searches)

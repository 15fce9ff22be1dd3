"""The pipeline's sort and plan, per search: the summed durations of the
program's ``seqalign.sort`` and ``seqalign.plan`` events (the records'
length sort, and its chunks' bounds and stream plans) on the traced
window's host timeline, over the window's searches, in ms. Both steps run
no torch op, so each is an innermost host event of the trace. None where
the program named no such step (an untraced run, or a program without the
spans)."""

from swbench import trace as tracing

STEPS = ("seqalign.sort", "seqalign.plan")


def read(run):
    if run.trace is None or not run.searches:
        return None
    steps = [(s, e) for name, s, e in tracing.clip(run.trace.host, run.trace.stretch)
             if name in STEPS]
    if not steps:
        return None
    return 1e3 * sum(e - s for s, e in steps) / len(run.searches)

"""The share of the chunks whose stream plan the program took from its plan
memo, in %: 100 x the sum of ``plan_hits`` over the sum of ``plan_hits`` and
``plan_misses`` (chunks planned in the search) of every ``seqalign.plan``
span the program counted while the window was traced
(``seqalign_tpu_torch.trace.recorded()``). None where it counted none: an
untraced run, or a program without the memo's counters."""


def read(run):
    try:
        from seqalign_tpu_torch.trace import recorded
    except ImportError:
        return None
    plans = [r["counts"] for r in recorded() if r["name"] == "seqalign.plan"]
    hits = sum(c.get("plan_hits", 0) for c in plans)
    chunks = hits + sum(c.get("plan_misses", 0) for c in plans)
    if not chunks:
        return None
    return 100 * hits / chunks

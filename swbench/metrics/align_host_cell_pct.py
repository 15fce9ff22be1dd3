"""The share of the alignment step's dynamic-programming cells that the
host computed, in %: 100 x the sum of ``cells_host`` over the sum of
``cells_host`` and ``cells_device`` of every ``seqalign.ends`` (each
localization of the hits' ends: a host pass over a pair, or the engine's
pass on the device over all the long pairs at once) and ``seqalign.fill``
(each traceback-state fill, on the host) span the program counted while the
window was traced (``seqalign_tpu_torch.trace.recorded()``). None where it
counted none: an untraced run, or a program without the counters."""

STEPS = ("seqalign.ends", "seqalign.fill")


def read(run):
    try:
        from seqalign_tpu_torch.trace import recorded
    except ImportError:
        return None
    counts = [r["counts"] for r in recorded() if r["name"] in STEPS]
    host = sum(c.get("cells_host", 0) for c in counts)
    cells = host + sum(c.get("cells_device", 0) for c in counts)
    if not cells:
        return None
    return 100 * host / cells

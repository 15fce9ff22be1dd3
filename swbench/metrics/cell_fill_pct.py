"""The share of the cells the Smith-Waterman kernels stepped that were real,
in %: 100 x the sum of ``cells_real`` (query residues x the chunk's database
residues, the cells ``gcups`` counts) over the sum of ``cells_launched`` (the
query rows each launch steps on the card, its teams' padding, a batch's
queries padded to its longest and K2's warps included, x the chunk plan's
streams x positions x lanes) of every ``seqalign.launch`` span the program
counted while the window was traced (``seqalign_tpu_torch.trace.
recorded()``). None where it counted none: an untraced run, or a program
without the counters."""


def read(run):
    try:
        from seqalign_tpu_torch.trace import recorded
    except ImportError:
        return None
    launches = [r["counts"] for r in recorded() if r["name"] == "seqalign.launch"]
    launched = sum(c.get("cells_launched", 0) for c in launches)
    if not launched:
        return None
    return 100 * sum(c.get("cells_real", 0) for c in launches) / launched

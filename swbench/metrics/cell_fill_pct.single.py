"""``cell_fill_pct`` in the single-query cell, where it moves
``gcups.single``: the reading of ``metrics/cell_fill_pct.py``."""

from swbench.metrics.cell_fill_pct import read  # noqa: F401

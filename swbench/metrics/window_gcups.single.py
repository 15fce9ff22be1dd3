"""``gcups`` in the single-query cell, read in its traced runs: the
reading of ``metrics/gcups.py``. The host's own speed spreads that cell's
rate by 13-31% from run to run, more than any end-to-end bound may hold,
so it is a per-layer metric there."""

from swbench.metrics.gcups import read  # noqa: F401
